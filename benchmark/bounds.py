"""The card's peaks and the work Darwin's tile DP needs, copied with their
derivation from ``chip_smoke.py`` (``PEAK_INT32_OPS_S``, ``DP_OPS_*``,
``dp_ops_per_cell``), so that the yardstick stays put when the program's
copy moves.

The peak: the DP's operations are int32 adds, maxes and compares, which
an H100 issues on the same 128 lanes per SM as fp32 multiply-add, so their
peak is half of the published 67 TFLOP/s fp32: 33.5 T operations a second
(one warp-instruction a clock on each of an SM's four schedulers at 1.98
GHz over 132 SMs).  The card's own op-rate probe sustains 0.97 of it on a
max/add chain.

Operations per cell, counted in the recurrence without moves, addressing
or loop overhead: substitution add and clamp at 0 (2); max of diagonal, E
and E_L (2); H + go and H + goL, shared by the four gap lanes (2); extend
add and max for each of E, E_L, F, F_L (8); H = max(that, F, F_L) (2).
Max-cell mode adds one compare and three selects; the trace word the T
field's 5 compares and 7 selects, 4 compares, 4 selects and 2 ors for the
open bits and 2 adds to join them.
"""

PEAK_INT32_OPS_S = 67e12 / 2
DP_OPS_RECURRENCE = 16
DP_OPS_MAX_CELL = 4
DP_OPS_TRACE = 24

# Darwin's tile shapes at the default params.cfg: first tiles (the filter,
# max-cell, no trace), extension tiles and large tiles (with trace)
FIRST_TILE = 128
TILE = 384
LARGE_TILE = (1984, 960)


def dp_ops_per_cell(start_end: bool, with_trace: bool) -> int:
    return (DP_OPS_RECURRENCE + (0 if start_end else DP_OPS_MAX_CELL)
            + (DP_OPS_TRACE if with_trace else 0))


def needed_dp_ops(counters: dict) -> float:
    """Integer operations the tile DP needs for the tiles that Darwin's
    counter block says the reads took: every filter tile at 128 x 128 in
    max-cell mode, every extension tile that was used (``num_active_tiles``,
    large ones included) at 384 x 384 with trace, the large ones
    (``num_large_tiles``) at 1984 x 960 instead.  Whole tiles: edge tiles
    are smaller, so this overstates their work a little.  Tiles computed
    ahead and thrown away are not work the reads needed."""
    large = counters["num_large_tiles"]
    square = counters["num_active_tiles"] - large
    return (counters["num_filter_tiles"] * FIRST_TILE ** 2
            * dp_ops_per_cell(False, False)
            + square * TILE ** 2 * dp_ops_per_cell(True, True)
            + large * LARGE_TILE[0] * LARGE_TILE[1]
            * dp_ops_per_cell(True, True))
