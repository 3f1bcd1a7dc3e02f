"""Device dispatchers: tile gather from resident code buffers + tile DP
(+ traceback).  Counterpart of ``darwin_tpu/ops/dispatch.py``'s
``gather_tiles`` (``ops/gact.gather_tiles``, part of the ``gact_next``
kernel's twin), ``first_tile_scores``, and its two extension dispatches
as one: ``extend_tiles_async`` takes a chain of K tiles, K = 1 being
darwin_tpu's one-tile ``extend_tiles_async`` and K > 1 its speculative
``extend_tiles_spec_async``.

The genome and the read batch live on the device as 1-byte 5-letter codes;
tiles are gathered by index arithmetic (a reversed tile is a reversed index
range) with int64 indices clamped into the buffer — lanes whose indices
fall outside hold garbage codes that the DP's length masking never reads
(darwin_tpu relies on uint32 wraparound for the same thing; an
out-of-range CUDA index would be a device assert).  Requests go up as one
(4|11, B) int64 transfer; results come back as one packed int32 transfer,
fetched only in ``resolve()``.

darwin_tpu's TPU transport workarounds are not carried over, and the
outputs are identical without them: 128-lane batch padding, compact 4/8-bit
records and the int16 result matrix, chunked >2^31 genome buffers, the
2-bit packed genome, and the sweep spill/rerun wiring (the port's
traceback kernel never spills).
"""

from __future__ import annotations

import numpy as np
import torch

from darwin_tpu_torch.ops import gact
from darwin_tpu_torch.ops.gact import gather_tiles, tile_sizes
from darwin_tpu_torch.ops.gact_cuda import dp_tiles, next_tiles, \
    traceback_tiles
from darwin_tpu_torch.utils.turns import fetch

# Speculative chain depth, darwin_tpu's SPEC_K (darwin_tpu/ops/dispatch.py:
# 337): the default of pipeline.align.run(spec_k=...).  Outputs do not
# depend on it: a level is accepted only while its device-computed request
# equals the host's exact one.
SPEC_K = 12


def _upload(device, *rows):
    """One host->device transfer of the request vectors, as int64 rows."""
    req = torch.from_numpy(np.stack([np.asarray(r, np.int64) for r in rows]))
    return req.to(device)


def first_tile_scores(ref_codes, query_codes, r_start, r_size, q_start,
                      q_size, params, qt: int, rt: int):
    """Filter-stage dispatch: max-cell scores + positions, no traceback.
    Returns device tensors {score, query_max_pos, ref_max_pos} and
    ``packed`` (3, B) int32 holding all three for one fetch."""
    req = _upload(ref_codes.device, r_start, r_size, q_start, q_size)
    B = req.shape[1]
    rev = torch.zeros(B, dtype=torch.bool, device=req.device)
    qtile, rtile = gather_tiles(ref_codes, query_codes, req[0], req[1],
                                req[2], req[3], rev, qt, rt)
    res = dp_tiles(qtile, rtile, req[3].to(torch.int32),
                   req[1].to(torch.int32), rev, params, with_trace=False)
    packed = torch.stack([res["score"], res["query_max_pos"],
                          res["ref_max_pos"]])
    return {"score": packed[0], "query_max_pos": packed[1],
            "ref_max_pos": packed[2], "packed": packed}


def _extend_tile(qtile, rtile, sizes, se, params, max_tb):
    """One level's DP (with trace) and walk, ``sizes`` the level's
    ``tile_sizes``: the (RT, B) records and the five (B,) int32 stats
    q_steps, r_steps, score, query_max_pos, ref_max_pos."""
    res = dp_tiles(qtile, rtile, sizes[0], sizes[1], se, params,
                   with_trace=True)
    rec, q_steps, r_steps = traceback_tiles(res["trace"], sizes[2],
                                            sizes[3], max_tb)
    return rec, (q_steps, r_steps, res["score"], res["query_max_pos"],
                 res["ref_max_pos"])


def _stats_dict(rows):
    return {"q_steps": rows[0], "r_steps": rows[1], "score": rows[2],
            "query_max_pos": rows[3], "ref_max_pos": rows[4]}


class SpecLevels:
    """Levels 2..K of a speculative dispatch's records, expanded into op
    arrays only for the lanes asked for: the extension manager decodes a
    level only for the lanes whose chain reached it and was accepted.
    ``take(j, all B lanes)`` is darwin_tpu's ``(ops_spec[j],
    n_ops_spec[j])``, j = 0..K-2."""

    def __init__(self, recs, L):
        self._recs = recs          # (K - 1, RT, B) int32
        self._L = L

    def take(self, j, lanes):
        """(ops (len(lanes), L) uint8, n_ops) of level j's ``lanes``."""
        lanes = np.asarray(lanes, np.int64)
        return gact.expand_records(self._recs[j][:, lanes], len(lanes),
                                   self._L)


def extend_tiles_async(ref_codes, query_codes, r_start, r_size, q_start,
                       q_size, rev, chrom_start, chrom_len, q_buf_start,
                       q_len, params, qt: int, rt: int, max_tb: int,
                       stop_thr: int, K: int):
    """Extension dispatch: a chain of K tiles per lane, split into enqueue +
    resolve (darwin_tpu/ops/dispatch.py:478-578, :629-698).  Tile 1 is the
    request, of any shape at K = 1; a chain of K > 1 takes square tiles (qt ==
    rt) only.  Each later level's request is computed on the device by
    ``next_tiles`` from the walk of the level before, as the host would
    compute it if the extension took that walk's cutoff advance and did not
    terminate.  Tile 1 is gathered here; each later level's tiles and sizes
    come from the same ``next_tiles`` launch as its request, so a level is
    three kernels (DP with trace, walk, next tile) and the walk's zeroed
    records.  All K levels are enqueued with no host sync; the returned
    zero-arg resolve() fetches the K record matrices, tile 1's stats and the
    K-1 speculative requests in one transfer (the one host sync) and expands
    tile 1's records into op arrays.

    chrom_start / chrom_len: each lane's chromosome (absolute start, padded
    length); q_buf_start / q_len: its read's start in the query buffer and its
    length.  resolve() -> {ops (B, L) uint8, n_ops, q_steps, r_steps, score,
    query_max_pos, ref_max_pos of tile 1, L = min(qt + rt, 2 * max_tb);
    ``spec_req``: per level 2..K a tuple of (B,) int64 (r_start, r_size,
    q_start, q_size) — the request the level was computed under — and
    ``ops_spec``: a SpecLevels of those levels' walks}."""
    if K > 1 and qt != rt:
        raise ValueError(f"speculative chains take square tiles: {qt}x{rt}")
    if K < 1:
        raise ValueError(f"chain depth K must be >= 1: {K}")
    dev = ref_codes.device
    rows = [np.asarray(x, np.int64) for x in (
        r_start, r_size, q_start, q_size, rev, chrom_start, chrom_len,
        q_buf_start, q_len)]
    r_start, r_size, q_start, q_size, rev = rows[:5]
    # the extension's position at tile 1 (chromosome- and read-relative):
    # the tile's first cell going right, its last going left
    rel_r = r_start - rows[5]
    rel_q = q_start - rows[7]
    rv = rev != 0
    curr0 = [np.where(rv, rel_r, rel_r + r_size - 1),
             np.where(rv, rel_q, rel_q + q_size - 1)]
    req = _upload(dev, *rows, *curr0)
    B = req.shape[1]
    rev_d = req[4] != 0
    lane = req[4:9]
    curr = req[9:11]
    se = torch.ones(B, dtype=torch.bool, device=dev)
    # level 1's tiles; each later level's come from gact_next
    qtile, rtile = gather_tiles(ref_codes, query_codes, req[0], req[1],
                                req[2], req[3], rev_d, qt, rt)
    sizes = tile_sizes(req[3], req[1])
    recs, spec = [], []
    for j in range(K):
        rec, stats = _extend_tile(qtile, rtile, sizes, se, params, max_tb)
        recs.append(rec)
        if j == 0:
            stats1 = torch.stack(stats)
        if j < K - 1:
            nxt, qtile, rtile, sizes = next_tiles(
                rec, lane, curr, ref_codes, query_codes, qt, stop_thr,
                qt + rt)
            curr = nxt[4:6]
            spec.append(nxt[:4])
    # one int32 matrix: the records, the stats, then the int64 requests'
    # bytes as int32 pairs
    parts = recs + [stats1]
    if spec:
        parts.append(torch.cat(spec).view(torch.int32).reshape(-1, B))
    packed = torch.cat(parts)
    L = min(qt + rt, 2 * max_tb)

    def resolve():
        p = fetch(packed)
        R = rt
        ops, n_ops = gact.expand_records(p[:R], B, L)
        tail = p[K * R + 5:].reshape(-1).view(np.int64).reshape(-1, B)
        spec_req = [tuple(tail[4 * j:4 * j + 4]) for j in range(K - 1)]
        return {"ops": ops, "n_ops": n_ops,
                **_stats_dict(p[K * R:K * R + 5]),
                "spec_req": spec_req,
                "ops_spec": SpecLevels(p[R:K * R].reshape(K - 1, R, B), L)}
    return resolve
