"""The metric arithmetic: the device's busy union, the DP's needed
operations from Darwin's counter block, and rates over batch
completions."""

import pytest

from benchmark import bounds, profiling, readers
from benchmark.harness import Deadline, Sink


def test_busy_union_merges_overlaps():
    spans = [(0, 10, "a"), (5, 12, "b"), (20, 25, "c"), (25, 30, "d"),
             (40, 41, "e")]
    merged = profiling.merge(spans)
    assert [m[:2] for m in merged] == [[0, 12], [20, 30], [40, 41]]
    assert sum(e - s for s, e, _ in merged) == 23
    assert [m[2] for m in merged] == ["a", "c", "e"]


def test_needed_ops_from_counter_block():
    c = {"num_filter_tiles": 10, "num_active_tiles": 7,
         "num_large_tiles": 2}
    per_first = 128 * 128 * (16 + 4)
    per_tile = 384 * 384 * (16 + 24)
    per_large = 1984 * 960 * (16 + 24)
    assert bounds.needed_dp_ops(c) == (10 * per_first + 5 * per_tile
                                       + 2 * per_large)


def test_rates_over_batch_completions():
    ctx = {"reads_done": 384, "window_s": 1.5,
           "setup_s": 12.0}
    assert readers.reads_per_s(ctx) == 256
    assert readers.setup_s(ctx) == 12.0
    assert readers.reads_per_s(dict(ctx, window_s=0)) is None


def test_roofline_and_idle_readers():
    c = {"num_filter_tiles": 0, "num_active_tiles": 100,
         "num_large_tiles": 0, "num_spec_hits": 3, "num_spec_misses": 1,
         "num_reads": 256}
    ops = 100 * 384 * 384 * 40
    t = ops / bounds.PEAK_INT32_OPS_S * 10     # 10 % of its roofline
    ctx = {"kernel_s": {"gact_dp_kernel<6>": t, "other": 5.0},
           "stats": {"counters": c,
                     "stage_seconds_warm": {"extend_decode": 1.28,
                                            "filter": 0.128}},
           "busy_s": 0.25, "trace_window_s": 1.0, "first_reads": 128}
    assert readers.gact_dp_roofline(ctx) == pytest.approx(10.0)
    assert readers.device_idle(ctx) == pytest.approx(0.75)
    assert readers.spec_hit_rate(ctx) == pytest.approx(0.75)
    assert readers.extend_decode_ms(ctx) == pytest.approx(10.0)
    assert readers.filter_ms(ctx) == pytest.approx(1.0)
    assert readers.seed_ms(ctx) is None
    # nothing to read: no value, never 0
    bare = {"stats": {}, "first_reads": 128}
    assert readers.gact_dp_roofline(bare) is None
    assert readers.device_idle(bare) is None


def test_sink_opens_after_warm_batches_and_stops_at_deadline(monkeypatch):
    now = [0.0]
    monkeypatch.setattr("benchmark.harness.time.monotonic", lambda: now[0])
    s = Sink(10, warm=2)
    for t in (5.0, 5.1, 9.0, 15.0):
        now[0] = t
        s.writelines([f"{t}\n"])
    assert s.deadline == 15.1
    now[0] = 15.2
    with pytest.raises(Deadline):
        s.writelines(["late\n"])
    assert [b[0] for b in s.batches] == [5.0, 5.1, 9.0, 15.0]


def test_records_of_a_read_from_its_first_batch():
    from benchmark.harness import records_by_read
    b = [(0, ["r1\t0\n", "r1\t16\n", "r2\t0\n"]), (1, ["r3\t0\n"]),
         (2, ["r1\t0\n", "r1\t16\n"])]
    got = records_by_read(b, ["r1", "r3", "r4"], False)
    assert got == {"r1": ["r1\t0\n", "r1\t16\n"], "r3": ["r3\t0\n"],
                   "r4": []}


def test_sample_from_the_window_longest_first():
    from benchmark.harness import pick_sample, window_reads
    import numpy as np
    stream = [(f"r{i}", np.zeros(100 + (i == 9) * 5, np.uint8))
              for i in range(12)]
    window = window_reads(stream, 5, 4, 2)      # 5 batches of 4, 2 warm
    assert [n for n, _ in window] == ["r8", "r9", "r10", "r11", "r0",
                                      "r1", "r2", "r3", "r4", "r5", "r6",
                                      "r7"]
    s = pick_sample(np.random.default_rng(1), window, 4)
    assert s[0][0] == "r9" and len({n for n, _ in s}) == 4
    assert {n for n, _ in s} <= {n for n, _ in window}
