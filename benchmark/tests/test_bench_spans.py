"""The span reduction on synthetic intervals: which name each idle instant
of the card is charged to, the relabelled idle gaps, and the span
readers."""

from types import SimpleNamespace as NS

import pytest
import torch

from benchmark import profiling, readers, spans

OFF = 5_000_000           # the trace's clock minus perf_counter's


def _table(rows):
    """rows: (name, thread, batch, start, end) on the trace's clock."""
    return {"spans": [(n, th, b, s - OFF, e - OFF) for n, th, b, s, e in rows],
            "clock_ns": [0, 10_000]}


def _charged(rows, idle):
    total, per = spans.charge([(n, th, s, e) for n, th, _, s, e in rows],
                              idle)
    return dict(total), [dict(c) for c in per]


def test_the_turn_holder_is_charged():
    rows = [("extend", 1, 1, 0, 100), ("extend_decode", 1, 1, 10, 60),
            ("seed", 2, 2, 0, 100), ("wait_card", 2, 2, 5, 90),
            ("run_wait", 0, 1, 0, 100)]
    total, _ = _charged(rows, [(20, 50)])
    assert total == {"extend_decode": 30}


def test_waits_are_never_charged():
    # worker 1 waits for the card, worker 2 for the turn: run()'s thread
    # is charged; at depth 1 a wait on run()'s own thread charges the
    # stage around it
    rows = [("seed", 1, 1, 0, 100), ("wait_card", 1, 1, 10, 90),
            ("wait_turn", 2, 2, 0, 100), ("run_wait", 0, 1, 0, 100)]
    assert _charged(rows, [(20, 30)])[0] == {"run_wait": 10}
    depth1 = [("filter", 0, 1, 0, 100), ("filter_fetch", 0, 1, 10, 90),
              ("wait_card", 0, 1, 20, 80)]
    assert _charged(depth1, [(30, 40)])[0] == {"filter_fetch": 10}


def test_the_collector_wins_on_any_thread():
    rows = [("extend", 1, 1, 0, 100), ("extend_decode", 1, 1, 0, 100),
            ("run_parse", 0, 2, 30, 60), ("gc", 0, 2, 40, 50)]
    total, _ = _charged(rows, [(20, 70)])
    assert total == {"extend_decode": 40, "gc": 10}


def test_run_thread_then_unattributed():
    rows = [("run_parse", 0, 3, 10, 20), ("run_write", 0, 2, 30, 35),
            ("wait_turn", 1, 3, 0, 40)]
    total, per = _charged(rows, [(0, 15), (25, 40), (50, 60)])
    assert total == {"unattributed": 10 + 10 + 10, "run_parse": 5,
                     "run_write": 5}
    assert per == [{"unattributed": 10, "run_parse": 5},
                   {"unattributed": 10, "run_write": 5},
                   {"unattributed": 10}]


def _event(name, s, e, dev=False):
    kind = torch.autograd.DeviceType.CUDA if dev else \
        torch.autograd.DeviceType.CPU
    return NS(name=lambda: name, start_ns=lambda: s, end_ns=lambda: e,
              device_type=lambda: kind)


def _traced():
    """A canned traced run: a window from 1,000 to 2,000 ns on the
    trace's clock, device work at 1,000-1,100, 1,400-1,450 and
    1,900-1,950, and spans on two workers and run()'s thread."""
    rows = [("seed", 1, 1, 1000, 1300), ("wait_card", 1, 1, 1050, 1150),
            ("extend", 2, 0, 1100, 1990), ("extend_decode", 2, 0, 1150, 1400),
            ("wait_card", 2, 0, 1400, 1460),
            ("extend_decode", 2, 0, 1460, 1890),
            ("run_wait", 0, 0, 1000, 1990), ("gc", 1, 1, 1500, 1550),
            ("print", 1, 1, 1300, 1310)]
    events = [_event(profiling.MARK, 1000, 1000),
              _event(profiling.MARK, 2000, 2000),
              _event(spans.CLOCK, 0, OFF), _event(spans.CLOCK, 9_000, OFF +
                                                  10_000),
              _event("k1", 1000, 1100, True), _event("copy", 1400, 1450, True),
              _event("k2", 1900, 1950, True)]
    ctx = {"stats": {"spans": _table(rows),
                     "counters": {"num_reads": 10, "num_spec_hits": 3,
                                  "num_spec_misses": 1,
                                  "num_filter_tiles": 1,
                                  "num_active_tiles": 2,
                                  "num_large_tiles": 0},
                     "stage_seconds_warm": {"seed": 0.01, "filter": 0.02,
                                            "extend_decode": 0.03},
                     "index_seconds": 1.5},
           "first_reads": 5, "setup_s": 12.0, "window_s": 3.0,
           "reads_done": 30}
    prof = NS(profiler=NS(kineto_results=NS(events=lambda: events)))
    ctx.update(profiling.reduce(prof, ctx, ctx["stats"]))
    return prof, ctx


def test_reduce_relabels_the_idle_gaps_in_order():
    prof, ctx = _traced()
    before = [list(g) for g in ctx["breakdown"]["idle_gaps"]]
    assert [g[1] for g in before] == [450e-9, 300e-9]
    got = spans.reduce(prof, ctx)
    gaps = got["breakdown"]["idle_gaps"]
    assert [g[1] for g in gaps] == [g[1] for g in before]
    assert [g[0] for g in gaps] == [f"extend_decode | {before[0][0]}",
                                    f"extend_decode | {before[1][0]}"]
    # 1,100-1,400: worker 1 waits for the card to 1,150 (worker 2's
    # extend), then the later-started of two open stages, print 10;
    # 1,450-1,900: worker 2's copy wait (run()'s own wait), gc 50, decode,
    # extend; 1,950-2,000: extend to 1,990, then nothing open
    assert got["idle_by_span_s"] == pytest.approx({
        "extend": 100e-9, "extend_decode": 240e-9 + 380e-9, "gc": 50e-9,
        "print": 10e-9, "run_wait": 10e-9, "unattributed": 10e-9})
    assert got["idle_attributed_share"] == pytest.approx(1 - 10 / 800)
    assert got["breakdown"]["idle_by_span"][0] == ["extend_decode",
                                                   pytest.approx(620e-9)]
    assert got["breakdown"]["idle_attributed_share"] == \
        got["idle_attributed_share"]
    assert got["clock_drift_ms"] == 0
    # untouched: what profiling.reduce gave
    assert got["breakdown"]["device_ops"] == ctx["breakdown"]["device_ops"]
    ctx.update(got)
    assert spans.idle_in_decode(ctx) == pytest.approx(620 / 1000)


def test_spans_follow_the_trace_clock_between_the_anchors():
    """The trace's clock runs 10 % fast against perf_counter's: a span is
    mapped by the offset interpolated between the two anchors."""
    _, ctx = _traced()
    table = {"spans": [("print", 1, 1, 1400, 1900)],
             "clock_ns": [1000, 2000]}
    # offsets 0 at 1,000 and 100 at 2,000: print lands on 1,440-1,990
    got = spans.attribute(table, [1000, 2100], [1000, 2000],
                          [(1000, 1100, "k1"), (1400, 1450, "copy"),
                           (1900, 1950, "k2")], ctx["breakdown"])
    assert got["clock_drift_ms"] == pytest.approx(1e-4)
    assert got["idle_by_span_s"] == pytest.approx({
        "unattributed": 310e-9, "print": 490e-9})


def test_span_readers_take_self_time_of_the_later_batches():
    _, ctx = _traced()
    # seed (batch 1) 300 ns less its 100 ns wait; 5 reads after the first
    assert spans.seed_self_ms(ctx) == pytest.approx(200 / 1e6 / 5)
    assert spans.print_ms(ctx) == pytest.approx(10 / 1e6 / 5)
    assert spans.filter_self_ms(ctx) == 0
    assert spans.turn_wait_ms(ctx) == 0
    rows = ctx["stats"]["spans"]["spans"]
    rows.append(("wait_turn", 2, 1, 0, 70))
    assert spans.turn_wait_ms(ctx) == pytest.approx(70 / 1e6 / 5)


READERS = [spans.seed_self_ms, spans.filter_self_ms, spans.print_ms,
           spans.turn_wait_ms, spans.idle_in_decode]


@pytest.mark.parametrize("read", READERS, ids=lambda r: r.__name__)
def test_new_readers_find_nothing_without_spans(read):
    _, ctx = _traced()
    del ctx["stats"]["spans"]
    assert read(ctx) is None
    assert spans.reduce(None, ctx) == {}


OLD = [readers.setup_s, readers.reads_per_s, readers.device_idle,
       readers.extend_decode_ms, readers.filter_ms, readers.seed_ms,
       readers.spec_hit_rate, readers.index_build_s,
       readers.gact_dp_roofline]


@pytest.mark.parametrize("read", OLD, ids=lambda r: r.__name__)
def test_old_readers_read_the_same_after_the_reduction(read):
    prof, ctx = _traced()
    ctx["kernel_s"] = {"gact_dp_kernel<6>": 1e-3}
    want = read(ctx)
    ctx.update(spans.reduce(prof, ctx))
    assert read(ctx) == want
