"""run()'s spans (utils.stages.Spans): recorded only under torch.profiler,
every stage, sub-stage and wait of every batch with its thread and batch,
summing to ``stage_seconds``, on the trace's clock through the two
``darwin.clock`` anchors, and with no effect on the output."""

import contextlib
import gc
import io

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from darwin_tpu_torch.config import Config
from darwin_tpu_torch.genome import GenomeStore
from darwin_tpu_torch.pipeline import filter as flt
from darwin_tpu_torch.pipeline.align import run
from darwin_tpu_torch.utils import stages
from darwin_tpu_torch.utils.simulate import simulate_reads, write_fasta

torch.set_num_threads(2)

STAGES = {"read_upload", "seed", "filter", "extend", "print"}
MAIN = {"run_parse", "run_wait", "run_write"}
# three batches of three reads, two in flight, chains of 4
PATH = dict(reads_per_batch=3, pipeline_depth=2, spec_k=4)


def _cfg():
    cfg = Config()
    cfg.seed_size = 10
    return cfg


def _block(err: str):
    return [ln for ln in err.splitlines() if ln.startswith("#")]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_spans")
    rng = np.random.default_rng(11)
    g = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 60_000)]
    store = GenomeStore()
    store.add_chromosome("chr1", g)
    store.finalize()
    with open(tmp / "ref.fa", "w") as f:
        f.write(f">chr1\n{g.tobytes().decode()}\n")
    write_fasta(str(tmp / "reads.fa"), simulate_reads(
        store, 9, 0, seed=5, read_lens=rng.integers(600, 1500, 9)))
    return str(tmp / "ref.fa"), str(tmp / "reads.fa")


def _run(files, out=None, **kw):
    out = out or io.StringIO()
    err, stats = io.StringIO(), {}
    run(*files, False, cfg=_cfg(), out=out, err=err, device="cpu",
        stats_out=stats, **dict(PATH, **kw))
    return out.getvalue(), _block(err.getvalue()), stats


@pytest.fixture(scope="module")
def traced(files):
    """An untraced run, then the same under the profiler with one forced
    collection in each batch's slope filter: (both runs' outputs and
    stats, the trace's events)."""
    plain = _run(files)
    mp = pytest.MonkeyPatch()
    slope = flt.slope_filter

    def collecting(*a, **kw):
        gc.collect()
        return slope(*a, **kw)
    mp.setattr(flt, "slope_filter", collecting)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = _run(files)
    finally:
        mp.undo()
    return plain, got, prof.profiler.kineto_results.events()


def test_traced_run_records_every_span(traced):
    (sam, block, _), (tsam, tblock, stats), _ = traced
    assert sam.count("\n") > 3 and tsam == sam and tblock == block
    total = stats["stage_seconds"]
    assert {"filter_build", "filter_fetch", "filter_collect"} <= set(total)
    spans = stats["spans"]["spans"]
    names = {s[0] for s in spans}
    assert names == set(total) | MAIN | {"wait_card", "wait_turn", "gc"}
    assert spans == sorted(spans, key=lambda x: (x[3], -x[4]))
    assert all(s <= e for *_, s, e in spans)
    for k, v in total.items():
        assert sum(e - s for n, *_, s, e in spans if n == k) / 1e9 == \
            pytest.approx(v, abs=1e-6), k
    # the batches' work on the two workers, run()'s own on its thread
    by_thread = {}
    for n, th, b, *_ in spans:
        by_thread.setdefault(n in MAIN, set()).add(th)
        if n == "gc" and th == 0:
            # the collector can run on run()'s thread, which serves no batch
            assert b is None
            continue
        assert b in (range(4) if n == "run_parse" else range(3)), (n, b)
    assert by_thread[True] == {0} and by_thread[False] >= {1, 2}
    assert {b for n, _, b, *_ in spans if n in STAGES} == {0, 1, 2}
    # a wait in a fetch lies inside a stage of its thread and batch; the
    # first wait for the turn comes before the batch's first stage
    tops = [x for x in spans if x[0] in STAGES]
    for n, th, b, s, e in spans:
        if n == "wait_card":
            assert any(t[1:3] == (th, b) and t[3] <= s and e <= t[4]
                       for t in tops), (n, th, b)
    for b in range(3):
        first = min(s for n, _, bb, s, _ in tops if bb == b)
        assert any(n == "wait_turn" and bb == b and e <= first
                   for n, _, bb, _, e in spans)


def test_clock_anchors_map_spans_onto_the_trace(traced):
    """The two ``darwin.clock`` ranges, each with its perf_counter_ns
    reading, agree on the offset to the trace's clock within 1 ms, and
    run()'s own spans land inside the traced window between them."""
    _, (_, _, stats), events = traced
    clocks = sorted((e.start_ns(), e.end_ns()) for e in events
                    if e.name() == "darwin.clock")
    readings = stats["spans"]["clock_ns"]
    assert len(clocks) == len(readings) == 2
    off = [end - r for (_, end), r in zip(clocks, readings)]
    assert abs(off[0] - off[1]) < 1e6
    lo = min(e.start_ns() for e in events)
    hi = max(e.end_ns() for e in events)
    shift = sum(off) / 2
    main = [(s + shift, e + shift) for n, th, _, s, e
            in stats["spans"]["spans"] if th == 0]
    assert main and all(lo <= s <= e <= hi for s, e in main)
    assert all(clocks[0][0] - 1e6 <= s and e <= clocks[1][1] + 1e6
               for s, e in main)


def test_untraced_run_records_no_spans(files, monkeypatch):
    """Without the profiler: no recorder, no span, no CUDA timing event,
    and stats_out's keys as before."""
    def refuse(*a, **kw):
        raise AssertionError("created without the profiler")
    monkeypatch.setattr(stages, "Spans", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    _, _, stats = _run(files, spec_k=1, pipeline_depth=1)
    assert set(stats) == {"align_seconds", "index_seconds", "index_build",
                          "stage_seconds", "stage_seconds_cold",
                          "stage_seconds_warm", "counters", "compile_s"}
    assert getattr(stages._tls, "rec", None) is None


@pytest.mark.parametrize("traced_run", [False, True])
def test_gc_callbacks_are_restored_when_out_raises(files, traced_run):
    class Broken(io.StringIO):
        def writelines(self, lines):
            raise OSError("sink closed")
    before = list(gc.callbacks)
    with profile(activities=[ProfilerActivity.CPU]) if traced_run else \
            contextlib.nullcontext():
        with pytest.raises(OSError, match="sink closed"):
            _run(files, out=Broken())
    assert gc.callbacks == before
    assert getattr(stages._tls, "rec", None) is None


def test_marks_record_only_on_a_bound_thread():
    """mark() times into the dict always, and records a span only while
    the thread is bound to a recorder, charged to the bound batch or the
    one given; bindings nest and unwind."""
    acc = {}
    t0 = stages.mark(acc, "a", 0.0)
    spans = stages.Spans()
    with spans.bound(7):
        t0 = stages.mark(acc, "a", t0)
        with spans.bound(8):
            t0 = stages.mark(None, "b", t0)
        t0 = stages.mark(None, "c", t0, batch=9)
    stages.mark(acc, "a", t0)
    got = spans.table()
    assert [(n, th, b) for n, th, b, *_ in got["spans"]] == [
        ("a", 0, 7), ("b", 0, 8), ("c", 0, 9)]
    assert got["clock_ns"] == [] and set(acc) == {"a"}
    assert getattr(stages._tls, "rec", None) is None
    assert stages.bound(None, 1).__enter__() is None
