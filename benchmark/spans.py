"""The program's spans in a traced run.

``run()`` records spans under the profiler (``stats_out["spans"]``:
(name, thread, batch, start ns, end ns) on ``perf_counter``'s clock,
thread 0 its own, and two ``darwin.clock`` anchors).  They are read two
ways:

* per read, as host self time (the readers below): a stage's spans minus
  the waits of its thread inside them (``wait_card``, the copy that waits
  for the card; ``wait_turn``, winning the host's turn back), over the
  batches after the first;
* against the device trace (``reduce``): mapped onto the trace's clock
  through the anchors (the offset interpolated between them: the two
  clocks drift apart by up to 0.1 ms a second), every instant the card is
  idle in the window of ``device.idle`` is charged to one name — ``gc``
  when the collector runs on any thread, else the innermost span of the
  worker holding the host's turn (in a stage and not in a wait), else
  run()'s own thread's innermost span that is not a wait, else
  ``unattributed``.

Until ``harness.run_cell``'s traced branch calls ``reduce`` itself after
``profiling.reduce``, ``python3 benchmark/spans.py --workload W --seed N
--seconds S`` runs ``run.py --trace 1`` with it: the result line's
``breakdown`` gains ``idle_by_span`` and ``idle_attributed_share``, each
idle gap names the span that held most of it, and ``metrics`` gains
``device.idle_in_decode.map``.
"""

from __future__ import annotations

import bisect
import collections
import os
import sys

CLOCK = "darwin.clock"
MAIN = 0                      # run()'s own thread
WAITS = ("wait_card", "wait_turn")
UNATTRIBUTED = "unattributed"
# the metrics that read ``reduce``: BENCHMARK.json lists them once the
# harness calls it
PENDING = [{"name": "device.idle_in_decode.map", "unit": "fraction",
            "better": "lower", "source": "device_trace",
            "layer": "device: run() batches on per-thread CUDA streams",
            "moves": "map_reads_per_s",
            "workloads": ["ecoli_k12_pacbio.map"]}]


def _spans(ctx):
    table = ctx.get("stats", {}).get("spans")
    return None if table is None else table["spans"]


def _per_read(ctx, ns):
    """``ns`` over the reads of the batches after the first, in ms."""
    n = ctx["stats"].get("counters", {}).get("num_reads", 0) \
        - ctx["first_reads"]
    return ns / 1e6 / n if n > 0 else None


def self_ns(spans, name) -> int:
    """The spans ``name`` of the batches after the first, less the waits
    of their thread inside them, in ns."""
    waits = collections.defaultdict(list)
    for n, th, _, s, e in spans:
        if n in WAITS:
            waits[th].append((s, e))
    index = {}
    for th, w in waits.items():
        w.sort()
        acc = [0]
        for s, e in w:
            acc.append(acc[-1] + e - s)
        index[th] = ([s for s, _ in w], acc)
    total = 0
    for n, th, b, s, e in spans:
        if n != name or not b:
            continue
        total += e - s
        if th in index:
            starts, acc = index[th]
            total -= acc[bisect.bisect_left(starts, e)] \
                - acc[bisect.bisect_left(starts, s)]
    return total


def _self_ms(ctx, name):
    spans = _spans(ctx)
    return None if spans is None else _per_read(ctx, self_ns(spans, name))


def seed_self_ms(ctx):
    return _self_ms(ctx, "seed")


def filter_self_ms(ctx):
    return _self_ms(ctx, "filter")


def print_ms(ctx):
    return _self_ms(ctx, "print")


def turn_wait_ms(ctx):
    """Every wait for the host's turn (after a fetch, and before a
    batch's first stage), ms a read."""
    spans = _spans(ctx)
    if spans is None:
        return None
    return _per_read(ctx, sum(e - s for n, _, b, s, e in spans
                              if n == "wait_turn" and b))


def idle_in_decode(ctx):
    """The card's idle time charged to ``extend_decode`` over the
    window (``reduce``)."""
    by_span = ctx.get("idle_by_span_s")
    if by_span is None or not ctx.get("trace_window_s"):
        return None
    return by_span.get("extend_decode", 0.0) / ctx["trace_window_s"]


def charge(spans, idle):
    """Each instant of the sorted, disjoint ``idle`` intervals charged to
    one name by the rules of the module docstring.  ``spans``: (name,
    thread, start, end) on one clock.  Returns a Counter of ns per name
    over all of ``idle`` and one per interval."""
    ev = [(t, 1, 0, -1) for iv in idle for t in iv]
    for i, (_, _, s, e) in enumerate(spans):
        if e > s:
            ev += [(s, 2, -e, i), (e, 0, 0, i)]
    ev.sort()
    stacks = collections.defaultdict(list)
    n_gc = 0

    def holder():
        if n_gc:
            return "gc"
        best = None
        for th, st in stacks.items():
            if th != MAIN and st and spans[st[-1]][0] not in WAITS and (
                    best is None or spans[st[-1]][2] > best[2]):
                best = spans[st[-1]]
        if best is not None:
            return best[0]
        for i in reversed(stacks.get(MAIN, ())):
            if spans[i][0] not in WAITS:
                return spans[i][0]
        return UNATTRIBUTED

    total = collections.Counter()
    per = [collections.Counter() for _ in idle]
    k, prev = 0, None
    for t, kind, _, i in ev:
        if prev is not None and t > prev:
            while k < len(idle) and idle[k][1] <= prev:
                k += 1
            if k < len(idle) and idle[k][0] <= prev:
                name = holder()
                total[name] += t - prev
                per[k][name] += t - prev
        prev = t
        if kind == 1:
            continue
        name, th = spans[i][:2]
        if kind == 2:
            stacks[th].append(i)
        else:
            stacks[th].remove(i)
        if name == "gc":
            n_gc += 1 if kind == 2 else -1
    return total, per


def attribute(table, clock_ends, marks, dev, breakdown) -> dict:
    """``reduce`` on plain values: the spans table, the ends of the
    trace's ``darwin.clock`` ranges, its batch marks, its device
    intervals (start, end, name) and ``profiling.reduce``'s breakdown."""
    from benchmark import profiling
    readings = table["clock_ns"]
    if len(clock_ends) != 2 or len(readings) != 2 or len(marks) < 2:
        return {}
    offs = [c - r for c, r in zip(sorted(clock_ends), readings)]
    drift = (offs[1] - offs[0]) / ((readings[1] - readings[0]) or 1)

    def on_trace(t):
        return t + offs[0] + drift * (t - readings[0])
    spans = [(n, th, on_trace(s), on_trace(e))
             for n, th, _, s, e in table["spans"]]
    lo, hi = marks[0], marks[-1]
    busy = profiling.merge([(max(s, lo), min(e, hi), n) for s, e, n in dev
                            if e > lo and s < hi])
    idle, cur = [], lo
    for s, e, _ in busy:
        if s > cur:
            idle.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        idle.append((cur, hi))
    total, per = charge(spans, idle)
    idle_ns = sum(e - s for s, e in idle)
    share = 1 - total[UNATTRIBUTED] / idle_ns if idle_ns else None
    # profiling.reduce's gaps, in its order, named by their main holder
    at = {s: i for i, (s, _) in enumerate(idle)}
    gaps = sorted(((b[0] - a[1], b[2], a[1]) for a, b in zip(busy, busy[1:])),
                  key=lambda g: g[:2], reverse=True)
    relabelled = []
    for (label, sec), (_, _, s) in zip(breakdown.get("idle_gaps", []), gaps):
        held = per[at[s]].most_common(1)
        relabelled.append([f"{held[0][0] if held else UNATTRIBUTED} | "
                           f"{label}", sec])
    return {"idle_by_span_s": {n: t / 1e9 for n, t in total.items()},
            "idle_attributed_share": share,
            "clock_drift_ms": (offs[1] - offs[0]) / 1e6,
            "breakdown": dict(
                breakdown, idle_gaps=relabelled,
                idle_by_span=[[n, t / 1e9] for n, t in total.most_common(10)],
                idle_attributed_share=share)}


def reduce(prof, ctx) -> dict:
    """The span reduction of a traced run, after ``profiling.reduce``
    (whose ``breakdown`` it extends): ``idle_by_span_s`` (the card's idle
    seconds in the window by the name charged), ``idle_attributed_share``
    (the share charged to a span), ``clock_drift_ms`` (the second anchor's
    offset less the first's) and the ``breakdown`` with ``idle_by_span`` (the
    top 10), ``idle_attributed_share`` and each idle gap named by the span
    that held most of it.  Nothing where the run recorded no spans."""
    import torch
    from benchmark import profiling
    table = ctx.get("stats", {}).get("spans")
    if table is None or "breakdown" not in ctx:
        return {}
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    return attribute(
        table, [e.end_ns() for e in events if e.name() == CLOCK],
        sorted(e.start_ns() for e in events if e.name() == profiling.MARK),
        [(e.start_ns(), e.end_ns(), e.name()) for e in events
         if e.device_type() == cuda], ctx["breakdown"])


def main(argv=None) -> int:
    """``run.py --trace 1`` with ``reduce`` after ``profiling.reduce`` and
    the PENDING metrics."""
    from benchmark import run as bench   # its environment before torch's
    from benchmark import harness, profiling
    base, load = profiling.reduce, harness.load_spec

    def both(prof, ctx, stats):
        out = base(prof, ctx, stats)
        out.update(reduce(prof, dict(ctx, **out)))
        return out

    def with_pending(root):
        spec = load(root)
        spec["per_layer"] = spec["per_layer"] + PENDING
        return spec
    profiling.reduce, harness.load_spec = both, with_pending
    try:
        return bench.main([*(sys.argv[1:] if argv is None else argv),
                           "--trace", "1"])
    finally:
        profiling.reduce, harness.load_spec = base, load


if __name__ == "__main__":
    sys.path[:1] = [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    sys.exit(main())
