"""The traced run's profiler and its reduction: the device's busy time as
the union of its activity intervals (a copy of
``darwin_tpu_torch/tools/profile_align._busy_ms``), kernel device times by
name, and the breakdown of the longest device operations and idle gaps."""

from __future__ import annotations

import collections

import torch
from torch.profiler import ProfilerActivity, profile, record_function

MARK = "bench.batch_done"


def start():
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def marker():
    """A zero-length host event where a batch's lines were written."""
    with record_function(MARK):
        pass


def merge(spans):
    """The union of (start, end, name) intervals as sorted (start, end,
    name of the first operation in it)."""
    out = []
    for s, e, n in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e, n])
    return out


def reduce(prof, ctx, stats) -> dict:
    """Per-layer inputs from the trace: ``busy_s`` and ``trace_window_s``
    over the window (the first batch's lines to the last's), ``kernel_s``
    (device seconds by kernel name over the whole align phase) and the
    ``breakdown``."""
    # the profiler's raw events: building its event tree takes minutes
    # for the hundreds of thousands of host operations of a run
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    marks = sorted(e.start_ns() for e in events if e.name() == MARK)
    dev = [(e.start_ns(), e.end_ns(), e.name()) for e in events
           if e.device_type() == cuda]
    kernel_s = collections.Counter()
    for s, e, n in dev:
        kernel_s[n] += (e - s) / 1e9
    out = {"kernel_s": dict(kernel_s)}
    if len(marks) < 2 or not dev:
        return out
    lo, hi = marks[0], marks[-1]
    clipped = [(max(s, lo), min(e, hi), n) for s, e, n in dev
               if e > lo and s < hi]
    busy = merge(clipped)
    in_window = collections.Counter()
    for s, e, n in clipped:
        in_window[n] += (e - s) / 1e9
    gaps = [(b[0] - a[1], b[2]) for a, b in zip(busy, busy[1:])]
    gaps.sort(reverse=True)
    out.update({
        "busy_s": sum(e - s for s, e, _ in busy) / 1e9,
        "trace_window_s": (hi - lo) / 1e9,
        "breakdown": {
            "device_ops": [[n, t] for n, t in in_window.most_common(10)],
            "idle_gaps": [[f"before {n}", g / 1e9] for g, n in gaps[:10]]}})
    return out
