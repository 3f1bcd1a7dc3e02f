"""Stage telemetry: host wall seconds per named stage, summed into a
caller's dict (darwin_tpu's ``stage_seconds`` sinks), and, while a run
records (``Spans``), one span per ``mark``.

A span is (name, thread, batch, start ns, end ns) on ``time.perf_counter``'s
clock.  Each thread appends to a list of its own, so marking takes no lock;
a thread joins a run's recorder once per batch (``bound``).  Thread 0 is
the one that started recording (``recording``: ``pipeline.align.run``'s
own); batches are numbered in the order ``run()`` read them.  Spans nest
on a thread as the marks chain: a stage holds its sub-stages, and the
waits of ``utils.turns.fetch`` (``wait_card``, ``wait_turn``) lie inside
the stage that fetched.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time

_tls = threading.local()      # .rec: the calling thread's _Thread, if any


class _Thread(list):
    """One thread's spans in one run: (name, batch, start ns, end ns)."""

    def __init__(self, number):
        super().__init__()
        self.number = number
        self.batch = None


def mark(stage_seconds: dict | None, key: str, t0: float,
         batch: int | None = None) -> float:
    """Add the seconds since ``t0`` to ``stage_seconds[key]`` (when a dict
    is given) and, on a thread bound to a recording run, record the span
    from ``t0`` to now, charged to ``batch`` (by default the thread's
    current one); returns the time now, the next stage's ``t0``."""
    t = time.perf_counter()
    if stage_seconds is not None:
        stage_seconds[key] = stage_seconds.get(key, 0.0) + t - t0
    rec = getattr(_tls, "rec", None)
    if rec is not None:
        rec.append((key, rec.batch if batch is None else batch,
                    int(t0 * 1e9), int(t * 1e9)))
    return t


class Spans:
    """One run's span recorder."""

    def __init__(self):
        self._threads: dict = {}      # thread ident -> _Thread
        self._join = threading.Lock()
        self.clock_ns: list = []      # perf_counter_ns inside each anchor

    @contextlib.contextmanager
    def bound(self, batch):
        """Record the calling thread's marks, charged to ``batch``."""
        ident = threading.get_ident()
        with self._join:
            rec = self._threads.get(ident)
            if rec is None:
                rec = self._threads[ident] = _Thread(len(self._threads))
        prev, prev_batch = getattr(_tls, "rec", None), rec.batch
        _tls.rec, rec.batch = rec, batch
        try:
            yield
        finally:
            _tls.rec, rec.batch = prev, prev_batch

    def anchor(self):
        """A ``darwin.clock`` range in the profiler's trace with a
        ``perf_counter_ns`` reading inside it: the pair maps spans onto
        the trace's clock."""
        from torch.profiler import record_function
        with record_function("darwin.clock"):
            self.clock_ns.append(time.perf_counter_ns())

    def _on_gc(self, phase, info):
        """gc.callbacks: the collector's pass as a ``gc`` span of the
        thread it ran on."""
        if phase == "start":
            _tls.gc_t0 = time.perf_counter()
        elif getattr(_tls, "gc_t0", None) is not None:
            mark(None, "gc", _tls.gc_t0)
            _tls.gc_t0 = None

    @contextlib.contextmanager
    def recording(self):
        """Record on the calling thread (thread 0) and every pass of the
        collector, between two clock anchors; gc.callbacks is restored
        on the way out, also when the block raises."""
        gc.callbacks.append(self._on_gc)
        try:
            with self.bound(None):
                self.anchor()
                yield
                self.anchor()
        finally:
            gc.callbacks.remove(self._on_gc)

    def table(self) -> dict:
        """{"spans": [(name, thread, batch, start ns, end ns)] by start,
        "clock_ns": the anchors' readings}."""
        with self._join:
            threads = list(self._threads.values())
        spans = [(k, rec.number, b, s, e) for rec in threads
                 for k, b, s, e in rec]
        spans.sort(key=lambda x: (x[3], -x[4]))
        return {"spans": spans, "clock_ns": list(self.clock_ns)}


def bound(spans: Spans | None, batch):
    """``spans.bound(batch)``, or nothing when the run records no spans."""
    return contextlib.nullcontext() if spans is None else spans.bound(batch)


def recording(spans: Spans | None):
    """``spans.recording()``, or nothing when the run records no spans."""
    return contextlib.nullcontext() if spans is None else spans.recording()
