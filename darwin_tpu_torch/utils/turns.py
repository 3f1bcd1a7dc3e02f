"""Turns on the host for read batches in flight.

Two batches in flight (``pipeline.align.run(pipeline_depth=2)``) run in two
threads of one interpreter.  Their host work is Python and numpy, which the
interpreter lock runs one thread at a time, and every torch call between
them releases the lock and has to win it back: left alone, the lock
changes hands at every call and every switch interval, and two batches
take longer than one batch after the other.  So the batches take turns: a
batch holds the host's turn while it works and hands it over only while it
waits for the card (``fetch``) — the time a second batch in flight can use.
``fetch`` records its waits as spans (``utils.stages.mark``): ``wait_card``
the copy, ``wait_turn`` winning the turn back after it.
"""

from __future__ import annotations

import contextlib
import threading
import time

from darwin_tpu_torch.utils.stages import mark

_current = threading.local()


class HostTurns:
    """The turn that one run's batches in flight share."""

    def __init__(self):
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def turn(self):
        """Hold the host for the calling thread's batch, its waits in
        ``fetch`` excepted."""
        with self._lock:
            _current.turns = self
            try:
                yield
            finally:
                _current.turns = None


def fetch(t):
    """``t.cpu().numpy()``, the device-to-host copy that waits for the
    card; a batch that holds a turn gives it up while it waits."""
    turns = getattr(_current, "turns", None)
    if turns is None:
        t0 = time.perf_counter()
        out = t.cpu().numpy()
        mark(None, "wait_card", t0)
        return out
    turns._lock.release()
    t0 = time.perf_counter()
    try:
        return t.cpu().numpy()
    finally:
        t0 = mark(None, "wait_card", t0)
        turns._lock.acquire()
        mark(None, "wait_turn", t0)
