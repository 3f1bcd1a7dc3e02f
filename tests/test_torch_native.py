"""The port's host library from many threads at once: encode_seq and
revcomp, whose lookup tables are built on the first call, give every
thread the single-thread result even when all threads make that first call
together (two read batches in flight call the library from two threads)."""

import ctypes
import sys
import threading

import numpy as np

from darwin_tpu_torch import native

THREADS = 16


def _bind(path):
    lib = ctypes.CDLL(path)
    p8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.encode_seq.argtypes = [p8, ctypes.c_int64, p8, p8]
    lib.encode_seq.restype = None
    lib.revcomp.argtypes = [p8, ctypes.c_int64, p8]
    lib.revcomp.restype = ctypes.c_int64
    return lib


def _work(lib, seq):
    codes5 = np.empty(len(seq), np.uint8)
    codes2 = np.empty(len(seq), np.uint8)
    lib.encode_seq(seq, len(seq), codes5, codes2)
    rc = np.empty(len(seq), np.uint8)
    bad = lib.revcomp(seq, len(seq), rc)
    return codes5, codes2, rc, bad


def test_encode_and_revcomp_from_many_threads(tmp_path):
    assert native.available(), native.unavailable_reason()
    # a fresh copy of the library, so that its tables are built by the
    # threads' first calls
    path = str(tmp_path / "fresh.so")
    native._build(path)
    lib = _bind(path)
    rng = np.random.default_rng(0)
    seq = np.frombuffer(b"ACGTacgtNn", np.uint8)[rng.integers(0, 10, 1 << 20)]
    start = threading.Barrier(THREADS)
    results = [None] * THREADS

    def worker(i):
        start.wait(timeout=60)
        results[i] = _work(lib, seq)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    want = _work(lib, seq)
    codes5 = np.full(256, 4, np.uint8)
    codes2 = np.zeros(256, np.uint8)
    for i, c in enumerate(b"ACGT"):
        codes5[c] = codes5[c + 32] = codes2[c] = codes2[c + 32] = i
    comp = np.zeros(256, np.uint8)
    comp[np.frombuffer(b"acgtACGTnN", np.uint8)] = np.frombuffer(
        b"tgcaTGCAnN", np.uint8)
    np.testing.assert_array_equal(want[0], codes5[seq])
    np.testing.assert_array_equal(want[1], codes2[seq])
    np.testing.assert_array_equal(want[2], comp[seq[::-1]])
    assert want[3] == -1
    for got in results:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # an invalid character is reported where it is
    bad = seq.copy()
    bad[1234] = ord("X")
    assert _work(lib, bad)[3] == 1234
