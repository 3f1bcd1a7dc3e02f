"""The port's host library: its rescore of an emitted alignment against
darwin_tpu's and a literal transcription of the reference's
AlignmentScore, and every entry point from many threads at once.
encode_seq, revcomp and score_alignment, whose lookup tables are built on
the first call, and expand_records give every thread the single-thread
result even when all threads make that first call together (two read
batches in flight call the library from two threads); extension tables
built, decoded and emitted on many threads at once give each thread the
single-thread result."""

import ctypes
import sys
import threading

import numpy as np
import pytest

from darwin_tpu.config import Config as JConfig
from darwin_tpu.pipeline.extend import alignment_score as jalignment_score
from darwin_tpu_torch import native
from darwin_tpu_torch.config import Config
from darwin_tpu_torch.ops import gact
from darwin_tpu_torch.pipeline.extend import alignment_score
from tests.test_pipeline import _alignment_score_literal
from tests.test_torch_extend_native import _configs as _tile_configs
from tests.test_torch_extend_native import _extensions, _table, _world

THREADS = 16


def _bind(path):
    lib = ctypes.CDLL(path)
    p8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.encode_seq.argtypes = [p8, ctypes.c_int64, p8, p8]
    lib.encode_seq.restype = None
    lib.revcomp.argtypes = [p8, ctypes.c_int64, p8]
    lib.revcomp.restype = ctypes.c_int64
    return lib


def _bind_extension(path):
    lib = ctypes.CDLL(path)
    p8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.expand_records.argtypes = [ctypes.c_void_p, i64, i64, i64, i64, i64,
                                   p8, p32]
    lib.expand_records.restype = None
    lib.score_alignment.argtypes = [p8, p8, i64, p64, i64, i64, i64, i64]
    lib.score_alignment.restype = i64
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


# gap parameters (gap_open, gap_extend, long_gap_open, long_gap_extend) and
# the substitution list of each scoring
SCORINGS = {
    "default": {},
    "generic": dict(gap_open=-1, gap_extend=-3, long_gap_open=-2,
                    long_gap_extend=-6,
                    gact_sub_mat=[3, -2, -3, -4, 2, -5, -6, 1, -7, 4, -8]),
    "long_cheaper": dict(gap_open=-4, gap_extend=-2, long_gap_open=-3,
                         long_gap_extend=-1),
}

EDGE_CASES = {
    "empty": ("", ""),
    "all_gap": ("AC--G-", "--GT-T"),
    "leading_gap": ("---ACGTA", "TTGACGTA"),
    "trailing_gap": ("ACGTAC--", "ACGTACGG"),
    "trailing_gap_after_match": ("ACGT--A-", "AC-TGGAC"),
    "ref_gap_abuts_query_gap": ("AC--GGTA", "ACTT--TA"),
    "n_bases": ("ANNTN-ACN", "NCGTAGNCR"),
    "lowercase": ("acgtACGT-acG", "ACgtacGTcaCg"),
}


def _random_alignment(rng, n):
    """n aligned columns: matches and mismatches over upper- and lowercase
    bases, N and other bytes, between reference-gap and query-gap runs of
    geometric lengths, some of them abutting."""
    bases = np.frombuffer(b"ACGTACGTACGTacgtNnR", np.uint8)
    ref = bases[rng.integers(0, len(bases), n)]
    q = np.where(rng.random(n) < 0.85, ref,
                 bases[rng.integers(0, len(bases), n)])
    i = 0
    while i < n:
        i += int(rng.geometric(0.12))
        ln = int(rng.geometric(0.4))
        side = ref if rng.random() < 0.5 else q
        side[i:i + ln] = ord("-")
        i += ln
    return ref.tobytes().decode(), q.tobytes().decode()


def _alignments(rng, case):
    if case != "random":
        return [EDGE_CASES[case]]
    return [_random_alignment(rng, n)
            for n in (1, 2, 17, 300, 4000, 11537, 12000)]


def _configs(scoring):
    cfgs = Config(), JConfig()
    for cfg in cfgs:
        for k, v in SCORINGS[scoring].items():
            setattr(cfg, k, v)
    return cfgs


@pytest.mark.parametrize("case", ["random", *EDGE_CASES])
@pytest.mark.parametrize("scoring", list(SCORINGS))
def test_alignment_score_matches_darwin_tpu_and_literal(scoring, case):
    """The native rescore is darwin_tpu's and the reference's
    AlignmentScore (extender.cpp:1161-1200) on every alignment: gap runs
    scored max(short, long) when they close, a trailing run never added,
    abutting reference- and query-gap runs one run, N and other bytes
    scored by the N row."""
    cfg, jcfg = _configs(scoring)
    rng = np.random.default_rng(sorted(SCORINGS).index(scoring))
    for ref, q in _alignments(rng, case):
        want = _alignment_score_literal(ref, q, cfg)
        r8 = np.frombuffer(ref.encode(), np.uint8)
        q8 = np.frombuffer(q.encode(), np.uint8)
        assert jalignment_score(r8, q8, jcfg) == want
        assert alignment_score(r8, q8, cfg) == want, (ref[:60], q[:60])
        assert alignment_score(ref.encode(), q.encode(), cfg) == want


def test_extension_entry_points_from_many_threads(tmp_path):
    """expand_records and score_alignment called from many threads at once
    (two read batches decode and emit together) give the single-thread
    results, on a fresh copy of the library whose code table the threads'
    first calls build."""
    assert native.available(), native.unavailable_reason()
    path = str(tmp_path / "fresh.so")
    native._build(path)
    lib = _bind_extension(path)
    rng = np.random.default_rng(3)
    RT, B, L = 384, 512, 768
    n_ins = rng.integers(0, 4, (RT, B)) * (rng.random((RT, B)) < 0.3)
    closing = rng.choice([0, gact.OP_M, gact.OP_D], (RT, B),
                         p=[0.1, 0.7, 0.2])
    rec = (n_ins | (closing << 14)).astype(np.int32)
    pairs = [tuple(np.frombuffer(x.encode(), np.uint8)
                   for x in _random_alignment(rng, 11000)) for _ in range(4)]
    sub5 = np.array(Config().sub_matrix_5x5, np.int64).reshape(25)

    def work():
        ops = np.zeros((B, L), np.uint8)
        n_ops = np.empty(B, np.int32)
        lib.expand_records(rec.ctypes.data, RT, B, B, 1, L, ops, n_ops)
        scores = [lib.score_alignment(r, q, len(r), sub5, -4, -2, -25, -1)
                  for r, q in pairs]
        return ops, n_ops, scores

    start = threading.Barrier(THREADS)
    results = [None] * THREADS

    def worker(i):
        start.wait(timeout=60)
        results[i] = work()

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
    want = work()
    np.testing.assert_array_equal(want[0], gact.expand_records(rec, B, L)[0])
    np.testing.assert_array_equal(want[1], gact.expand_records(rec, B, L)[1])
    assert want[2] == [alignment_score(r, q, Config()) for r, q in pairs]
    for got in results:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


def _table_run(seed, start=None):
    """One extension table through random op streams and device requests
    to its end: the state after every level, the emitted rows and their
    scores.  ``start``: a barrier to wait at before the build."""
    rng = np.random.default_rng(seed)
    cfg, _ = _tile_configs(seed % 2 == 1)
    bases, q_ascii, chroms, offsets = _world(rng)
    exts = _extensions(rng, chroms, offsets, 40)
    states = []
    if start is not None:
        start.wait(timeout=60)
    with _table(exts, bases, q_ascii, cfg) as table:
        going = np.arange(len(exts))
        while len(going):
            req, _ = table.requests(going)
            L = 2 * int(req[5:].max())
            n_ops = rng.integers(0, L + 1, len(going)).astype(np.int32)
            ops = rng.choice(np.array([1, 2, 3], np.uint8),
                             (len(going), L), p=[0.15, 0.15, 0.7])
            nxt = list(req[:4] + rng.integers(0, 2, req[:4].shape))
            status, h, m, n_large = table.decode_level(
                going, ops, n_ops, nxt, np.arange(len(going)),
                req[4])
            states.append((status, h, m, n_large,
                           np.stack(list(table.state().values()))))
            going = going[status != 1]
        st = table.state()
        emitted = np.flatnonzero(st["emitted"])
        emit = table.emit(emitted, st["columns"][emitted])
    return states, emitted, emit


def test_extension_tables_from_many_threads():
    """Extension tables built, decoded level by level (requests, the
    decode with its acceptance) and emitted on many threads at once (two
    read batches in flight use two tables from two threads), their calls
    interleaved, give each thread the single-thread result."""
    assert native.available(), native.unavailable_reason()
    want = [_table_run(seed) for seed in range(2)]
    start = threading.Barrier(THREADS)
    results = [None] * THREADS

    def worker(i):
        results[i] = _table_run(i % 2, start)

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
    for i, got in enumerate(results):
        states, emitted, emit = want[i % 2]
        assert len(got[0]) == len(states) > 3
        for g, w in zip(got[0], states):
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1:4] == w[1:4]
            np.testing.assert_array_equal(g[4], w[4])
        np.testing.assert_array_equal(got[1], emitted)
        assert len(emitted) > 0
        for g, w in zip(got[2], emit):
            np.testing.assert_array_equal(g, w)
