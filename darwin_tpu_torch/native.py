"""ctypes bindings for the port's host library (csrc/darwin_native.cpp):
FASTA scanning, anchor chaining, the batched tile decode, the walker's
record expansion and the rescore of an emitted alignment.

The port's own copy of ``darwin_tpu/native.py``.  The library is compiled
on demand with g++ (plain C ABI) into ``darwin_tpu_torch/_build/``, named
by a hash of its source, written under a temporary name and moved into
place with ``os.replace`` so that concurrent processes never load a
half-written file.  Every entry point returns None when the toolchain or
the library is unavailable (``available()``): FASTA reading then takes its
Python path, chaining and decoding raise with ``unavailable_reason()``,
which keeps the failed step's own message (g++'s errors, the loader's).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "darwin_native.cpp")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lib = None
_tried = False
_error = ""          # why the library is unavailable, once a load failed
_lock = threading.Lock()
# seconds this process spent compiling the library (0.0 when it loaded one
# already built)
BUILD_INFO = {"seconds": 0.0}

_i64 = ctypes.c_int64
_p8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_pu64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")


def _so_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_PKG, "_build",
                        f"darwin_native_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC],
                   check=True, capture_output=True)
    os.replace(tmp, path)
    BUILD_INFO["seconds"] += time.perf_counter() - t0


def _load():
    global _lib, _tried, _error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            path = _so_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.CalledProcessError) as e:
            _error = f"{type(e).__name__}: {e}"
            if getattr(e, "stderr", None):
                _error += "\n" + e.stderr.decode(errors="replace")
            return None

        lib.fasta_scan.argtypes = [_p8, _i64, _p64, _p64, _p64, _i64,
                                   ctypes.c_void_p]
        lib.fasta_scan.restype = _i64
        lib.fasta_seq_bytes.argtypes = [_p8, _i64]
        lib.fasta_seq_bytes.restype = _i64
        lib.chain_anchors.argtypes = [
            _p64, _p32, _p32, _i64, _p32, _p32, _p64, _i64, _i64,
            _pu64, _p64, _pu64, _p64, _p32, _p64, _i64]
        lib.chain_anchors.restype = _i64
        lib.decode_ops_batch.argtypes = [
            _p8, _i64, _p64, _i64, _p64, _p64, _p32, _p8, _p64, _p8,
            _p64, _p64, _p64, _p64, _p64, _p8, _p8, _p64, _p64, _p64,
            _p32, _p32]
        lib.decode_ops_batch.restype = None
        lib.expand_records.argtypes = [ctypes.c_void_p, _i64, _i64, _i64,
                                       _i64, _i64, _p8, _p32]
        lib.expand_records.restype = None
        lib.score_alignment.argtypes = [_p8, _p8, _i64, _p64, _i64, _i64,
                                        _i64, _i64]
        lib.score_alignment.restype = _i64
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> str:
    """What to tell a caller that cannot do without the library."""
    return ("the native host library (csrc/darwin_native.cpp, built with "
            f"g++ at first use) is unavailable: {_error}")


def chain_anchors_native(hits_bin, hits_off, hits_pos, n_hits,
                         anc_pos, anc_off, anc_bin, n_anc, sv):
    """Returns (left_out, left_offsets, right_out, right_offsets,
    num_chained, scores) or None if the library is unavailable."""
    lib = _load()
    if lib is None or n_anc == 0:
        return None
    def as_u32_bits(a, n):
        # positions span the full uint32 address width; the C side works
        # on the bit pattern ((uint32_t) casts) — wrap explicitly
        return np.ascontiguousarray(
            (np.asarray(a[:n], np.int64)
             & np.int64(0xFFFFFFFF)).astype(np.uint32).view(np.int32))

    # bins use int64 (bin values reach 2^32-2 for bin_size=1 on a full
    # uint32 address space)
    hb = np.ascontiguousarray(hits_bin[:n_hits], np.int64)
    ho = np.ascontiguousarray(hits_off[:n_hits], np.int32)
    hp = as_u32_bits(hits_pos, n_hits)
    ap = as_u32_bits(anc_pos, n_anc)
    ao = np.ascontiguousarray(anc_off[:n_anc], np.int32)
    ab = np.ascontiguousarray(anc_bin[:n_anc], np.int64)
    cap = max(int(n_hits) * 2, 64)
    while True:
        left = np.empty(cap, np.uint64)
        right = np.empty(cap, np.uint64)
        loff = np.empty(n_anc + 1, np.int64)
        roff = np.empty(n_anc + 1, np.int64)
        nch = np.empty(n_anc, np.int32)
        sc = np.empty(n_anc, np.int64)
        need = lib.chain_anchors(hb, ho, hp, n_hits, ap, ao, ab, n_anc,
                                 sv, left, loff, right, roff, nch, sc, cap)
        if need <= cap:
            return left, loff, right, roff, nch, sc
        cap = int(need) + 64


def decode_ops_batch_native(ops2d, sel, n_ops, stop_thr, direction,
                            bases, ref_start_addr, qconcat, q_off,
                            curr_ref, curr_q, ref_len, q_len):
    """Batched decode_ops over rows sel of the (B, L) op matrix.  All
    per-tile vectors are aligned with sel (length nsel).  Returns
    (out_ref (nsel, L), out_q (nsel, L), cols, new_ref, new_q, rb, qb)
    or None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    ops2d = np.ascontiguousarray(ops2d, np.uint8)
    nsel = len(sel)
    L = ops2d.shape[1]
    out_ref = np.empty((nsel, max(L, 1)), np.uint8)
    out_q = np.empty((nsel, max(L, 1)), np.uint8)
    cols = np.empty(nsel, np.int64)
    new_ref = np.empty(nsel, np.int64)
    new_q = np.empty(nsel, np.int64)
    rb = np.empty(nsel, np.int32)
    qb = np.empty(nsel, np.int32)
    lib.decode_ops_batch(
        ops2d, L, np.ascontiguousarray(sel, np.int64), nsel,
        np.ascontiguousarray(n_ops, np.int64),
        np.ascontiguousarray(stop_thr, np.int64),
        np.ascontiguousarray(direction, np.int32),
        bases, np.ascontiguousarray(ref_start_addr, np.int64),
        qconcat, np.ascontiguousarray(q_off, np.int64),
        np.ascontiguousarray(curr_ref, np.int64),
        np.ascontiguousarray(curr_q, np.int64),
        np.ascontiguousarray(ref_len, np.int64),
        np.ascontiguousarray(q_len, np.int64),
        out_ref, out_q, cols, new_ref, new_q, rb, qb)
    return out_ref, out_q, cols, new_ref, new_q, rb, qb


def expand_records_native(rec, n_valid: int, L: int):
    """(RT, B) records -> (ops (n, L) uint8, n_ops (n,) int32) of the
    first n = min(n_valid, B) lanes, or None if the library is
    unavailable.  ``rec`` may be any strided view; it is read in place
    when it is int32."""
    lib = _load()
    if lib is None:
        return None
    rec = np.asarray(rec)[:, :n_valid]
    if rec.dtype != np.int32:
        rec = rec.astype(np.int32)
    RT, n = rec.shape
    ops = np.zeros((n, L), np.uint8)
    n_ops = np.empty(n, np.int32)
    lib.expand_records(rec.ctypes.data, RT, n,
                       rec.strides[0] // rec.itemsize,
                       rec.strides[1] // rec.itemsize, L, ops, n_ops)
    return ops, n_ops


def score_alignment_native(ref, q, sub5, gap_open: int, gap_extend: int,
                           long_gap_open: int, long_gap_extend: int):
    """Two-piece rescore of the aligned bytes ``ref`` / ``q`` under the
    (5, 5) substitution matrix ``sub5``, or None if the library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    ref = np.ascontiguousarray(ref, np.uint8)
    q = np.ascontiguousarray(q, np.uint8)
    if ref.shape != q.shape:
        raise ValueError(f"aligned rows differ in length: {ref.shape} "
                         f"and {q.shape}")
    return int(lib.score_alignment(
        ref, q, len(ref), np.ascontiguousarray(sub5, np.int64).reshape(25),
        gap_open, gap_extend, long_gap_open, long_gap_extend))


def fasta_scan_native(data: bytes):
    """Returns (names, seqs) lists or None."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    n = len(buf)
    if n == 0:
        return [], []
    total = lib.fasta_seq_bytes(buf, n)
    # first pass: count records
    probe = np.empty(1, np.int64)
    nrec = lib.fasta_scan(buf, n, probe, probe, probe, 0, None)
    if nrec < 0:
        return None
    ns = np.empty(nrec, np.int64)
    ne = np.empty(nrec, np.int64)
    so = np.empty(nrec + 1, np.int64)
    seq = np.empty(total, np.uint8)
    lib.fasta_scan(buf, n, ns, ne, so, nrec,
                   seq.ctypes.data_as(ctypes.c_void_p))
    names = [data[ns[i]:ne[i]].decode() for i in range(nrec)]
    seqs = [seq[so[i]:so[i + 1]].copy() for i in range(nrec)]
    return names, seqs
