"""ctypes bindings for the port's host library (csrc/darwin_native.cpp):
FASTA scanning, anchor chaining, the walker's record expansion, the
rescore of an emitted alignment, the extension table (a read batch's
extensions and their tile state machine, ``ExtensionTable``) and a batch's
SAM CIGARs.

The port's own copy of ``darwin_tpu/native.py``.  The library is compiled
on demand with g++ (plain C ABI) into ``darwin_tpu_torch/_build/``, named
by a hash of its source, written under a temporary name and moved into
place with ``os.replace`` so that concurrent processes never load a
half-written file.  Every entry point returns None when the toolchain or
the library is unavailable (``available()``): FASTA reading then takes its
Python path, chaining, decoding and the SAM printer raise with
``unavailable_reason()``,
which keeps the failed step's own message (g++'s errors, the loader's);
so does ``ExtensionTable``.
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
_pi8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
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
        _vp = ctypes.c_void_p
        lib.ext_table_new.argtypes = [_i64, _p64, _pu64, _p64, _pu64, _p64,
                                      _p8, _p8, _p64, _p64]
        lib.ext_table_new.restype = _vp
        lib.ext_table_free.argtypes = [_vp]
        lib.ext_table_free.restype = None
        lib.ext_requests.argtypes = [_vp, _p64, _i64, _p64]
        lib.ext_requests.restype = _i64
        lib.ext_decode_level.argtypes = [_vp, _p64, _i64, _p8, _i64, _p32,
                                         _vp, _i64, _vp, _vp, _pi8, _p64]
        lib.ext_decode_level.restype = _i64
        lib.ext_state.argtypes = [_vp, _p64]
        lib.ext_state.restype = None
        lib.ext_emit.argtypes = [_vp, _p64, _i64, _p64, _p8, _p8, _p64]
        lib.ext_emit.restype = _i64
        lib.expand_records.argtypes = [ctypes.c_void_p, _i64, _i64, _i64,
                                       _i64, _i64, _p8, _p32]
        lib.expand_records.restype = None
        lib.score_alignment.argtypes = [_p8, _p8, _i64, _p64, _i64, _i64,
                                        _i64, _i64]
        lib.score_alignment.restype = _i64
        lib.sam_cigars.argtypes = [_p8, _p8, _p64, _p64, _i64, _p64, _p64,
                                   _p8, _i64, _p64]
        lib.sam_cigars.restype = _i64
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


def sam_cigars_native(refs, queries, head_clips, tail_clips):
    """The SAM CIGAR of each record, in one call (printer.cpp:219-292):
    refs[i] / queries[i] its aligned strings (bytes), head_clips[i] /
    tail_clips[i] its soft clips.  Returns a list of str, or None if the
    library is unavailable; raises ValueError when a record's two strings
    differ in length."""
    lib = _load()
    if lib is None:
        return None
    n = len(refs)
    if not len(queries) == len(head_clips) == len(tail_clips) == n:
        raise ValueError(f"sam_cigars: {n} / {len(queries)} aligned "
                         f"strings, {len(head_clips)} / {len(tail_clips)} "
                         "clips")
    offsets = []
    for rows in (refs, queries):
        off = np.zeros(n + 1, np.int64)
        np.cumsum(np.fromiter(map(len, rows), np.int64, n), out=off[1:])
        offsets.append(off)
    ref_off, q_off = offsets
    ref = np.frombuffer(b"".join(refs), np.uint8)
    q = np.frombuffer(b"".join(queries), np.uint8)
    cap = 2 * int(ref_off[-1]) + 43 * n
    out = np.empty(cap, np.uint8)
    out_off = np.empty(n + 1, np.int64)
    w = lib.sam_cigars(ref, q, ref_off, q_off, n,
                       np.asarray(head_clips, np.int64),
                       np.asarray(tail_clips, np.int64), out, cap, out_off)
    if w == -1:
        raise ValueError("aligned strings differ in length")
    if w < 0:
        raise RuntimeError(f"sam_cigars: output of {cap} bytes too small")
    text = out[:w].tobytes().decode()
    bounds = out_off.tolist()
    return [text[bounds[i]:bounds[i + 1]] for i in range(n)]


# ext_table_* fault codes (csrc/darwin_native.cpp)
_EXT_FAULTS = {-1: (IndexError, "an extension or a row out of range"),
               -2: (ValueError, "a tile's op count outside its op row"),
               -3: (IndexError, "a large tile asked for with no chained "
                                "hit left")}


def _ext_check(rc: int) -> int:
    if rc < 0:
        exc, msg = _EXT_FAULTS[rc]
        raise exc(f"extension table: {msg}")
    return rc


class ExtensionTable:
    """Every extension of one read batch with its tile state machine, in
    the host library (``ext_table_*``): darwin_tpu's ``_Ext`` field for
    field (darwin_tpu/pipeline/extend.py:115-370), one object for the
    batch, so that a chain level's decode, hit popping, termination and
    next request are one call.  Extensions are numbered 0..n-1 in build
    order.  A table is used from one thread; tables share nothing.

    fields: (7, n) int64 rows strand_rc (1 for '-'), ref_start_addr,
    ref_len, q_len, q_code_start, curr_ref, curr_q; left_hits /
    right_hits: per extension its chained hits (uint64, left ascending,
    right descending); bases / q_ascii: the genome with its margin and the
    read batch's query buffer, held here for the table's life; cfg: the
    tile sizes, ``do_overlap`` and the scoring.  Raises RuntimeError when
    the library is unavailable."""

    _h = None

    STATE = ("curr_ref", "curr_q", "ref_start_off", "q_start_off",
             "ref_end_off", "q_end_off", "left_done", "right_done",
             "used_large", "tiles", "left_hits", "right_hits", "finished",
             "emitted", "columns")

    def __init__(self, fields, left_hits, right_hits, bases, q_ascii, cfg):
        lib = _load()
        if lib is None:
            raise RuntimeError("extension table: " + unavailable_reason())
        self._lib = lib
        fields = np.ascontiguousarray(fields, np.int64)
        n = fields.shape[1]
        if fields.shape != (7, n) or len(left_hits) != n \
                or len(right_hits) != n:
            raise ValueError(f"extension table: fields {fields.shape}, "
                             f"{len(left_hits)} / {len(right_hits)} hit "
                             "lists")
        hits, offs = [], []
        for lists in (left_hits, right_hits):
            off = np.zeros(n + 1, np.int64)
            off[1:] = np.cumsum([len(h) for h in lists])
            hits.append(np.concatenate(
                [np.asarray(h, np.uint64) for h in lists] or
                [np.zeros(0, np.uint64)]))
            offs.append(off)
        self._bases = np.ascontiguousarray(bases, np.uint8)
        self._q = np.ascontiguousarray(q_ascii, np.uint8)
        params = np.array([cfg.tile_size, cfg.tile_overlap,
                           cfg.large_tile_long, cfg.large_tile_short,
                           int(cfg.do_overlap), cfg.gap_open, cfg.gap_extend,
                           cfg.long_gap_open, cfg.long_gap_extend], np.int64)
        sub5 = np.ascontiguousarray(cfg.sub_matrix_5x5, np.int64).reshape(25)
        self.n = n
        self._h = lib.ext_table_new(n, fields, hits[0], offs[0], hits[1],
                                    offs[1], self._bases, self._q, params,
                                    sub5)
        if not self._h:
            raise MemoryError(f"extension table of {n} extensions")

    def close(self):
        if self._h:
            self._lib.ext_table_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()

    def requests(self, exts):
        """The next tile's request of each extension in ``exts``: (7,
        len(exts)) int64 rows r_start, r_size, q_start (in the query
        buffer), q_size, rev (1 for the right side), rt, qt; and the large
        tiles counted.  A lane refused at a chain level gets the request it
        was refused with."""
        exts = np.ascontiguousarray(exts, np.int64)
        out = np.empty((7, len(exts)), np.int64)
        n_large = _ext_check(self._lib.ext_requests(self._h, exts,
                                                    len(exts), out))
        return out, n_large

    def decode_level(self, exts, ops, n_ops, nxt=None, rows=None, rev=None):
        """Decode one tile of each extension in ``exts``: op row i of the
        (len(exts), L) matrix ``ops``, ``n_ops[i]`` ops.  With ``nxt``, the
        next chain level's device requests (four (B,) rows r_start, r_size,
        q_start, q_size), every extension still going is accepted for it
        when its own next request equals column ``rows[i]`` of ``nxt``,
        with direction ``rev[rows[i]]`` and a square tile_size tile.
        Returns (status (len(exts),) int8: 0 going on, 1 finished, 2
        accepted; hits, misses, large tiles counted)."""
        exts = np.ascontiguousarray(exts, np.int64)
        ops = np.ascontiguousarray(ops, np.uint8)
        n_ops = np.ascontiguousarray(n_ops, np.int32)
        n = len(exts)
        if ops.ndim != 2 or ops.shape[0] < n or n_ops.shape[0] < n:
            raise ValueError(f"extension table: {n} extensions, ops "
                             f"{ops.shape}, n_ops {n_ops.shape}")
        status = np.empty(n, np.int8)
        counts = np.zeros(3, np.int64)
        B, p_nxt, p_rows, p_rev = 0, None, None, None
        if nxt is not None:
            nxt = np.ascontiguousarray(np.stack(nxt), np.int64)
            rows = np.ascontiguousarray(rows, np.int64)
            rev = np.ascontiguousarray(rev, np.int64)
            B = nxt.shape[1]
            if nxt.shape != (4, B) or rows.shape != (n,) or rev.shape != (B,):
                raise ValueError(f"extension table: next requests "
                                 f"{nxt.shape}, rows {rows.shape}, rev "
                                 f"{rev.shape}")
            p_nxt, p_rows, p_rev = (a.ctypes.data for a in (nxt, rows, rev))
        _ext_check(self._lib.ext_decode_level(
            self._h, exts, n, ops, ops.shape[1], n_ops, p_nxt, B, p_rows,
            p_rev, status, counts))
        return status, int(counts[0]), int(counts[1]), int(counts[2])

    def state(self) -> dict:
        """Every extension's state: name -> (n,) int64, names ``STATE``
        (``left_hits`` / ``right_hits`` the hits left, ``columns`` the
        aligned columns held)."""
        out = np.empty((len(self.STATE), self.n), np.int64)
        self._lib.ext_state(self._h, out)
        return dict(zip(self.STATE, out))

    def emit(self, exts, columns):
        """The aligned rows of the extensions ``exts``, ``columns[i]``
        long each (``state()["columns"]``): (ref, q, offsets, scores), the
        rows of extension i at [offsets[i], offsets[i + 1]) of ref and q
        and their ``score_alignment`` in scores[i]."""
        exts = np.ascontiguousarray(exts, np.int64)
        offsets = np.zeros(len(exts) + 1, np.int64)
        np.cumsum(columns, out=offsets[1:])
        ref = np.empty(offsets[-1], np.uint8)
        q = np.empty(offsets[-1], np.uint8)
        scores = np.empty(len(exts), np.int64)
        _ext_check(self._lib.ext_emit(self._h, exts, len(exts), offsets, ref,
                                      q, scores))
        return ref, q, offsets, scores


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
