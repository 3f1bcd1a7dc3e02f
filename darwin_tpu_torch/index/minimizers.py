"""(w, k)-minimizer extraction on device (counterpart of
``darwin_tpu/index/minimizers.py``).

Semantics of the reference's ``iterate_minimizers``: a k-mer packs bases
little-endian (base p in the low two bits), hashes with the invertible
Wang-style ``hash32`` masked to 2k bits, m[p] is the window minimum over
the k-mers starting in [p-w+1, p], the scan covers p in [w-1, R-k) with R
the length rounded up to 16, and the emission automaton has the closed
form emit(p) <=> (p - anchor(p)) % w == 0, anchor being the last change of
m (darwin_tpu/index/minimizers.py:19-26) — a cummax, so the scan is
branch-free over a batch of rows.

Values are carried as int64: hashes are <= 30 bits and every uint32 step of
``hash32`` is exact in int64 once masked.

The index scans every sequence of a store through one work list of rows
(``scan_batches``, darwin_tpu's ``_chunk_scan`` / ``scan_many_minimizers``):
a row holds CHUNK new positions of one sequence, rows go to the device
ROWS at a time whatever the sequences' lengths, so overlap mode's read
index (every read a chromosome) takes a few batches, not one call per
read.  On it stand the three device builds of darwin_tpu
(``sorted_pairs_device``, ``sorted_pairs_streaming``, ``build_csr``).
Tables hold 4-byte values: hashes as int32 (< 2^30) and positions as the
int32 bit pattern of their uint32 value (``widen`` reads them back).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

# Geometry of the work-list scan, chosen for the H100 (darwin_tpu's 16 Kbp
# rows and 128 / 2048 rows per call were sized for a TPU's dispatch
# latency).  A row costs its sequence at most CHUNK positions of padding
# and w + 1 + k - 1 of halo: at 8 Kbp that is under 0.3% of a chromosome
# and under a row per read.  The scan holds about 100 bytes per position
# while a batch is live (the gather index, the int64 k-mer and hash
# temporaries, the window minima, the cummax's values and indices, the
# keys), so 4096 rows (33.6 M positions) keep a batch near 3.4 GB of the
# card's 80 GB, and each batch is some 30-70 ms of device work against
# ~0.5 ms to enqueue its kernels.
CHUNK = 1 << 13        # new positions per row
ROWS = 4096            # rows per device batch
SENTINEL = (1 << 63) - 1      # key of a slot that emits nothing: sorts last
TRASH = 1 << 12        # spread sink slots for writes that are dropped
# keys per sort in the streaming pairs build: torch.sort holds the keys,
# an int64 index, both outputs and a radix workspace, ~48 B a key
SORT_PIECE = 1 << 27
# bases uploaded per copy by encode2_on
UPLOAD_PIECE = 1 << 26
# Device memory of the all-candidates build per scanned position (a row's
# P = row_len - k + 1 positions, CHUNK of them new): each batch's keys are
# kept (8 B), concatenated (8 B more while the list lives), then sorted
# (torch.sort: the input, int64 iota indices, both outputs and the radix
# sort's alternate buffers, ~48 B a key).  A live scan batch holds ~100 B
# a position of its own rows.  The streaming pairs build keeps 8 B per
# emitted seed in its accumulator and 8 B per seed of table, plus one
# SORT_PIECE sort; csr keeps 4 B per seed and two (4^k + 1) int32 arrays
# (the offsets and the fill's cursor).
DEVICE_BYTES_PER_POSITION = 56
BATCH_BYTES_PER_POSITION = 100

def hash32(key, k: int):
    """software/ntcoding.h:56-67 (darwin_tpu/index/minimizers.py:37-48) on
    int64 tensors holding uint32 values < 4^k."""
    m = (1 << (2 * k)) - 1
    key = (~key + (key << 21)) & m
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & m
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & m
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & m
    return key


def kmer_hashes(codes2, k: int):
    """codes2 (B, L) uint8 2-bit codes -> (B, L-k+1) int64 hashed k-mers."""
    L = codes2.shape[-1]
    P = L - k + 1
    c = codes2.to(torch.int64)
    kmer = torch.zeros(codes2.shape[:-1] + (P,), dtype=torch.int64,
                       device=codes2.device)
    for i in range(k):
        kmer |= c[..., i:i + P] << (2 * i)
    return hash32(kmer, k)


def _window_min(h, w: int):
    """m[:, p] = min(h[:, p-w+1 .. p]), all-ones where the window starts
    before the row."""
    B, P = h.shape
    m = h
    big = torch.full((B, w), 0xFFFFFFFF, dtype=torch.int64, device=h.device)
    for d in range(1, w):
        m = torch.minimum(m, torch.cat([big[:, :d], h[:, :P - d]], 1))
    return m


def minimizer_scan(codes2, lengths, k: int, w: int):
    """Batched minimizer extraction.

    codes2 (B, L) uint8 2-bit codes, 0 beyond each row's length, L a
    multiple of 16 and >= round16(max length); lengths (B,) true lengths.
    Returns (mins (B, P) int64, emit (B, P) bool), P = L - k + 1, the
    minimizer position being the array index."""
    B, L = codes2.shape
    if L % 16:
        raise ValueError(f"row length {L} is not a multiple of 16")
    dev = codes2.device
    m = _window_min(kmer_hashes(codes2, k), w)
    P = m.shape[1]
    p_idx = torch.arange(P, dtype=torch.int64, device=dev)[None, :]
    m_prev = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                        m[:, :-1]], 1)
    # m[w-2] acts as the initial last_m = 0; positions < w-1 are masked
    change = (p_idx >= w - 1) & (
        m != torch.where(p_idx == w - 1, 0, m_prev))
    anchor = torch.cummax(torch.where(change, p_idx, 0), 1).values
    r16 = (lengths.to(torch.int64) + 15) // 16 * 16
    valid = (p_idx >= w - 1) & (p_idx < (r16 - k)[:, None])
    emit = valid & ((p_idx - anchor) % w == 0)
    return m, emit


# ---------------------------------------------------------------------------
# the work-list scan
# ---------------------------------------------------------------------------

def encode2_on(bases: np.ndarray, dev):
    """ASCII bases -> 2-bit codes (A C G T = 0..3, anything else 0, as
    ``genome.encode2``) on ``dev``: uploaded UPLOAD_PIECE bases at a time
    and encoded there, so a 3 Gbp genome costs no host pass."""
    out = torch.empty(len(bases), dtype=torch.uint8, device=dev)
    for i in range(0, len(bases), UPLOAD_PIECE):
        x = torch.from_numpy(bases[i:i + UPLOAD_PIECE]).to(dev) | 0x20
        out[i:i + UPLOAD_PIECE] = ((x == ord("c")).to(torch.uint8)
                            + 2 * (x == ord("g")).to(torch.uint8)
                            + 3 * (x == ord("t")).to(torch.uint8))
    return out


def work_list(lengths, k: int):
    """One row per CHUNK new positions of each sequence, sequences in
    order: (sequence index, row start, nvalid) per row, nvalid being the
    end of the sequence's scan range (round16(length) - k).  A sequence
    with no valid position keeps one row (darwin_tpu's ``max(nvalid,
    1)``), which emits nothing."""
    lengths = np.asarray(lengths, np.int64)
    nvalid = (lengths + 15) // 16 * 16 - k
    nrows = -(-np.maximum(nvalid, 1) // CHUNK)
    seq = np.repeat(np.arange(len(lengths)), nrows)
    first = np.cumsum(nrows) - nrows
    start = (np.arange(int(nrows.sum()), dtype=np.int64) - first[seq]) * CHUNK
    return seq, start, nvalid[seq]


def row_len(k: int, w: int) -> int:
    """Bases a row of the scan holds: its (w + 1)-base left halo, CHUNK new
    positions and k - 1 bases on the right, rounded up to 16; it scans
    row_len - k + 1 positions."""
    return (CHUNK + w + 1 + k - 1 + 15) // 16 * 16


def device_build_bytes(lengths, k: int, w: int) -> int:
    """Device memory the all-candidates build of these sequences takes at
    most: DEVICE_BYTES_PER_POSITION for every position the work list scans
    (a short read still scans a whole row) and one live batch."""
    rows = len(work_list(lengths, k)[0])
    per_row = row_len(k, w) - k + 1
    return per_row * (DEVICE_BYTES_PER_POSITION * rows
                      + BATCH_BYTES_PER_POSITION * min(rows, ROWS))


def _scan_rows(rows, off, istart, iend, nvalid, new, carry, k: int, w: int):
    """darwin_tpu's ``_chunk_scan`` on one batch of rows.

    rows (B, CL) uint8 codes from local position ``off``; the row emits in
    its interior [istart, iend); ``new`` marks a row that starts its
    sequence; ``carry`` (1,) is the anchor carried out of the previous
    batch.  Returns (m, emit, pg, carry_out): minima, emission and local
    positions (B, P), and the anchor after the last row."""
    B = rows.shape[0]
    dev = rows.device
    m = _window_min(kmer_hashes(rows, k), w)
    P = m.shape[1]
    prow = torch.arange(P, dtype=torch.int64, device=dev)[None, :]
    pg = off[:, None] + prow
    # windows are complete for prow >= w-1; m_prev also needs prow >= w
    # except at the sequence's first window (pg == w-1), which compares
    # against the automaton's initial last_m = 0
    at_init = pg == w - 1
    window_ok = (prow >= w) | (at_init & (prow >= w - 1))
    m_prev = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                        m[:, :-1]], 1)
    change = window_ok & (pg < nvalid[:, None]) & (
        m != torch.where(at_init, 0, m_prev))
    cpos = torch.where(change, pg, 0)
    anchor = torch.cummax(cpos, 1).values
    # a row passes on the changes of its own interior only: its tail is
    # the next row's halo, and feeding it on would hand later rows anchors
    # from their own future
    row_max = torch.where(pg < iend[:, None], cpos, 0).amax(1)
    # the anchor chains through the rows: a row that starts its sequence
    # resets it to 0, row 0 of a batch otherwise resumes ``carry``; the
    # segmented running max is one cummax over (segment << 33 | value),
    # local positions being < 2^31
    row0 = torch.arange(B, device=dev) == 0
    first = new | row0
    cin = torch.where(row0 & ~new, carry, 0)
    seg = torch.cumsum(first.to(torch.int64), 0)
    incl = torch.cummax((seg << 33) | torch.maximum(row_max, cin),
                        0).values & ((1 << 33) - 1)
    excl = torch.where(first, cin,
                       torch.cat([torch.zeros_like(incl[:1]), incl[:-1]]))
    anchor = torch.maximum(anchor, excl[:, None])
    interior = (pg >= istart[:, None]) & (pg >= w - 1) & (pg < iend[:, None])
    emit = interior & ((pg - anchor) % w == 0)
    return m, emit, pg, incl[-1:]


def scan_batches(codes, starts, lengths, k: int, w: int, stats=None):
    """The work-list minimizer scan of many sequences on ``codes``' device.

    codes: (N,) uint8 2-bit codes holding sequence i at [starts[i],
    starts[i] + lengths[i]) with its padding up to round16 inside the
    buffer (a GenomeStore's layout).  Yields one (m, emit, pos, rows) per
    batch: (B, P) int64 minima, bool emission and int64 global positions,
    and the batch's row range in ``work_list``.  The work list is uploaded
    once; each batch gathers its rows from ``codes`` and the anchor carry
    stays on the device, so a batch costs no host sync.  ``stats`` (a
    dict) gets the batch and row counts and the sequences per batch."""
    dev = codes.device
    halo = w + 1
    CL = row_len(k, w)
    seq, start, nvalid = work_list(lengths, k)
    off = np.maximum(start - halo, 0)
    meta = torch.from_numpy(np.stack([
        off, start, np.minimum(start + CHUNK, nvalid), nvalid,
        (start == 0).astype(np.int64),
        np.asarray(starts, np.int64)[seq] + off])).to(dev)
    n_rows = meta.shape[1]
    if stats is not None:
        n_batches = -(-n_rows // ROWS)
        stats.update(batches=stats.get("batches", 0) + n_batches,
                     rows=stats.get("rows", 0) + n_rows,
                     sequences_per_batch=len(lengths) / max(n_batches, 1))
    col = torch.arange(CL, dtype=torch.int64, device=dev)
    carry = torch.zeros(1, dtype=torch.int64, device=dev)
    last = max(codes.shape[0] - 1, 0)
    for b0 in range(0, n_rows, ROWS):
        off_, istart, iend, nv, new, gstart = meta[:, b0:b0 + ROWS]
        # the clamp only reaches positions past every scan range
        rows = codes[(gstart[:, None] + col).clamp_(max=last)]
        m, emit, pg, carry = _scan_rows(rows, off_, istart, iend, nv,
                                        new.bool(), carry, k, w)
        yield m, emit, (gstart - off_)[:, None] + pg, (b0, b0 + len(off_))


def _keys(m, emit, pos):
    """(B, P) scan outputs -> flat int64 keys hash << 32 | pos, SENTINEL
    where nothing is emitted (positions < 2^32, hashes < 2^30)."""
    return torch.where(emit, (m << 32) | pos, SENTINEL).reshape(-1)


def widen(positions):
    """Table positions (int32 bit patterns) -> int64 uint32 values."""
    return positions.to(torch.int64) & 0xFFFFFFFF


def _split(keys):
    """Sorted int64 keys -> (hashes int32, positions as int32 bits)."""
    return ((keys >> 32).to(torch.int32),
            (keys & 0xFFFFFFFF).to(torch.int32))


def _total(nems) -> int:
    """Seeds emitted, in exact host arithmetic (one fetch for the whole
    pass): a device int32 count would wrap at 2^31."""
    return int(torch.stack(nems).sum()) if nems else 0


def _refuse_past_int32(n: int, what: str):
    if n >= 1 << 31:
        raise ValueError(
            f"{n} seeds overflow a single int32-indexed {what}; an index "
            "this large needs the hash-sharded index of a multi-device run")


def host_pairs(codes, starts, lengths, k: int, w: int, stats=None):
    """Every emitted (hash, position) on the host: the scan on ``codes``'
    device, one fetch per batch.  Returns (hashes, positions) uint32
    numpy arrays in scan order."""
    hs, ps = [], []
    for m, emit, pos, _ in scan_batches(codes, starts, lengths, k, w, stats):
        hs.append(m[emit].cpu().numpy().astype(np.uint32))
        ps.append(pos[emit].cpu().numpy().astype(np.uint32))
    if not hs:
        return np.zeros(0, np.uint32), np.zeros(0, np.uint32)
    return np.concatenate(hs), np.concatenate(ps)


def sorted_pairs_device(codes, starts, lengths, k: int, w: int, stats=None):
    """All-candidates build (darwin_tpu's ``scan_sorted_pairs_device``):
    every scanned position's key (SENTINEL where none is emitted) is kept,
    then one sort; ~DEVICE_BYTES_PER_POSITION of device memory per scanned
    position.  Returns (sorted hashes, positions), int32 device tensors."""
    keys, nems = [], []
    for m, emit, pos, _ in scan_batches(codes, starts, lengths, k, w, stats):
        keys.append(_keys(m, emit, pos))
        nems.append(emit.sum())
    n = _total(nems)
    if not keys:
        return _split(torch.zeros(0, dtype=torch.int64, device=codes.device))
    key = torch.cat(keys)
    del keys
    return _split(torch.sort(key).values[:n])


def _sort_in_pieces(keys, k: int, stats=None):
    """Sort unique int64 keys (hash << 32 | pos) into the table's two int32
    arrays, SORT_PIECE keys at a time by hash range, so that torch.sort's
    outputs and workspace are a piece's, not the table's.  A bucket is
    never split, so one piece can hold more (``stats`` gets the number of
    pieces as ``sort_pieces`` and the largest one's key count as
    ``largest_piece``)."""
    n = keys.numel()
    dev = keys.device
    hashes = torch.empty(n, dtype=torch.int32, device=dev)
    positions = torch.empty(n, dtype=torch.int32, device=dev)
    bits = min(max(math.ceil(math.log2(max(n, 1) / SORT_PIECE)), 0), 2 * k)
    shift = 32 + 2 * k - bits
    at = largest = 0
    for j in range(1 << bits):
        sel = keys if bits == 0 else keys[(keys >= j << shift)
                                          & (keys < (j + 1) << shift)]
        h, p = _split(torch.sort(sel).values)
        hashes[at:at + len(h)] = h
        positions[at:at + len(h)] = p
        at += len(h)
        largest = max(largest, len(h))
        del sel, h, p
    if stats is not None:
        stats.update(sort_pieces=1 << bits, largest_piece=largest)
    return hashes, positions


def sorted_pairs_streaming(codes, starts, lengths, k: int, w: int, cap: int,
                           stats=None):
    """Streaming pairs build (darwin_tpu's ``scan_sorted_pairs_streaming``)
    for genomes past the all-candidates build's memory: each batch's
    emitted keys are compacted (a running count) into an accumulator of
    ``cap`` keys, 8 B per emitted seed, then sorted in hash-range pieces.
    Returns (sorted hashes, positions, n), or (None, None, -n) when the
    cap was too small (the caller retries larger; nothing is lost)."""
    dev = codes.device
    t0 = time.perf_counter()
    acc = torch.empty(cap + TRASH, dtype=torch.int64, device=dev)
    woff = torch.zeros(1, dtype=torch.int64, device=dev)
    nems = []
    for m, emit, pos, _ in scan_batches(codes, starts, lengths, k, w, stats):
        e = emit.reshape(-1)
        dst = woff + torch.cumsum(e, 0) - 1
        sink = cap + (torch.arange(e.numel(), device=dev) & (TRASH - 1))
        acc[torch.where(e & (dst < cap), dst, sink)] = _keys(m, emit, pos)
        nem = e.sum()
        woff += nem
        nems.append(nem)
    n = _total(nems)
    _refuse_past_int32(n, "pair table")
    if stats is not None:
        stats["scan_pass_s"] = time.perf_counter() - t0
    if n > cap:
        return None, None, -n
    sh, sp = _sort_in_pieces(acc[:n], k, stats)
    del acc
    return sh, sp, n


def build_csr(codes, starts, lengths, k: int, w: int, stats=None):
    """Streaming csr build (darwin_tpu's ``build_csr_streaming``): two
    passes over the work list.  Count: a scatter-add of each emitted hash
    into (4^k) int32 counts.  Fill: each batch's keys sorted, a seed's
    rank within its hash's run added to that bucket's cursor gives its
    slot; batches ascend in position, so every bucket ends up
    position-ascending.  Returns (offsets (4^k + 1,) int32, positions (n,)
    int32 bits, n)."""
    if 2 * k > 28:
        raise ValueError("csr bucket array gated at 4^14 entries (1 GiB)")
    dev = codes.device
    nb = 1 << (2 * k)
    t0 = time.perf_counter()
    counts = torch.zeros(nb + TRASH, dtype=torch.int32, device=dev)
    nems = []
    one = torch.ones(1, dtype=torch.int32, device=dev)
    for m, emit, _pos, _ in scan_batches(codes, starts, lengths, k, w, stats):
        e = emit.reshape(-1)
        sink = nb + (torch.arange(e.numel(), device=dev) & (TRASH - 1))
        counts.index_add_(0, torch.where(e, m.reshape(-1), sink),
                          one.expand(e.numel()))
        nems.append(e.sum())
    n = _total(nems)
    if stats is not None:
        stats["count_pass_s"] = time.perf_counter() - t0
    _refuse_past_int32(n, "csr table")
    offsets = torch.zeros(nb + 1, dtype=torch.int32, device=dev)
    # n < 2^31, so the int64 running sum fits int32 exactly
    offsets[1:] = torch.cumsum(counts[:nb], 0)
    del counts
    cursor = torch.cat([offsets[:nb],
                        torch.zeros(TRASH, dtype=torch.int32, device=dev)])
    posbuf = torch.empty(n + TRASH, dtype=torch.int32, device=dev)
    for m, emit, pos, _ in scan_batches(codes, starts, lengths, k, w):
        s = torch.sort(_keys(m, emit, pos)).values
        i = torch.arange(s.numel(), device=dev)
        sink = i & (TRASH - 1)
        valid = s != SENTINEL
        hs = s >> 32                    # SENTINEL's is no real hash
        head = torch.ones_like(valid)
        head[1:] = hs[1:] != hs[:-1]
        tail = torch.ones_like(valid)
        tail[:-1] = head[1:]
        h = torch.where(valid, hs, 0)
        rank = i - torch.cummax(torch.where(head, i, 0), 0).values
        slot = cursor[h] + rank
        posbuf[torch.where(valid, slot, n + sink)] = (
            s & 0xFFFFFFFF).to(torch.int32)
        # the last seed of a run moves its bucket's cursor past the run
        # (one write per bucket, no atomics)
        cursor[torch.where(valid & tail, h, nb + sink)] = (
            slot + 1).to(torch.int32)
    del cursor
    return offsets, posbuf[:n], n
