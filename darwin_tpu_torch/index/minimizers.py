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
``hash32`` is exact in int64 once masked.  darwin_tpu's fixed-shape chunked
genome scan exists for XLA's static shapes; PyTorch scans a chromosome in
one call.
"""

from __future__ import annotations

import torch


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
    h = kmer_hashes(codes2, k)
    P = h.shape[1]
    m = h
    big = torch.full((B, w), 0xFFFFFFFF, dtype=torch.int64, device=dev)
    for d in range(1, w):
        m = torch.minimum(m, torch.cat([big[:, :d], h[:, :P - d]], 1))
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


def scan_sequence(codes2, length_unpadded: int, k: int, w: int):
    """Minimizers of one sequence: codes2 (L,) uint8 2-bit codes covering
    at least round16(length_unpadded) bases (the genome store pads every
    chromosome with 'N' = code 0 to a multiple of 128).  Returns
    (positions, hashes) int64 device tensors, positions local."""
    r16 = (length_unpadded + 15) // 16 * 16
    row = codes2[:r16][None, :]
    lengths = torch.tensor([length_unpadded], device=codes2.device)
    m, emit = minimizer_scan(row, lengths, k, w)
    pos = torch.nonzero(emit[0]).squeeze(1)
    return pos, m[0, pos]
