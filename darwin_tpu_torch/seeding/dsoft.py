"""D-SOFT seeding on device (counterpart of ``darwin_tpu/seeding/dsoft.py``;
SeedPosTable::DSOFT, software/seed_pos_table.cpp:252-553).

1. minimizer scan of each query row and the stride schedule over the
   minimizer ordinal (the first num_seeds + 2 queried, then every
   max_stride-th in reference-guided mode, none in overlap mode);
2. bucket ranges by ``torch.searchsorted`` in a pairs table (darwin_tpu's
   prefix LUT only accelerates the same bisect) or two gathers of a csr
   table's bucket offsets, buckets over ``max_occ`` skipped;
3. hits packed ragged-flat, kept when hit >= query offset, binned by
   (hit - offset) // bin_size;
4. a stable sort by (bin, offset), the per-bin unique-base count with one
   anchor per bin at the threshold crossing, and pruning of hits to the
   union of anchor bin windows (chaining reads nothing else).

Bins and positions are int64 (darwin_tpu: uint32); the all-ones uint32
value stays the "no bin" sentinel.  Chaining runs on the host
(seeding/chain.py).
"""

from __future__ import annotations

import torch

from darwin_tpu_torch.index.minimizers import minimizer_scan, widen

I32MAX = 2**31 - 1
NO_BIN = 0xFFFFFFFF            # unreachable by valid bins (pos < 2^32 - 1)


def mq_cap_for(pcap: int, num_seeds: int, max_stride: int,
               overlap: bool) -> int:
    """Bound on the number of queried minimizers of a row with pcap scan
    positions (darwin_tpu/seeding/dsoft.py:38-44)."""
    base = num_seeds + 2
    if overlap:
        return min(pcap, base)
    return min(pcap,
               base + (max(pcap - base, 0) + max_stride - 1) // max_stride)


def sv_bins(bin_size: int, overlap: bool) -> int:
    """Chaining's bin half-window (software/seed_pos_table.cpp:394,409)."""
    return 1 if overlap else (1 << 12) // bin_size


def _queried_minimizers(codes2, lengths, k, w, num_seeds, max_stride,
                        overlap, mq_cap):
    """Minimizer scan + stride schedule + compaction: (offs, qhash,
    slot_ok), each (B, mq_cap); empty slots hold I32MAX / 0 / False."""
    B = codes2.shape[0]
    dev = codes2.device
    m, emit = minimizer_scan(codes2, lengths, k, w)
    P = m.shape[1]
    ordinal = torch.cumsum(emit.to(torch.int64), 1) - 1
    q_rule = ordinal <= num_seeds + 1
    if not overlap:
        q_rule = q_rule | ((ordinal - (num_seeds + 1)) % max_stride == 0)
    queried = emit & q_rule
    qord = torch.cumsum(queried.to(torch.int64), 1) - 1
    # each queried minimizer lands in its own slot; the rest go to a
    # trash column that is sliced off
    tgt = torch.where(queried & (qord < mq_cap), qord, mq_cap)
    p_idx = torch.arange(P, dtype=torch.int64, device=dev).expand(B, P)
    offs = torch.full((B, mq_cap + 1), I32MAX, dtype=torch.int64,
                      device=dev).scatter_(1, tgt, p_idx)[:, :mq_cap]
    qhash = torch.zeros((B, mq_cap + 1), dtype=torch.int64,
                        device=dev).scatter_(1, tgt, m)[:, :mq_cap]
    return offs, qhash, offs < I32MAX


def _bucket_ranges(sorted_hashes, qhash, bucket_offsets=None):
    """(start, end) table ranges per queried hash: two gathers of the
    csr offsets (darwin_tpu/seeding/dsoft.py:106-112), else two searches
    of the pairs table's hashes (queried in their dtype, so the table is
    never converted)."""
    if bucket_offsets is not None:
        return (bucket_offsets[qhash].to(torch.int64),
                bucket_offsets[qhash + 1].to(torch.int64))
    q = qhash.to(sorted_hashes.dtype)
    start = torch.searchsorted(sorted_hashes, q, side="left")
    end = torch.searchsorted(sorted_hashes, q, side="right")
    return start, end


def _bucket_hits_flat(positions, offs, start, end, cnt_global, slot_ok,
                      max_occ, bin_size, hit_cap):
    """Hits of the usable buckets packed ragged-flat into (B, hit_cap)
    slots in (minimizer, in-bucket) order (darwin_tpu/seeding/dsoft.py:
    130-188).  A bucket is usable when its ``cnt_global`` — its size in the
    whole table: ``end - start`` on one device, the sum over the shards of
    a sharded table — is within max_occ.  Returns (bin, off, pos,
    bucket_ok, total); slots past a row's ``total`` or failing hit >=
    offset carry bin NO_BIN.  Rows with total > hit_cap lose hits: the
    caller sizes hit_cap from dsoft_count."""
    B, mq = offs.shape
    dev = offs.device
    cnt = end - start
    bucket_ok = slot_ok & (cnt_global <= max_occ)
    cnt_eff = torch.where(bucket_ok, cnt, 0)
    cum = torch.cumsum(cnt_eff, 1)
    sflat = cum - cnt_eff                        # first slot of each bucket
    total = cum[:, -1]
    # slot -> bucket: tick each non-empty bucket's ordinal at its first
    # slot, then a running max over slots
    bord = torch.arange(mq, dtype=torch.int64, device=dev).expand(B, mq)
    mark = torch.where((cnt_eff > 0) & (sflat < hit_cap), sflat, hit_cap)
    ticks = torch.zeros((B, hit_cap + 1), dtype=torch.int64, device=dev)
    ticks.scatter_reduce_(1, mark, bord + 1, reduce="amax")
    bidx = torch.cummax(ticks[:, :hit_cap], 1).values - 1
    j = torch.arange(hit_cap, dtype=torch.int64, device=dev)[None, :]
    bsafe = bidx.clamp(0, mq - 1)
    sf = torch.gather(sflat, 1, bsafe)
    st = torch.gather(start, 1, bsafe)
    of = torch.gather(offs, 1, bsafe)
    ok_slot = (bidx >= 0) & (j < total[:, None])
    n = positions.shape[0]
    gidx = (st + (j - sf)).clamp(0, max(n - 1, 0))
    pos = widen(positions[gidx]) if n else torch.zeros_like(gidx)
    hit_ok = ok_slot & (pos >= of)
    binf = torch.where(hit_ok, torch.div(pos - of, bin_size,
                                         rounding_mode="floor"), NO_BIN)
    return binf, of, pos, bucket_ok, total


def _hits_post(binf, offf, posf, n_queried_buckets, k, threshold, a_cap,
               sv):
    """Stable (bin, offset) sort, per-bin unique-base count, anchor
    compaction and hit pruning (darwin_tpu/seeding/dsoft.py:198-288)."""
    B, H = binf.shape
    dev = binf.device
    # offsets are < 2^31, so (bin << 31) | off orders like the (bin, off)
    # pair and NO_BIN keys stay below 2^63; stable keeps insertion order
    key = (binf << 31) | offf
    order = torch.sort(key, dim=1, stable=True).indices
    sbin = torch.gather(binf, 1, order)
    soff = torch.gather(offf, 1, order)
    spos = torch.gather(posf, 1, order)

    # per-bin counting (software/seed_pos_table.cpp:352-389)
    prev_bin = torch.cat([torch.full((B, 1), NO_BIN, dtype=torch.int64,
                                     device=dev), sbin[:, :-1]], 1)
    prev_off = torch.cat([torch.zeros((B, 1), dtype=torch.int64,
                                      device=dev), soff[:, :-1]], 1)
    valid = sbin != NO_BIN
    first = valid & (sbin != prev_bin)
    inc = torch.where(first, k, torch.clamp(soff - prev_off, max=k)) * valid
    c = torch.cumsum(inc, 1)
    base = torch.cummax(torch.where(first, c - inc, 0), 1).values
    s = c - base
    cross = valid & (s >= threshold) & ((s - inc) < threshold)

    # anchors in bin order, each crossing slot scattered to its dense rank
    ac = min(a_cap, H)
    acum = torch.cumsum(cross.to(torch.int64), 1) - 1
    atgt = torch.where(cross & (acum < ac), acum, ac)
    apos = torch.zeros((B, ac + 1), dtype=torch.int64,
                       device=dev).scatter_(1, atgt, spos)[:, :ac]
    aoff = torch.zeros((B, ac + 1), dtype=torch.int64,
                       device=dev).scatter_(1, atgt, soff)[:, :ac]
    abin = torch.full((B, ac + 1), NO_BIN, dtype=torch.int64,
                      device=dev).scatter_(1, atgt, sbin)[:, :ac]
    n_anchors = cross.sum(1)

    # keep a hit iff some anchor bin lies in (bin - sv, bin + sv]
    # (chain.chain_anchors reads hits in [anchor - sv, anchor + sv));
    # the upper edge saturates below NO_BIN, as darwin_tpu's uint32 does
    qlo = torch.clamp(sbin + 1 - sv, min=0)
    jx = torch.searchsorted(abin.contiguous(), qlo.contiguous(),
                            side="left")
    aj = torch.gather(abin, 1, jx.clamp(max=ac - 1))
    needed = valid & (aj <= torch.clamp(sbin + sv, max=NO_BIN - 1))
    pcum = torch.cumsum(needed.to(torch.int64), 1) - 1
    ptgt = torch.where(needed, pcum, H)
    pbin = torch.full((B, H + 1), NO_BIN, dtype=torch.int64,
                      device=dev).scatter_(1, ptgt, sbin)[:, :H]
    poff = torch.zeros((B, H + 1), dtype=torch.int64,
                       device=dev).scatter_(1, ptgt, soff)[:, :H]
    ppos = torch.zeros((B, H + 1), dtype=torch.int64,
                       device=dev).scatter_(1, ptgt, spos)[:, :H]
    n_kept = needed.sum(1)
    return {"hits_bin": pbin, "hits_off": poff, "hits_pos": ppos,
            "n_hits": n_kept, "anc_pos": apos, "anc_off": aoff,
            "anc_bin": abin, "n_anchors": torch.clamp(n_anchors, max=ac),
            "n_anchors_raw": n_anchors,
            "n_queried_buckets": n_queried_buckets}


def dsoft_count(codes2, lengths, sorted_hashes, *, k, w, num_seeds,
                max_stride, overlap, max_occ, mq_cap, bucket_offsets=None):
    """Exact hit-slot count per row (B,) — the sizing pre-pass: scan +
    bucket ranges only, no hit gather or sort."""
    offs, qhash, slot_ok = _queried_minimizers(
        codes2, lengths, k, w, num_seeds, max_stride, overlap, mq_cap)
    start, end = _bucket_ranges(sorted_hashes, qhash.contiguous(),
                                bucket_offsets)
    cnt = end - start
    return torch.where(slot_ok & (cnt <= max_occ), cnt, 0).sum(1)


def dsoft_device(codes2, lengths, sorted_hashes, positions, *, k, w,
                 num_seeds, max_stride, overlap, threshold, bin_size,
                 max_occ, mq_cap, a_cap, hit_cap, bucket_offsets=None):
    """Batched D-SOFT hit generation + anchor selection.

    codes2 (B, Lcap) uint8 2-bit query codes (0-padded rows, Lcap a
    multiple of 16); lengths (B,); sorted_hashes / positions: the
    SeedTable arrays (a csr table passes its bucket_offsets and None for
    sorted_hashes).  hit_cap: flat hit-slot width (dsoft_count gives the
    exact need); a_cap: anchor slots (anchors beyond it are dropped).

    Returns a dict of device tensors: hits_bin/hits_off/hits_pos (B, H)
    pruned hits sorted by (bin, offset), n_hits; anc_pos/anc_off/anc_bin
    (B, min(a_cap, H)) anchors in bin order, n_anchors (capped),
    n_anchors_raw; n_queried_buckets, n_flat_raw (slots needed) and
    n_capped (queried buckets over max_occ), each (B,)."""
    offs, qhash, slot_ok = _queried_minimizers(
        codes2, lengths, k, w, num_seeds, max_stride, overlap, mq_cap)
    start, end = _bucket_ranges(sorted_hashes, qhash.contiguous(),
                                bucket_offsets)
    binf, offf, posf, bucket_ok, total = _bucket_hits_flat(
        positions, offs, start, end, end - start, slot_ok, max_occ,
        bin_size, hit_cap)
    res = _hits_post(binf, offf, posf, bucket_ok.sum(1), k, threshold,
                     a_cap, sv_bins(bin_size, overlap))
    res["n_flat_raw"] = total
    res["n_capped"] = (slot_ok & ((end - start) > max_occ)).sum(1)
    return res
