"""Plain reference of Darwin's long-read aligner (Turakhia et al., ASPLOS
2018; the reference software's main.cpp, seed_pos_table.cpp, filter.cpp,
extender.cpp and printer.cpp, as ``darwin_tpu`` transcribes them), for the
benchmark's check of the records the program prints.

It aligns a few reads one stage after another, with none of the program's
batching, speculation, streams or kernels: a (w,k)-minimizer index of the
genome, D-SOFT seeding and chaining, first-tile filtering with the slope
filter, GACT extension tile by tile (``gact.tile_dp`` and ``gact.walk``,
batched over the live extensions only to save time), and SAM or MHAP
records with the printer's secondary suppression and overlap selection.
Darwin's own quirks that shape the output are kept, each where it applies.

It reads only the genome and the reads, as the benchmark generated them.
"""

from __future__ import annotations

import multiprocessing
import os

import numpy as np

from benchmark.reference import gact

# software/params.cfg, the default Darwin runs with
PARAMS = {
    "sub": (2, -6, -6, -6, 2, -6, -6, 2, -6, 2, -1),   # AA AC AG AT CC CG
    "gap_open": -4, "gap_extend": -2,                   # CT GG GT TT N
    "long_gap_open": -25, "long_gap_extend": -1,
    "seed_size": 14, "minimizer_window": 3, "bin_size": 64,
    "dsoft_threshold": 26, "num_seeds": 1000, "seed_occurence_multiple": 40,
    "max_stride": 4, "first_tile_size": 128,
    "first_tile_score_threshold": 60, "slope_threshold": 0.05,
    "min_overlap": 1000, "tile_size": 384, "tile_overlap": 64,
    "batch_size": 2, "large_tile_long": 1984, "large_tile_short": 960,
}
EXT_PER_JOB = 4     # extensions a worker process takes at a time
WORD = 128          # chromosome padding and leading guard (software/DRAM.h)
MIN_LEN = 64        # sequences of this length or less are skipped

_CODE5 = np.full(256, 4, np.int64)
_CODE2 = np.zeros(256, np.int64)
for _i, _c in enumerate(b"ACGT"):
    _CODE5[_c] = _CODE5[_c + 32] = _i
    _CODE2[_c] = _CODE2[_c + 32] = _i
_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTNacgtn", b"TGCANtgcan"):
    _COMP[_a] = _b
_N = ord("N")
_DASH = ord("-")


def sub_5x5(s):
    aa, ac, ag, at, cc, cg, ct, gg, gt, tt, n = s
    return ((aa, ac, ag, at, n), (ac, cc, cg, ct, n), (ag, cg, gg, gt, n),
            (at, ct, gt, tt, n), (n, n, n, n, n))


class Genome:
    """Chromosomes laid end to end after a WORD-base 'N' guard, each padded
    with 'N' to a multiple of WORD: Darwin's coordinate space."""

    def __init__(self, chroms, margin: int):
        self.names, self.starts, self.lens, self.raw_lens = [], [], [], []
        parts = [np.full(WORD, _N, np.uint8)]
        pos = WORD
        for name, seq in chroms:
            if len(seq) <= MIN_LEN:
                continue
            padded = -(-len(seq) // WORD) * WORD
            parts += [seq, np.full(padded - len(seq), _N, np.uint8)]
            self.names.append(name)
            self.starts.append(pos)
            self.lens.append(padded)
            self.raw_lens.append(len(seq))
            pos += padded
        self.size = pos
        self.bases = np.concatenate(parts + [np.full(margin, _N, np.uint8)])
        self.codes = _CODE5[self.bases].astype(np.uint8)
        self.start_arr = np.array(self.starts, np.int64)

    def chrom_of(self, coord: int) -> int:
        return int(np.searchsorted(self.start_arr, coord, side="right")) - 1


def _hash32(key, k):
    """software/ntcoding.h's invertible hash, masked to 2k bits."""
    m = (1 << (2 * k)) - 1
    key = (~key + (key << 21)) & m
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & m
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & m
    key = key ^ (key >> 28)
    return (key + (key << 31)) & m


def minimizers(seqs, k: int, w: int, device):
    """The (w,k)-minimizers that Darwin emits in each of ``seqs`` (ASCII
    uint8): k-mers packed little-endian from 2-bit codes (N as A), scanned
    up to the length rounded up to 16; m[p] the least hash of the k-mers
    starting in [p-w+1, p]; (p, m[p]) emitted when m[p] differs from the
    last emitted minimizer or p is w past it.  Returns (sequence index,
    position, hash) int64 arrays in sequence and position order.  In
    torch, on ``device``: a genome's scan is one pass over all of it."""
    import torch
    lens = np.array([-(-len(s) // 16) * 16 for s in seqs], np.int64)
    starts = np.concatenate(([0], np.cumsum(lens)))
    buf = np.zeros(int(starts[-1]) + k, np.int64)
    for s, st in zip(seqs, starts):
        buf[st:st + len(s)] = _CODE2[s]
    c = torch.from_numpy(buf).to(device)
    n = int(starts[-1])
    kmer = torch.zeros(n, dtype=torch.int64, device=device)
    for i in range(k):
        kmer |= c[i:i + n] << (2 * i)
    h = _hash32(kmer, k)
    big = torch.full((w,), 1 << 40, dtype=torch.int64, device=device)
    m = h
    for d in range(1, w):
        m = torch.minimum(m, torch.cat([big[:d], h[:n - d]]))
    sid = torch.repeat_interleave(
        torch.arange(len(seqs), device=device),
        torch.from_numpy(lens).to(device))
    p = torch.arange(n, device=device)
    s0 = torch.from_numpy(starts[:-1]).to(device)[sid]
    local = p - s0
    prev = torch.cat([m[:1] * 0, m[:-1]])
    change = (local >= w - 1) & (m != torch.where(local == w - 1, 0, prev))
    anchor = torch.cummax(torch.where(change, p, s0), 0).values
    ln = torch.from_numpy(lens).to(device)[sid]
    emit = ((local >= w - 1) & (local < ln - k)
            & ((p - anchor) % w == 0))
    return (sid[emit].cpu().numpy(), local[emit].cpu().numpy(),
            m[emit].cpu().numpy())


class Index:
    """The genome's seed table: every emitted minimizer's absolute
    position, sorted by (hash, position)."""

    def __init__(self, genome: Genome, P, device):
        k, w = P["seed_size"], P["minimizer_window"]
        seqs = [genome.bases[s:s + n] for s, n in
                zip(genome.starts, genome.raw_lens)]
        sid, pos, hsh = minimizers(seqs, k, w, device)
        pos = pos + genome.start_arr[sid]
        order = np.lexsort((pos, hsh))
        self.hashes, self.positions = hsh[order], pos[order]
        self.max_occ = P["seed_occurence_multiple"] * (
            1 + (genome.size >> (2 * k)))


def dsoft(seq, index: Index, P, overlap: bool, device):
    """D-SOFT (seed_pos_table.cpp's DSOFT) for one strand of a read: the
    anchors, chained, best first.  Each anchor is (hit, offset, chained
    hits) with hits as (position << 32) | offset."""
    k, bs = P["seed_size"], P["bin_size"]
    _, off, hsh = minimizers([seq], k, P["minimizer_window"], device)
    nq = P["num_seeds"]
    ordn = np.arange(len(off))
    q = ordn <= nq + 1
    if not overlap:
        q |= (ordn - (nq + 1)) % P["max_stride"] == 0
    off, hsh = off[q], hsh[q]
    lo = np.searchsorted(index.hashes, hsh, "left")
    hi = np.searchsorted(index.hashes, hsh, "right")
    use = (hi - lo) <= index.max_occ
    cnt = np.where(use, hi - lo, 0)
    first = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt)
    gidx = first + np.arange(int(cnt.sum()))
    hoff = np.repeat(off, cnt)
    hpos = index.positions[gidx]
    keep = hpos >= hoff
    hoff, hpos = hoff[keep], hpos[keep]
    hbin = (hpos - hoff) // bs
    order = np.lexsort((hoff, hbin))            # stable: insertion order
    hbin, hoff, hpos = hbin[order], hoff[order], hpos[order]
    if len(hbin) == 0:
        return []
    # per bin: k for its first hit, then min(offset step, k) per hit; an
    # anchor where the sum first reaches the threshold
    newb = np.concatenate(([True], hbin[1:] != hbin[:-1]))
    step = np.concatenate(([0], np.diff(hoff)))
    inc = np.where(newb, k, np.minimum(step, k))
    csum = np.cumsum(inc)
    base = np.maximum.accumulate(np.where(newb, csum - inc, 0))
    s = csum - base
    thr = P["dsoft_threshold"]
    cross = np.flatnonzero((s >= thr) & (s - inc < thr))
    return chain(hbin, hoff, hpos, cross, 1 if overlap else 4096 // bs)


def chain(hbin, hoff, hpos, anchors, sv: int):
    """Chaining (seed_pos_table.cpp:394-510) around each anchor over the
    hits within sv bins of it; anchors ordered by chain length, then by
    (hit, offset)."""
    keys = (hpos.astype(np.uint64) << np.uint64(32)) | hoff.astype(np.uint64)
    out = []
    for a in anchors:
        b = int(hbin[a])
        akey = int(keys[a])
        lo = np.searchsorted(hbin, b - sv, "left")
        hi = np.searchsorted(hbin, b + sv, "left")
        win = keys[lo:hi]
        left = np.sort(win[win <= akey])
        right = np.sort(win[win >= akey])
        kept = [int(left[-1])]
        for cand in left[-2::-1].tolist():
            cur = kept[-1]
            if cur >> 32 >= cand >> 32 and cur & 0xFFFFFFFF >= cand & 0xFFFFFFFF:
                kept.append(cand)
        lchain = np.sort(np.array(kept, np.uint64))
        kept = [int(right[0])]
        for cand in right[1:].tolist():
            cur = kept[-1]
            if cur >> 32 <= cand >> 32 and cur & 0xFFFFFFFF <= cand & 0xFFFFFFFF:
                kept.append(cand)
        rchain = np.array(kept, np.uint64)[::-1].copy()
        out.append((int(hpos[a]), int(hoff[a]), lchain, rchain,
                    len(lchain) + len(rchain)))
    out.sort(key=lambda x: (-x[4], (x[0] << 32) | x[1]))
    return out


class Read:
    def __init__(self, name, seq):
        self.name = name
        self.seq = seq
        self.rc = _COMP[seq[::-1]]
        self.len = len(seq)

    def strand(self, s):
        return self.seq if s == "+" else self.rc


class Ext:
    """One GACT extension (extender.cpp's ExtendAlignments): left from the
    first tile's best cell tile by tile, then right, large tiles where a
    standard tile made no progress but chained hits remain."""

    def __init__(self, read, strand, ci, genome, rpos, qpos, lh, rh):
        self.read, self.strand, self.ci = read, strand, ci
        self.qseq = read.strand(strand)
        self.addr = genome.starts[ci]
        self.ref_len = genome.lens[ci]
        self.q_len = read.len
        self.cr = rpos - self.addr
        self.cq = qpos
        self.rs_off = self.re_off = self.cr
        self.qs_off = self.qe_off = self.cq
        self.left_done = self.right_done = self.large = False
        self.lh, self.rh = lh, rh
        self.lparts, self.rparts = [], []
        self.tiles = 0
        self.rec = None

    def _large(self, left, P):
        hit = int((self.lh if left else self.rh)[-1])
        h1, o1 = self.addr + self.cr, self.cq
        h2, o2 = hit >> 32, hit & 0xFFFFFFFF
        big_ref = (h1 - h2) > (o1 - o2) if left else (h2 - h1) > (o2 - o1)
        L, S = P["large_tile_long"], P["large_tile_short"]
        return (L, S) if big_ref else (S, L)

    def request(self, P):
        """(ref start, ref size, query start, query size, reversed, shape)
        of the next tile."""
        T = P["tile_size"]
        left = not self.left_done
        rt, qt = self._large(left, P) if self.large else (T, T)
        if left:
            r_size, q_size = min(self.cr + 1, rt), min(self.cq + 1, qt)
            r0 = self.addr + (self.cr - rt + 1 if self.cr >= rt else 0)
            q0 = self.cq - qt + 1 if self.cq >= qt else 0
            return r0, r_size, q0, q_size, False, (rt, qt)
        r_size = min(self.ref_len - self.cr, rt)
        q_size = min(self.q_len - self.cq, qt)
        return self.addr + self.cr, r_size, self.cq, q_size, True, (rt, qt)

    def apply(self, ops, bases, P, overlap):
        """Consume one tile's traceback; True once the extension ends."""
        left = not self.left_done
        T = P["tile_size"]
        rt, qt = (self._large(left, P) if self.large and not overlap
                  else (T, T))
        stop = min(rt, qt) - P["tile_overlap"]
        n_total = len(ops)
        self.tiles += 1
        # past ``stop`` steps, each 32-op word is consumed up to its first
        # M only (extender.cpp's break leaves the word loop alone)
        kept, count = [], 0
        for t in range(0, len(ops), 32):
            blk = ops[t:t + 32]
            idx = np.flatnonzero((count + np.arange(1, len(blk) + 1) >= stop)
                                 & (blk == gact.OP_M))
            if len(idx):
                blk = blk[:idx[0] + 1]
            kept.append(blk)
            count += len(blk)
        a = np.concatenate(kept) if kept else ops[:0]
        rc = a != gact.OP_I
        qc = a != gact.OP_D
        k_r = np.cumsum(rc) - rc
        k_q = np.cumsum(qc) - qc
        n_r, n_q = int(rc.sum()), int(qc.sum())
        qpad = np.concatenate([self.qseq, np.full(1, _N, np.uint8)])
        if left:
            pr = np.maximum(self.cr - k_r, 0)
            pq = np.maximum(self.cq - k_q, 0)
            rch = np.where(rc, bases[self.addr + pr], _DASH)
            qch = np.where(qc, qpad[pq], _DASH)
            self.lparts.append((rch[::-1], qch[::-1]))
            if n_r >= self.cr + 1:
                self.rs_off = 0
            if n_q >= self.cq + 1:
                self.qs_off = 0
            self.cr = max(self.cr - n_r, 0)
            self.cq = max(self.cq - n_q, 0)
            return self._after_left(n_total)
        pr = np.minimum(self.cr + k_r, self.ref_len)
        pq = np.minimum(self.cq + k_q, self.q_len)
        rch = np.where(rc, bases[self.addr + pr], _DASH)
        qch = np.where(qc, qpad[pq], _DASH)
        self.rparts.append((rch, qch))
        self.cr = min(self.cr + n_r, self.ref_len)
        self.cq = min(self.cq + n_q, self.q_len)
        return self._after_right(n_total)

    def _after_left(self, n_total):
        if len(self.lh):
            x = self.addr + self.cr
            h = (self.lh >> np.uint64(32)).astype(np.int64)
            o = (self.lh & np.uint64(0xFFFFFFFF)).astype(np.int64)
            good = np.flatnonzero((h < x) & (o < self.cq))
            self.lh = self.lh[:good[-1] + 1] if len(good) else self.lh[:0]
        at_bound = self.rs_off == 0 or self.qs_off == 0
        no_hits = len(self.lh) == 0
        outer = n_total == 0 or at_bound
        if self.strand == "+":
            outer = outer or no_hits       # forward strand only
        if not outer:
            self.large = False
            return False
        if not (self.large or no_hits or at_bound):
            self.large = True
            return False
        self.left_done = True
        if self.rs_off > 0:
            self.rs_off = self.cr + 1
        if self.qs_off > 0:
            self.qs_off = self.cq + 1
        if (self.cr + 1 < self.ref_len and self.cq + 1 < self.q_len
                and not self.right_done):
            self.cr = self.re_off + 1
            self.cq = self.qe_off + 1
            return False
        self.right_done = True
        if self.strand == "-":             # the forward strand prints none
            self._emit()
        return True

    def _after_right(self, n_total):
        if len(self.rh):
            x = self.addr + self.cr
            h = (self.rh >> np.uint64(32)).astype(np.int64)
            o = (self.rh & np.uint64(0xFFFFFFFF)).astype(np.int64)
            good = np.flatnonzero((h > x) & (o > self.cq))
            self.rh = self.rh[:good[-1] + 1] if len(good) else self.rh[:0]
        at_end = self.cr == self.ref_len or self.cq == self.q_len
        if n_total == 0 or at_end:
            if self.large or len(self.rh) == 0 or at_end:
                self.re_off = self.cr - 1
                self.qe_off = self.cq - 1
                self._emit()
                self.right_done = True
                return True
            self.large = True
            return False
        self.large = False
        return False

    def _emit(self):
        parts = [p for p in reversed(self.lparts)] + self.rparts
        ar = np.concatenate([p[0] for p in parts]).astype(np.uint8) \
            if parts else np.zeros(0, np.uint8)
        aq = np.concatenate([p[1] for p in parts]).astype(np.uint8) \
            if parts else np.zeros(0, np.uint8)
        self.rec = (ar, aq)


def score_of(ar, aq, P):
    """extender.cpp's AlignmentScore: substitutions plus, per gap run
    closed by a non-gap column, the better of the two gap costs; a run at
    the very end is not counted."""
    sub = np.array(sub_5x5(P["sub"]), np.int64)
    gap = (ar == _DASH) | (aq == _DASH)
    score = int(sub[_CODE5[aq[~gap]], _CODE5[ar[~gap]]].sum())
    n = len(ar)
    g = gap.astype(np.int8)
    starts = np.flatnonzero((g == 1) & (np.concatenate(([0], g[:-1])) == 0))
    ends = np.flatnonzero((g == 1) & (np.concatenate((g[1:], [0])) == 0))
    for s, e in zip(starts, ends):
        if e == n - 1:
            continue
        ln = e - s + 1
        score += max(P["gap_open"] + (ln - 1) * P["gap_extend"],
                     P["long_gap_open"] + (ln - 1) * P["long_gap_extend"])
    return score


def emission_order(tiles, width):
    """The order in which Darwin's ``width``-slot extender completes
    extensions taking ``tiles`` tiles each, slots refilled in turn."""
    n = len(tiles)
    width = min(n, width)
    slot = list(range(width))
    left = [tiles[i] for i in slot]
    nxt, order = width, []
    while len(order) < n:
        for s in range(width):
            if slot[s] is None:
                continue
            left[s] -= 1
            if left[s] == 0:
                order.append(slot[s])
                if nxt < n:
                    slot[s], left[s] = nxt, tiles[nxt]
                    nxt += 1
                else:
                    slot[s] = None
    return order


class Reference:
    """Darwin on ``chroms`` ([(name, ASCII uint8)]), reference-guided
    (SAM) or, with ``overlap``, the reads against the read set ``chroms``
    (MHAP).  ``bits`` < 32 saturates the tile DP (the benchmark's
    control)."""

    def __init__(self, chroms, overlap: bool, device, bits: int = 32,
                 params=None):
        self.P = dict(PARAMS, **(params or {}))
        self.overlap = overlap
        self.device = device
        self.bits = bits
        self.genome = Genome(chroms, 4 * self.P["large_tile_long"])
        self.index = Index(self.genome, self.P, self.device)
        P = self.P
        self.scoring = (sub_5x5(P["sub"]), P["gap_open"], P["gap_extend"],
                        P["long_gap_open"], P["long_gap_extend"])

    def _filter(self, reads):
        """First tiles of every anchor, both strands: the locations that
        pass the score threshold, the overlap test and the slope filter,
        per (read, strand)."""
        P, g = self.P, self.genome
        T = P["first_tile_size"]
        items = []
        for ri, rd in enumerate(reads):
            for strand in "+-":
                for hit, off, lh, rh, _ in dsoft(rd.strand(strand), self.index,
                                                 P, self.overlap, self.device):
                    ci = g.chrom_of(hit)
                    end = g.starts[ci] + g.lens[ci]
                    rts = hit if hit + T < end else (end - T if end > T else 0)
                    qts = (off if off + T < rd.len
                           else (rd.len - T if rd.len > T else 0))
                    items.append((ri, strand, ci, hit, off, lh, rh, rts, qts,
                                  (rts, min(T, g.lens[ci]), qts,
                                   min(T, rd.len), False, (T, T))))
        locs = {(ri, s): [] for ri in range(len(reads)) for s in "+-"}
        if not items:
            return locs
        reqs = [it[9] for it in items]
        Q, R = tiles(g.codes, reqs, [reads[it[0]].strand(it[1])
                                     for it in items])
        H = gact.tile_dp(Q, R, self.scoring, False, self.bits)
        best, qm, rm = gact.max_cell(H, np.array([r[3] for r in reqs]),
                                     np.array([r[1] for r in reqs]))
        for (ri, strand, ci, hit, off, lh, rh, rts, qts, _), sc, q, r in zip(
                items, best, qm, rm):
            end = g.starts[ci] + g.lens[ci]
            if (sc >= P["first_tile_score_threshold"]
                    and off + (end - hit) > P["min_overlap"] // 2):
                locs[(ri, strand)].append(
                    (int(sc), rts + int(r), qts + int(q), ci, lh, rh))
        thr = np.float32(P["slope_threshold"])
        for key, ls in locs.items():
            ls.sort(key=lambda x: (-x[0], x[1], x[2]))
            out, dropped = [], [False] * len(ls)
            for i, l1 in enumerate(ls):
                if dropped[i]:
                    continue
                out.append(l1)
                for j in range(i + 1, len(ls)):
                    if dropped[j]:
                        continue
                    l2 = ls[j]
                    with np.errstate(divide="ignore", invalid="ignore"):
                        slope = abs(np.float32(
                            (np.float32(l1[1]) - np.float32(l2[1]))
                            / (np.float32(l1[2]) - np.float32(l2[2]))
                            - np.float32(1.0)))
                    if slope <= thr:
                        dropped[j] = True
            locs[key] = out
        return locs

    def _extend(self, groups):
        """Every extension to its end, in worker processes, a few
        extensions to a job so that a read with many spreads over them;
        returns the groups as extended."""
        jobs = [(k, i, es[i:i + EXT_PER_JOB]) for k, es in groups.items()
                for i in range(0, len(es), EXT_PER_JOB)]
        if not jobs:
            return groups
        jobs.sort(key=lambda j: -len(j[2]) * j[2][0].q_len)
        n = min(len(jobs), os.cpu_count() or 1)
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(n, _init_worker, (self.genome.bases, self.P,
                                        self.overlap, self.bits)) as pool:
            done = pool.map(_extend_group, [j[2] for j in jobs],
                            chunksize=1)
            pool.close()
            pool.join()
        out = {k: list(es) for k, es in groups.items()}
        for (k, i, _), es in zip(jobs, done):
            out[k][i:i + len(es)] = es
        return out

    def align(self, reads):
        """{read name: [records]} for ``reads`` ([(name, ASCII uint8)]),
        each read's records in the program's order: SAM lines, or MHAP's
        six lines per overlap."""
        P, g = self.P, self.genome
        reads = [Read(n, s) for n, s in reads]
        locs = self._filter(reads)
        groups = {}
        for (ri, strand), ls in locs.items():
            groups[(ri, strand)] = [
                Ext(reads[ri], strand, ci, g, rp, qp, lh, rh)
                for _, rp, qp, ci, lh, rh in ls]
        groups = self._extend(groups)
        out = {}
        for ri, rd in enumerate(reads):
            als = []
            for strand in "+-":
                es = groups[(ri, strand)]
                for i in emission_order([e.tiles for e in es],
                                        P["batch_size"]):
                    if es[i].rec is not None:
                        als.append(es[i])
            out[rd.name] = (self._mhap(rd, als) if self.overlap
                            else self._sam(rd, als))
        return out

    def _sam(self, rd, als):
        """printer.cpp's SAM records of one read: best score first, an
        alignment dropped when more than half its query span overlaps a
        better one's."""
        recs = sorted(((score_of(*e.rec, self.P), e) for e in als),
                      key=lambda x: -x[0])
        show = [True] * len(recs)
        for i, (_, e1) in enumerate(recs):
            if not show[i]:
                continue
            for j in range(i + 1, len(recs)):
                if not show[j]:
                    continue
                e2 = recs[j][1]
                s, e = max(e1.qs_off, e2.qs_off), min(e1.qe_off, e2.qe_off)
                if 2 * (e - s if e > s else 0) > e2.qe_off - e2.qs_off:
                    show[j] = False
        lines = []
        for (sc, e), keep in zip(recs, show):
            if not keep:
                continue
            flag = (16 if e.strand == "-" else 0) + 64
            lines.append("\t".join([
                rd.name, str(flag), self.genome.names[e.ci],
                str(1 + e.rs_off), "60", _cigar(e), "*", "0", "0",
                e.qseq.tobytes().decode(), "*", f"AS:i:{sc}",
                f"ZS:i:{sc}"]) + "\n")
        return lines

    def _mhap(self, rd, als):
        """printer.cpp's MHAP records of one query read: per target, the
        best alignment that reaches the last tenth of either sequence, if
        it is long enough and not the read against itself."""
        P, g = self.P, self.genome
        recs = sorted(((score_of(*e.rec, P), e) for e in als),
                      key=lambda x: (x[1].ci, -x[0]))
        show = [True] * len(recs)
        for i, (_, e1) in enumerate(recs):
            if (1 + e1.re_off < (9 * e1.ref_len) // 10
                    and 1 + e1.qe_off < (9 * e1.q_len) // 10):
                show[i] = False
            if not show[i]:
                continue
            for j in range(i + 1, len(recs)):
                if not show[j]:
                    continue
                if recs[j][1].ci != e1.ci:
                    break
                show[j] = False
        lines = []
        for (_, e), keep in zip(recs, show):
            if not keep:
                continue
            r1, r2 = g.names[e.ci], rd.name
            ar, aq = e.rec
            matches = int(np.count_nonzero(
                _upper(ar) == _upper(aq)))
            ral = e.re_off + 1 - e.rs_off
            qal = e.qe_off + 1 - e.qs_off
            ovl = (ral + qal) // 2
            if ovl < P["min_overlap"] or r1 == r2:
                continue
            err = float(np.float32((1.0 * (ovl - matches)) / ovl))
            rs, re_ = 1 + e.rs_off, 1 + e.re_off
            qs, qe = 1 + e.qs_off, 1 + e.qe_off
            rlen, qlen = g.raw_lens[e.ci], rd.len
            st = 1 if e.strand == "-" else 0
            a_r, a_q = ar.tobytes().decode(), aq.tobytes().decode()
            lines += [f"{r1} {r2} {err:.3f} {matches} 0 {rs} {re_} {rlen} "
                      f"{st} {qs} {qe} {qlen}\n", a_r + "\n", a_q + "\n",
                      f"{r2} {r1} {err:.3f} {matches} {st} {qs} {qe} {qlen} "
                      f"0 {rs} {re_} {rlen}\n", a_q + "\n", a_r + "\n"]
        return lines


def tiles(codes, reqs, qseqs):
    """Codes of a batch of tiles of one shape: reqs (ref start, ref size,
    query start, query size, reversed, (rt, qt)), cut from the genome's
    ``codes`` and each query, reversed for the right side."""
    rt, qt = reqs[0][5]
    B = len(reqs)
    R = np.full((B, rt), 4, np.uint8)
    Q = np.full((B, qt), 4, np.uint8)
    for b, ((r0, rs, q0, qs, rev, _), qseq) in enumerate(zip(reqs, qseqs)):
        rr = codes[r0:r0 + rs]
        qq = _CODE5[qseq[q0:q0 + qs]]
        R[b, :rs] = rr[::-1] if rev else rr
        Q[b, :qs] = qq[::-1] if rev else qq
    return Q, R


_WORKER = {}        # a worker process's genome and settings


def _init_worker(bases, P, overlap, bits):
    _WORKER.update(bases=bases, codes=_CODE5[bases].astype(np.uint8), P=P,
                   overlap=overlap, bits=bits,
                   scoring=(sub_5x5(P["sub"]), P["gap_open"],
                            P["gap_extend"], P["long_gap_open"],
                            P["long_gap_extend"]))


def _extend_group(exts):
    """Extend ``exts`` tile by tile to their ends, the live ones' tiles of
    one shape as one batch."""
    W = _WORKER
    P = W["P"]
    live = list(exts)
    while live:
        shapes = {}
        for e in live:
            rq = e.request(P)
            shapes.setdefault(rq[5], []).append((e, rq))
        done = set()
        for items in shapes.values():
            reqs = [rq for _, rq in items]
            Q, R = tiles(W["codes"], reqs, [e.qseq for e, _ in items])
            Tr = gact.tile_dp(Q, R, W["scoring"], True, W["bits"])
            ops, n = gact.walk(Tr, np.array([r[3] for r in reqs]) - 1,
                               np.array([r[1] for r in reqs]) - 1,
                               2 * P["tile_size"])
            for b, (e, _) in enumerate(items):
                if e.apply(ops[b, :n[b]], W["bases"], P, W["overlap"]):
                    done.add(id(e))
        live = [e for e in live if id(e) not in done]
    return exts


def _upper(a):
    return np.where((a >= 97) & (a <= 122), a - 32, a)


def _cigar(e) -> str:
    out = [f"{e.qs_off}S"] if e.qs_off > 0 else []
    ar, aq = e.rec
    if len(ar):
        ops = np.where(ar == _DASH, ord("I"),
                       np.where(aq == _DASH, ord("D"), ord("M")))
        cut = np.concatenate(([0], np.flatnonzero(np.diff(ops)) + 1,
                              [len(ops)]))
        out += [f"{int(b - a)}{chr(ops[a])}" for a, b in
                zip(cut[:-1], cut[1:])]
    tail = e.q_len - e.qe_off - 1
    if tail > 0:
        out.append(f"{tail}S")
    return "".join(out) if out else "*"
