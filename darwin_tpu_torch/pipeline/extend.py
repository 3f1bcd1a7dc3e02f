"""GACT extension stage: the outer tiling state machine (counterpart of
``darwin_tpu/pipeline/extend.py``; the reference's extender_body,
software/extender.cpp:9-1065).

Every live extension of a read batch contributes one tile per round to one
device dispatch per tile shape; the per-tile decode runs on the host
through the native batched decoder.  Standard square tiles go out as
speculative chains of ``spec_k`` tiles (``ops/dispatch.
extend_tiles_spec_async``; darwin_tpu/pipeline/extend.py:622-764): the
device predicts each next tile from the walk before it, and the host
accepts level j only while the request it computes after the exact decode
of level j-1 equals the device's, field for field, so the output never
depends on the prediction.  Large tiles, and every tile at ``spec_k=1``,
go one per round (``extend_tiles_async``).  Per-extension behaviour —
including the reference's quirks listed in darwin_tpu/pipeline/extend.py:
9-30 — and the emission order are darwin_tpu's exactly.

Stage seconds (host wall, per call, into ``stage_seconds``; darwin_tpu's
keys): ``ru_qbuild`` / ``ru_enqueue`` the read buffer's build and upload;
per round ``extend_req`` (requests), ``extend_pack`` (request vectors),
``extend_enqueue`` (the dispatches' enqueue), ``extend_dispatch`` (the
three before, together), ``extend_fetch`` (resolve(): the one fetch and
the expansion of tile 1), ``extend_decode`` (acceptance and decode of
every level).

``ExtendAlignment``, ``_Ext`` and ``reference_emission_order`` are
jax-free copies of darwin_tpu's (darwin_tpu/pipeline/extend.py imports
jax); ``alignment_score`` computes darwin_tpu's in the native host
library.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from darwin_tpu_torch import native
from darwin_tpu_torch.genome import encode5
from darwin_tpu_torch.ops import dispatch
from darwin_tpu_torch.pipeline.filter import ExtendLocation
from darwin_tpu_torch.utils.stages import mark

def alignment_score(ref_bytes: np.ndarray, q_bytes: np.ndarray, cfg) -> int:
    """Two-piece rescore of an aligned pair (extender.cpp:1161-1200;
    darwin_tpu/pipeline/extend.py:60-90) in the native host library.
    Each maximal gap run scores max(short, long) when it closes at a
    non-gap column; a run at the very end is never added."""
    ref, q = (x if isinstance(x, np.ndarray)
              else np.frombuffer(bytes(x), np.uint8)
              for x in (ref_bytes, q_bytes))
    score = native.score_alignment_native(
        ref, q, cfg.sub_matrix_5x5, cfg.gap_open, cfg.gap_extend,
        cfg.long_gap_open, cfg.long_gap_extend)
    if score is None:
        raise RuntimeError("alignment rescore: "
                           + native.unavailable_reason())
    return score


@dataclasses.dataclass
class ExtendAlignment:
    """Completed alignment record for the printer (graph.h:97-121)."""
    read_num: int
    chr_id: int
    strand: str
    reference_start_offset: int
    query_start_offset: int
    reference_end_offset: int
    query_end_offset: int
    reference_length: int
    query_length: int
    aligned_reference: bytes
    aligned_query: bytes
    score: int
    do_print: bool = True


class _Ext:
    """One live extension (ExtendAlignments, graph.h:97-121); copy of
    darwin_tpu/pipeline/extend.py:115-370 minus the per-tile numpy
    decode (the port always decodes through the native batch call)."""

    __slots__ = ("read_num", "chr_id", "strand", "ref_start_addr", "ref_len",
                 "q_len", "q_code_start", "curr_ref", "curr_q",
                 "ref_start_off", "q_start_off", "ref_end_off", "q_end_off",
                 "left_done", "right_done", "used_large", "left_hits",
                 "right_hits", "left_chunks", "right_chunks", "tiles",
                 "emitted", "group")

    def __init__(self, loc: ExtendLocation, strand: str, chrom,
                 q_len: int, q_code_start: int, group):
        self.read_num = loc.read_num
        self.chr_id = loc.chr_id
        self.strand = strand
        self.ref_start_addr = chrom.start
        self.ref_len = chrom.length
        self.q_len = q_len
        self.q_code_start = q_code_start   # offset into the query buffer
        self.curr_ref = loc.reference_pos - chrom.start
        self.curr_q = loc.query_pos
        self.ref_start_off = self.curr_ref
        self.q_start_off = self.curr_q
        self.ref_end_off = self.curr_ref
        self.q_end_off = self.curr_q
        self.left_done = False
        self.right_done = False
        self.used_large = False
        self.left_hits = np.asarray(loc.left_hits, np.uint64)
        self.right_hits = np.asarray(loc.right_hits, np.uint64)
        self.left_chunks: list = []
        self.right_chunks: list = []
        self.tiles = 0
        self.emitted: Optional[ExtendAlignment] = None
        self.group = group

    def _large_sizes(self, left: bool, cfg):
        hits = self.left_hits if left else self.right_hits
        hit = int(hits[-1])
        h1 = self.ref_start_addr + self.curr_ref
        o1 = self.curr_q
        h2, o2 = hit >> 32, hit & 0xFFFFFFFF
        if left:
            big_ref = (h1 - h2) > (o1 - o2)
        else:
            big_ref = (h2 - h1) > (o2 - o1)
        if big_ref:
            return cfg.large_tile_long, cfg.large_tile_short
        return cfg.large_tile_short, cfg.large_tile_long

    def request(self, cfg, counters):
        """(r_start_abs, r_size, q_start_rel, q_size, reversed, (rt, qt))."""
        if not self.left_done:
            rt = qt = cfg.tile_size
            if self.used_large:
                rt, qt = self._large_sizes(True, cfg)
                counters["num_large_tiles"] += 1
            r_size = min(self.curr_ref + 1, rt)
            q_size = min(self.curr_q + 1, qt)
            r_start = self.ref_start_addr + (
                self.curr_ref - rt + 1 if self.curr_ref >= rt else 0)
            q_start = self.curr_q - qt + 1 if self.curr_q >= qt else 0
            return (r_start, r_size, q_start, q_size, False, (rt, qt))
        rt = qt = cfg.tile_size
        if self.used_large:
            rt, qt = self._large_sizes(False, cfg)
            counters["num_large_tiles"] += 1
        r_size = min(self.ref_len - self.curr_ref, rt)
        q_size = min(self.q_len - self.curr_q, qt)
        return (self.ref_start_addr + self.curr_ref, r_size,
                self.curr_q, q_size, True, (rt, qt))

    def tile_stop(self, cfg):
        """(left, stop_thr) for the tile about to be decoded (decode-side
        tile sizes gated by do_overlap, extender.cpp:261,408)."""
        left = not self.left_done
        rt = qt = cfg.tile_size
        if self.used_large and not cfg.do_overlap:
            rt, qt = self._large_sizes(left, cfg)
        return left, min(rt, qt) - cfg.tile_overlap

    def apply_native(self, left: bool, n_ops_total: int, rchars, qchars,
                     new_ref: int, new_q: int, rb: bool, qb: bool,
                     cfg) -> bool:
        """Apply a natively decoded tile; True when the extension is
        finished."""
        self.tiles += 1
        if left:
            self.left_chunks.append((rchars[::-1], qchars[::-1]))
            if rb:
                self.ref_start_off = 0
            if qb:
                self.q_start_off = 0
        else:
            self.right_chunks.append((rchars, qchars))
        self.curr_ref = new_ref
        self.curr_q = new_q
        return self._post_decode(left, n_ops_total, cfg)

    def _post_decode(self, left: bool, n_ops_total: int, cfg) -> bool:
        """Hit popping + termination (extender.cpp:336-394 / :472-524)."""
        if left:
            if len(self.left_hits):
                x = self.ref_start_addr + self.curr_ref
                h = (self.left_hits >> np.uint64(32)).astype(np.int64)
                o = (self.left_hits & np.uint64(0xFFFFFFFF)).astype(np.int64)
                good = np.nonzero((h < x) & (o < self.curr_q))[0]
                self.left_hits = self.left_hits[:good[-1] + 1] if len(good) \
                    else self.left_hits[:0]

            at_bound = self.ref_start_off == 0 or self.q_start_off == 0
            no_hits = len(self.left_hits) == 0
            outer = (n_ops_total == 0) or at_bound
            if self.strand == "+":
                outer = outer or no_hits  # fw-only check (extender.cpp:353)
            if outer:
                if self.used_large or no_hits or at_bound:
                    self.left_done = True
                    if self.ref_start_off > 0:
                        self.ref_start_off = self.curr_ref + 1
                    if self.q_start_off > 0:
                        self.q_start_off = self.curr_q + 1
                    if (self.curr_ref + 1 < self.ref_len
                            and self.curr_q + 1 < self.q_len
                            and not self.right_done):
                        self.curr_ref = self.ref_end_off + 1
                        self.curr_q = self.q_end_off + 1
                        return False
                    # cannot start the right side
                    self.right_done = True
                    if self.strand == "-":
                        # rc path emits here (extender.cpp:886-888); the
                        # fw path silently drops (:363-382)
                        self._emit(cfg)
                    return True
                self.used_large = True
                return False
            self.used_large = False
            return False

        if len(self.right_hits):
            x = self.ref_start_addr + self.curr_ref
            h = (self.right_hits >> np.uint64(32)).astype(np.int64)
            o = (self.right_hits & np.uint64(0xFFFFFFFF)).astype(np.int64)
            good = np.nonzero((h > x) & (o > self.curr_q))[0]
            self.right_hits = self.right_hits[:good[-1] + 1] if len(good) \
                else self.right_hits[:0]

        at_end = (self.curr_ref == self.ref_len or self.curr_q == self.q_len)
        if (n_ops_total == 0) or at_end:
            if self.used_large or len(self.right_hits) == 0 or at_end:
                self.ref_end_off = self.curr_ref - 1
                self.q_end_off = self.curr_q - 1
                self._emit(cfg)
                self.right_done = True
                return True
            self.used_large = True
            return False
        self.used_large = False
        return False

    def _emit(self, cfg):
        parts_r = [c[0] for c in reversed(self.left_chunks)] + \
                  [c[0] for c in self.right_chunks]
        parts_q = [c[1] for c in reversed(self.left_chunks)] + \
                  [c[1] for c in self.right_chunks]
        ar = np.concatenate(parts_r) if parts_r else np.zeros(0, np.uint8)
        aq = np.concatenate(parts_q) if parts_q else np.zeros(0, np.uint8)
        self.emitted = ExtendAlignment(
            read_num=self.read_num, chr_id=self.chr_id, strand=self.strand,
            reference_start_offset=self.ref_start_off,
            query_start_offset=self.q_start_off,
            reference_end_offset=self.ref_end_off,
            query_end_offset=self.q_end_off,
            reference_length=self.ref_len, query_length=self.q_len,
            aligned_reference=ar.tobytes(), aligned_query=aq.tobytes(),
            score=alignment_score(ar, aq, cfg))


def reference_emission_order(tile_counts: List[int], batch_size: int,
                             counters=None):
    """Replay the reference's slot scheduler (extender.cpp:34-533) from
    per-extension tile counts (copy of darwin_tpu/pipeline/extend.py:
    377-412): extension indices in completion order, and the reference's
    num_extend_tiles / num_active_tiles counters."""
    n = len(tile_counts)
    if n == 0:
        return []
    width = min(n, batch_size)
    slot_ext = list(range(width))
    remaining = [tile_counts[i] for i in slot_ext]
    nxt = width
    active = width
    done = 0
    order = []
    while done < n:
        if counters is not None:
            counters["num_extend_tiles"] += width
            counters["num_active_tiles"] += active
        for s in range(width):
            if slot_ext[s] is None:
                continue
            remaining[s] -= 1
            if remaining[s] == 0:
                order.append(slot_ext[s])
                done += 1
                if nxt < n:
                    slot_ext[s] = nxt
                    remaining[s] = tile_counts[nxt]
                    nxt += 1
                else:
                    slot_ext[s] = None
                    active -= 1
    return order


class ExtensionManager:
    """Runs all extensions of a read batch through wide device dispatches.

    The read batch is uploaded once as 1-byte ``encode5`` codes: per read
    and strand the ASCII sequence plus a 4 * tile_size 'N' margin, the
    same layout darwin_tpu's mesh path uploads.  ``spec_k``: tiles per
    speculative chain (1: no speculation).  ``mesh_dispatch``: a
    ``parallel.shard.MeshDispatcher`` that splits every dispatch over its
    mesh; the read batch's codes then get one copy per device of the mesh
    (``ref_codes_dev`` is the genome's ``Replicated``)."""

    def __init__(self, store, reads, cfg, params, ref_codes_dev,
                 spec_k: int = 1, stage_seconds: dict | None = None,
                 mesh_dispatch=None):
        t0 = time.perf_counter()
        self.store = store
        self.cfg = cfg
        self.params = params
        self.spec_k = spec_k
        self.stage_seconds = stage_seconds
        self.dispatch = mesh_dispatch or dispatch
        self.bases = store.bases_with_margin(4 * cfg.large_tile_long)
        self.ref_codes_dev = ref_codes_dev
        margin = np.full(4 * cfg.tile_size, ord("N"), np.uint8)
        bufs, offsets = [], {}
        pos = 0
        for i, r in enumerate(reads):
            for strand, seq in (("+", r.seq), ("-", r.rc_seq)):
                bufs += [seq, margin]
                offsets[(i, strand)] = pos
                pos += len(seq) + len(margin)
        self.q_code_start = offsets
        self.q_ascii = np.concatenate(bufs) if bufs else margin
        t0 = mark(stage_seconds, "ru_qbuild", t0)
        self.q_codes_dev = torch.from_numpy(encode5(self.q_ascii)).to(
            ref_codes_dev.device)
        if mesh_dispatch is not None:
            self.q_codes_dev = mesh_dispatch.replicate(self.q_codes_dev)
        mark(stage_seconds, "ru_enqueue", t0)

    def _decode_wave(self, exts, tiles, opsmat, nvec, cfg) -> dict:
        """Decode one wave of tiles — (batch row b, extension ei) pairs with
        ops opsmat[b, :nvec[b]] — through ONE native call.  Returns
        {ei: finished}."""
        n = len(tiles)
        sel = np.empty(n, np.int64)
        n_ops = np.empty(n, np.int64)
        stops = np.empty(n, np.int64)
        dirs = np.empty(n, np.int32)
        rsa = np.empty(n, np.int64)
        qoff = np.empty(n, np.int64)
        cr = np.empty(n, np.int64)
        cq = np.empty(n, np.int64)
        rl = np.empty(n, np.int64)
        ql = np.empty(n, np.int64)
        lefts = []
        for i, (b, ei) in enumerate(tiles):
            e = exts[ei]
            left, stop = e.tile_stop(cfg)
            lefts.append(left)
            sel[i] = b
            n_ops[i] = int(nvec[b])
            stops[i] = stop
            dirs[i] = 0 if left else 1
            rsa[i] = e.ref_start_addr
            qoff[i] = e.q_code_start
            cr[i] = e.curr_ref
            cq[i] = e.curr_q
            rl[i] = e.ref_len
            ql[i] = e.q_len
        res = native.decode_ops_batch_native(
            opsmat, sel, n_ops, stops, dirs, self.bases, rsa, self.q_ascii,
            qoff, cr, cq, rl, ql)
        if res is None:
            raise RuntimeError("tile decoding: "
                               + native.unavailable_reason())
        out_ref, out_q, cols, new_ref, new_q, rb, qb = res
        out = {}
        for i, (b, ei) in enumerate(tiles):
            c = int(cols[i])
            out[ei] = exts[ei].apply_native(
                lefts[i], int(n_ops[i]), out_ref[i, :c], out_q[i, :c],
                int(new_ref[i]), int(new_q[i]), bool(rb[i]), bool(qb[i]),
                cfg)
        return out

    def run(self, groups, reads, counters) -> List[List[ExtendAlignment]]:
        """groups: (read_num, strand, [ExtendLocation...]) in reference
        order (per read: fw group then rc group).  Returns the per-group
        emitted alignments in reference emission order."""
        cfg = self.cfg
        exts: List[_Ext] = []
        for gi, (read_num, strand, locs) in enumerate(groups):
            for loc in locs:
                chrom = self.store.chromosomes[loc.chr_id]
                exts.append(_Ext(loc, strand, chrom, reads[read_num].length,
                                 self.q_code_start[(read_num, strand)], gi))

        max_lanes = cfg.extension_lanes
        live = list(range(min(len(exts), max_lanes)))
        pending = list(range(len(live), len(exts)))
        T = cfg.tile_size
        tacc = self.stage_seconds
        cached_req = {}    # ei -> its request, computed at a refused level
        while live:
            t_round = t0 = time.perf_counter()
            counters["num_extend_rounds"] += 1
            reqs = {}       # tile shape -> [(ei, request)]
            for ei in live:
                r = cached_req.pop(ei, None)
                if r is None:
                    r = exts[ei].request(cfg, counters)
                reqs.setdefault(r[5], []).append((ei, r))
            t0 = mark(tacc, "extend_req", t0)
            # enqueue every tile-shape group, then resolve + decode in
            # order (each group's fetch and decode overlap the others'
            # device work)
            rounds = []
            for (rt, qt), items in reqs.items():
                B = len(items)
                r_start = np.empty(B, np.int64)
                r_size = np.empty(B, np.int64)
                q_start = np.empty(B, np.int64)
                q_size = np.empty(B, np.int64)
                rev = np.empty(B, np.int64)
                for b, (ei, (rs, rsz, qs, qsz, rv, _)) in enumerate(items):
                    r_start[b] = rs
                    r_size[b] = rsz
                    q_start[b] = exts[ei].q_code_start + qs
                    q_size[b] = qsz
                    rev[b] = rv
                spec = self.spec_k > 1 and (rt, qt) == (T, T)
                if spec:
                    lane = np.array([(exts[ei].ref_start_addr,
                                      exts[ei].ref_len, exts[ei].q_code_start,
                                      exts[ei].q_len) for ei, _ in items],
                                    np.int64).reshape(B, 4).T
                t0 = mark(tacc, "extend_pack", t0)
                if spec:
                    resolve = self.dispatch.extend_tiles_spec_async(
                        self.ref_codes_dev, self.q_codes_dev, r_start,
                        r_size, q_start, q_size, rev, *lane, self.params,
                        qt=qt, rt=rt, max_tb=2 * T,
                        stop_thr=min(rt, qt) - cfg.tile_overlap,
                        K=self.spec_k)
                else:
                    resolve = self.dispatch.extend_tiles_async(
                        self.ref_codes_dev, self.q_codes_dev, r_start,
                        r_size, q_start, q_size, rev, self.params, qt=qt,
                        rt=rt, max_tb=2 * T)
                rounds.append((items, resolve, rev))
                t0 = mark(tacc, "extend_enqueue", t0)
            mark(tacc, "extend_dispatch", t_round)
            finished = []
            for items, resolve, rev in rounds:
                t0 = time.perf_counter()
                res = resolve()
                t0 = mark(tacc, "extend_fetch", t0)
                tiles = [(b, ei) for b, (ei, _) in enumerate(items)]
                done = self._decode_wave(exts, tiles, res["ops"],
                                         res["n_ops"], cfg)
                alive = [(b, ei) for b, ei in tiles if not done[ei]]
                finished += [ei for _, ei in tiles if done[ei]]
                # the chain: level j is decoded for the lanes whose request
                # after level j-1's exact decode equals the device's; a
                # refused lane keeps that request for the next round
                for j, sr in enumerate(res.get("spec_req", ())):
                    accepted = []
                    for b, ei in alive:
                        r = exts[ei].request(cfg, counters)
                        if (r[5] == (T, T) and r[4] == rev[b]
                                and r[0] == sr[0][b] and r[1] == sr[1][b]
                                and exts[ei].q_code_start + r[2] == sr[2][b]
                                and r[3] == sr[3][b]):
                            counters["num_spec_hits"] += 1
                            accepted.append((b, ei))
                        else:
                            counters["num_spec_misses"] += 1
                            cached_req[ei] = r
                    if not accepted:
                        break
                    ops, n_ops = res["ops_spec"].take(
                        j, [b for b, _ in accepted])
                    done = self._decode_wave(
                        exts, [(i, ei) for i, (_, ei) in enumerate(accepted)],
                        ops, n_ops, cfg)
                    alive = [(b, ei) for b, ei in accepted if not done[ei]]
                    finished += [ei for _, ei in accepted if done[ei]]
                mark(tacc, "extend_decode", t0)
            for ei in finished:
                live.remove(ei)
                if pending:
                    live.append(pending.pop(0))

        out = [[] for _ in groups]
        by_group = {}
        for idx, e in enumerate(exts):
            by_group.setdefault(e.group, []).append(idx)
        for gi, idxs in by_group.items():
            order = reference_emission_order(
                [exts[i].tiles for i in idxs], cfg.batch_size, counters)
            for local in order:
                e = exts[idxs[local]]
                if e.emitted is not None:
                    out[gi].append(e.emitted)
        return out
