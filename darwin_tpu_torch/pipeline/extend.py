"""GACT extension stage: the outer tiling state machine (counterpart of
``darwin_tpu/pipeline/extend.py``; the reference's extender_body,
software/extender.cpp:9-1065).

Every live extension of a read batch contributes one tile per round to one
device dispatch per tile shape.  The extensions and their per-tile state
machine (decode, hit popping, termination, the next request) live in the
native host library's extension table (``native.ExtensionTable``), which
decodes a whole chain level in one call.  Every dispatch is a chain
(``ops/dispatch.extend_tiles_async``; darwin_tpu/pipeline/extend.py:
622-764): standard square tiles go out as speculative chains of ``spec_k``
tiles, large tiles as chains of one.  The device predicts each next tile
from the walk before it, and the host accepts level j only while the
request it computes after the exact decode of level j-1 equals the
device's, field for field, so the output never depends on the
prediction.  Per-extension behaviour —
including the reference's quirks listed in darwin_tpu/pipeline/extend.py:
9-30 — and the emission order are darwin_tpu's exactly.

Stage seconds (host wall, per call, into ``stage_seconds``; darwin_tpu's
keys): ``ru_qbuild`` / ``ru_enqueue`` the read buffer's build and upload;
per round ``extend_req`` (requests), ``extend_pack`` (request vectors),
``extend_enqueue`` (the dispatches' enqueue), ``extend_dispatch`` (the
three before, together), ``extend_fetch`` (resolve(): the one fetch and
the expansion of tile 1), ``extend_decode`` (acceptance and decode of
every level).  Counters besides darwin_tpu's: ``num_decoded_tiles`` and
``num_decode_calls``, the tiles decoded and the table's decode calls.

``ExtendAlignment`` is a jax-free copy of darwin_tpu's
(darwin_tpu/pipeline/extend.py imports jax) and ``reference_emission_order``
gives darwin_tpu's order and counters; ``alignment_score`` computes
darwin_tpu's in the native host library.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import List

import numpy as np
import torch

from darwin_tpu_torch import native
from darwin_tpu_torch.genome import encode5
from darwin_tpu_torch.ops import dispatch
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


def reference_emission_order(tile_counts: List[int], batch_size: int,
                             counters=None):
    """Replay the reference's slot scheduler (extender.cpp:34-533) from
    per-extension tile counts: extension indices in completion order, and
    the reference's num_extend_tiles / num_active_tiles counters
    (darwin_tpu/pipeline/extend.py:377-412, which steps every slot through
    every tile).  Here one step per extension: the first ``batch_size``
    extensions start in slots 0, 1, ... at iteration 1; an extension ends
    at its start + its tiles - 1, and its slot takes the next extension
    from the iteration after; completions come in order of (iteration,
    slot).  The replay runs for the last end's iterations with every slot
    counted, and each extension is active for its tiles."""
    n = len(tile_counts)
    if n == 0:
        return []
    if min(tile_counts) < 1:
        raise ValueError("every extension takes at least one tile")
    width = min(n, batch_size)
    heap = [(tile_counts[s], s, s) for s in range(width)]
    heapq.heapify(heap)
    order = []
    nxt = width
    while heap:
        end, s, e = heapq.heappop(heap)
        order.append(e)
        if nxt < n:
            heapq.heappush(heap, (end + tile_counts[nxt], s, nxt))
            nxt += 1
    if counters is not None:
        counters["num_extend_tiles"] += width * end
        counters["num_active_tiles"] += sum(tile_counts)
    return order


class ExtensionManager:
    """Runs all extensions of a read batch through wide device dispatches.

    The read batch is uploaded once as 1-byte ``encode5`` codes: per read
    and strand the ASCII sequence plus a 4 * tile_size 'N' margin, the
    same layout darwin_tpu's mesh path uploads.  ``spec_k``: tiles per
    chain of standard tiles (1: no speculation); large tiles go as chains
    of one.  ``mesh_dispatch``: a ``parallel.shard.MeshDispatcher`` that
    splits every dispatch over its mesh; the read batch's codes then get
    one copy per device of the mesh (``ref_codes_dev`` is the genome's
    ``Replicated``)."""

    def __init__(self, store, reads, cfg, params, ref_codes_dev,
                 spec_k: int, stage_seconds: dict | None = None,
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

    def run(self, groups, reads, counters) -> List[List[ExtendAlignment]]:
        """groups: (read_num, strand, [ExtendLocation...]) in reference
        order (per read: fw group then rc group).  Returns the per-group
        emitted alignments in reference emission order.

        The extensions live in a ``native.ExtensionTable``; a round is the
        table's requests for the live lanes, one dispatch per tile shape,
        and per chain level one decode call, which also accepts the lanes
        for the next level.  Lane sets are index arrays: no Python runs
        per tile or per lane, only per extension at the build and the
        emission."""
        cfg = self.cfg
        fields, left_hits, right_hits, meta = [], [], [], []
        for read_num, strand, locs in groups:
            q_len = reads[read_num].length
            q_code_start = self.q_code_start[(read_num, strand)]
            for loc in locs:
                chrom = self.store.chromosomes[loc.chr_id]
                fields.append((strand == "-", chrom.start, chrom.length,
                               q_len, q_code_start,
                               loc.reference_pos - chrom.start,
                               loc.query_pos))
                left_hits.append(loc.left_hits)
                right_hits.append(loc.right_hits)
                meta.append(loc)
        out = [[] for _ in groups]
        if not fields:
            return out
        fields = np.array(fields, np.int64).T
        with native.ExtensionTable(fields, left_hits, right_hits, self.bases,
                                   self.q_ascii, cfg) as table:
            self._rounds(table, fields, counters)
            state = table.state()
            emitted = np.flatnonzero(state["emitted"])
            ref, q, offs, scores = table.emit(emitted,
                                              state["columns"][emitted])
        alignments = {}
        for i, e in enumerate(emitted.tolist()):
            loc = meta[e]
            alignments[e] = ExtendAlignment(
                read_num=loc.read_num, chr_id=loc.chr_id,
                strand="-" if fields[0, e] else "+",
                reference_start_offset=int(state["ref_start_off"][e]),
                query_start_offset=int(state["q_start_off"][e]),
                reference_end_offset=int(state["ref_end_off"][e]),
                query_end_offset=int(state["q_end_off"][e]),
                reference_length=int(fields[2, e]),
                query_length=int(fields[3, e]),
                aligned_reference=ref[offs[i]:offs[i + 1]].tobytes(),
                aligned_query=q[offs[i]:offs[i + 1]].tobytes(),
                score=int(scores[i]))
        tiles = state["tiles"]
        start = 0
        for gi, (_, _, locs) in enumerate(groups):
            stop = start + len(locs)
            for local in reference_emission_order(
                    tiles[start:stop].tolist(), cfg.batch_size, counters):
                a = alignments.get(start + local)
                if a is not None:
                    out[gi].append(a)
            start = stop
        return out

    def _rounds(self, table, fields, counters):
        """Extend every extension of ``table`` to its end: up to
        ``extension_lanes`` live at once, a finished one's lane taken by
        the next in build order."""
        cfg = self.cfg
        T = cfg.tile_size
        tacc = self.stage_seconds
        n = fields.shape[1]
        # per extension: chromosome start and length, query-buffer start,
        # read length (the dispatch's chain rows)
        lane_rows = fields[[1, 2, 4, 3]]
        finished = np.zeros(n, bool)
        live = np.arange(min(n, cfg.extension_lanes))
        pending = len(live)
        while len(live):
            t_round = t0 = time.perf_counter()
            counters["num_extend_rounds"] += 1
            req, n_large = table.requests(live)
            counters["num_large_tiles"] += n_large
            t0 = mark(tacc, "extend_req", t0)
            # one dispatch per tile shape, in order of first appearance;
            # enqueue them all, then resolve + decode in order (each
            # group's fetch and decode overlap the others' device work)
            _, first, shape = np.unique(req[5] * (1 << 32) + req[6],
                                        return_index=True,
                                        return_inverse=True)
            rounds = []
            for g in np.argsort(first):
                sel = np.flatnonzero(shape == g)
                exts = live[sel]
                r_start, r_size, q_start, q_size, rev, rt, qt = req[:, sel]
                rt, qt = int(rt[0]), int(qt[0])
                t0 = mark(tacc, "extend_pack", t0)
                resolve = self.dispatch.extend_tiles_async(
                    self.ref_codes_dev, self.q_codes_dev, r_start, r_size,
                    q_start, q_size, rev, *lane_rows[:, exts], self.params,
                    qt=qt, rt=rt, max_tb=2 * T, stop_thr=T - cfg.tile_overlap,
                    K=self.spec_k if rt == qt == T else 1)
                rounds.append((exts, resolve, rev))
                t0 = mark(tacc, "extend_enqueue", t0)
            mark(tacc, "extend_dispatch", t_round)
            for exts, resolve, rev in rounds:
                t0 = time.perf_counter()
                res = resolve()
                t0 = mark(tacc, "extend_fetch", t0)
                # the chain: level j is decoded for the lanes (rows of the
                # dispatch) whose request after level j-1's exact decode
                # equals the device's; a refused lane keeps that request
                # for the next round
                spec_req = res["spec_req"]
                rows = np.arange(len(exts))
                ops, n_ops = res["ops"], res["n_ops"]
                for j in range(len(spec_req) + 1):
                    if j:
                        ops, n_ops = res["ops_spec"].take(j - 1, rows)
                    nxt = spec_req[j] if j < len(spec_req) else None
                    status, hits, misses, n_large = table.decode_level(
                        exts[rows], ops, n_ops, nxt, rows, rev)
                    counters["num_spec_hits"] += hits
                    counters["num_spec_misses"] += misses
                    counters["num_large_tiles"] += n_large
                    counters["num_decoded_tiles"] += len(rows)
                    counters["num_decode_calls"] += 1
                    finished[exts[rows[status == 1]]] = True
                    rows = rows[status == 2]
                    if not len(rows):
                        break
                mark(tacc, "extend_decode", t0)
            # a finished extension's lane goes to the next pending one
            done = finished[live]
            k = min(int(done.sum()), n - pending)
            live = np.concatenate([live[~done],
                                   np.arange(pending, pending + k)])
            pending += k
