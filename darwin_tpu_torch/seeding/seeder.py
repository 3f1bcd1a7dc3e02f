"""Seeder stage: batched D-SOFT over a read batch, both strands, in one
device pass (counterpart of ``darwin_tpu/seeding/seeder.py``); chaining
runs on the host per anchor.  With a mesh the table is sharded by hash
range over it (``parallel/shard_index.py``), with the same results.

The ``dsoft_count`` pre-pass (on a mesh, the largest per-shard count)
sizes the hit buffer exactly, and the anchor buffer is as wide as the hit
buffer, so no batch ever overflows or retries (darwin_tpu grows capped
buffers through retries to the same result).

Stage seconds (darwin_tpu/seeding/seeder.py's keys, into the caller's
``stage_seconds``): ``seed_dispatch`` the device pass and its count fetch,
``seed_fetch`` the hit and anchor fetch, ``seed_chain`` host chaining.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from darwin_tpu_torch import genome as G
from darwin_tpu_torch.seeding import chain
from darwin_tpu_torch.seeding.dsoft import dsoft_count, dsoft_device, \
    mq_cap_for
from darwin_tpu_torch.utils.stages import mark
from darwin_tpu_torch.utils.turns import fetch


@dataclasses.dataclass
class SeedResult:
    fw_anchors: List[List[chain.Anchor]]   # per read
    rc_anchors: List[List[chain.Anchor]]
    n_queried_buckets: int
    n_capped_buckets: int = 0        # queried buckets over the cap


class Seeder:
    def __init__(self, table, cfg, mesh=None):
        """mesh: a ``parallel.shard.Mesh`` (power-of-two size) to shard
        the pairs table over; a csr table raises."""
        self.table = table
        self.cfg = cfg
        self.max_occ = cfg.max_bucket_occupancy or table.kmer_max_occurence
        self.sharded = None
        if mesh is not None:
            from darwin_tpu_torch.parallel.shard_index import \
                shard_seed_table
            self.sharded = shard_seed_table(table, mesh)

    def query_rows(self, reads):
        """The D-SOFT inputs of a read batch on the table's device: (codes2
        (2 x reads, Lcap) uint8, each read's forward and reverse-complement
        2-bit codes; lengths; the keyword arguments of dsoft_count — k, w,
        num_seeds, max_stride, overlap, max_occ, mq_cap)."""
        cfg = self.cfg
        dev = self.table.positions.device
        lcap = (max(r.length for r in reads) + 15) // 16 * 16
        codes2 = np.zeros((2 * len(reads), lcap), np.uint8)
        lengths = np.zeros(2 * len(reads), np.int64)
        for i, r in enumerate(reads):
            codes2[2 * i, :r.length] = G.encode2(r.seq)
            codes2[2 * i + 1, :r.length] = G.encode2(r.rc_seq)
            lengths[2 * i] = lengths[2 * i + 1] = r.length
        mq_cap = mq_cap_for(lcap - cfg.seed_size + 1, cfg.num_seeds,
                            cfg.max_stride, cfg.do_overlap)
        kw = dict(k=cfg.seed_size, w=cfg.minimizer_window,
                  num_seeds=cfg.num_seeds, max_stride=cfg.max_stride,
                  overlap=cfg.do_overlap, max_occ=self.max_occ,
                  mq_cap=mq_cap)
        return (torch.from_numpy(codes2).to(dev),
                torch.from_numpy(lengths).to(dev), kw)

    def seed_batch(self, reads, stage_seconds: dict | None = None
                   ) -> SeedResult:
        """stage_seconds: the caller's per-call timing dict, or None."""
        cfg = self.cfg
        if not reads:
            return SeedResult([], [], 0)
        t0 = time.perf_counter()
        codes2, lengths, kw = self.query_rows(reads)
        B = codes2.shape[0]
        if self.sharded is not None:
            from darwin_tpu_torch.parallel.shard_index import dsoft_sharded
            res = dsoft_sharded(codes2, lengths, self.sharded,
                                threshold=cfg.dsoft_threshold,
                                bin_size=cfg.bin_size, **kw)
        else:
            kw["bucket_offsets"] = self.table.bucket_offsets
            need = dsoft_count(codes2, lengths, self.table.sorted_hashes,
                               **kw)
            hit_cap = max(int(fetch(need.max())), 1)
            res = dsoft_device(codes2, lengths, self.table.sorted_hashes,
                               self.table.positions,
                               threshold=cfg.dsoft_threshold,
                               bin_size=cfg.bin_size, a_cap=hit_cap,
                               hit_cap=hit_cap, **kw)
        counts = torch.stack([res["n_hits"], res["n_anchors"],
                              res["n_queried_buckets"], res["n_capped"]])
        counts = fetch(counts)
        t0 = mark(stage_seconds, "seed_dispatch", t0)
        mh = max(int(counts[0].max()), 1)
        ma = max(int(counts[1].max()), 1)
        hits = fetch(torch.stack([res["hits_bin"][:, :mh],
                                  res["hits_off"][:, :mh],
                                  res["hits_pos"][:, :mh]]))
        anc = fetch(torch.stack([res["anc_pos"][:, :ma],
                                 res["anc_off"][:, :ma],
                                 res["anc_bin"][:, :ma]]))
        t0 = mark(stage_seconds, "seed_fetch", t0)

        strands = []
        for row in range(B):
            strands.append(chain.chain_anchors(
                hits[0][row], hits[1][row], hits[2][row], int(counts[0][row]),
                anc[0][row], anc[1][row], anc[2][row], int(counts[1][row]),
                cfg.bin_size, cfg.do_overlap))
        mark(stage_seconds, "seed_chain", t0)
        return SeedResult(strands[0::2], strands[1::2],
                          int(counts[2].sum()), int(counts[3].sum()))
