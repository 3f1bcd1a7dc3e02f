"""End-to-end entry points, both modes (counterpart of
``darwin_tpu/pipeline/align.py``'s ``Aligner`` and ``run``).

Index phase: reference FASTA -> GenomeStore -> SeedTable on the device (in
overlap mode the "reference" is the reads file itself).
Align phase, per read batch: Seeder (device D-SOFT + host chaining) ->
filter (device first tiles + host slope filter) -> ExtensionManager (device
GACT tiles + host decode) -> SAM (reference-guided) or MHAP (overlap).
stdout and the 7-line counter block are byte-identical to darwin_tpu's.

Not ported yet: read-batch pipelining (``pipeline_depth`` > 1) and stage
telemetry, ``--index-cache``, the csr index layout, meshes and multi-host
runs.
"""

from __future__ import annotations

import sys
import time
from typing import List

import numpy as np
import torch

from darwin_tpu_torch.config import Config
from darwin_tpu_torch.genome import GenomeStore, Read, encode5
from darwin_tpu_torch.io.fasta import iter_read_batches, load_genome
from darwin_tpu_torch.pipeline import filter as flt
from darwin_tpu_torch.index.seed_table import SeedTable, build_seed_table
from darwin_tpu_torch.ops import gact
from darwin_tpu_torch.ops.dispatch import first_tile_scores
from darwin_tpu_torch.ops.gact_cuda import LAUNCHES
from darwin_tpu_torch.pipeline import printer
from darwin_tpu_torch.pipeline.extend import ExtensionManager
from darwin_tpu_torch.seeding.seeder import Seeder
from darwin_tpu_torch.utils.device import resolve_device


def new_counters():
    return {
        "num_reads": 0,
        "num_filter_tiles": 0,
        "num_extend_requests": 0,
        "num_slope_filtered": 0,
        "num_extend_tiles": 0,
        "num_active_tiles": 0,
        "num_large_tiles": 0,
        # non-reference telemetry, printed after the counter block
        "num_extend_rounds": 0,
        "num_queried_buckets": 0,
        "num_capped_buckets": 0,
    }


class Aligner:
    def __init__(self, cfg: Config, store: GenomeStore,
                 table: SeedTable | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.store = store
        self.table = table or build_seed_table(store, cfg, self.device)
        if self.table.positions.device != self.device:
            raise ValueError(f"seed table is on {self.table.positions.device}"
                             f", the aligner on {self.device}")
        self.seeder = Seeder(self.table, cfg)
        self.params = gact.make_params(cfg)
        self.counters = new_counters()
        # genome codes + the extender's large-tile 'N' margin, uploaded once
        # (one buffer serves the filter and every extension gather)
        bases = store.bases_with_margin(4 * cfg.large_tile_long)
        self.ref_codes = torch.from_numpy(encode5(bases)).to(self.device)

    def _filter_dispatch(self, reads, anchors_per_read, strand, counters,
                         mgr):
        """Enqueue one strand's first tiles (software/filter.cpp:8-228);
        both strands dispatch before either is fetched."""
        cfg = self.cfg
        batch = flt.build_first_tiles(reads, anchors_per_read, self.store,
                                      cfg)
        n = len(batch.meta)
        counters["num_filter_tiles"] += n
        if n == 0:
            return batch, 0, None
        q_start = batch.q_start + np.array(
            [mgr.q_code_start[(m[0], strand)] for m in batch.meta], np.int64)
        T = cfg.first_tile_size
        res = first_tile_scores(self.ref_codes, mgr.q_codes_dev,
                                batch.r_start, batch.r_size, q_start,
                                batch.q_size, self.params, qt=T, rt=T)
        return batch, n, res

    def _filter_collect(self, dispatched, counters):
        """Fetch + threshold + slope filter for one strand's tiles."""
        cfg = self.cfg
        batch, n, res = dispatched
        if n == 0:
            return []
        scores, qmax, rmax = res["packed"].cpu().numpy()
        counters["num_extend_requests"] += int(
            (scores >= cfg.first_tile_score_threshold).sum())
        locs = flt.collect_locations(batch, scores, rmax, qmax, self.store,
                                     cfg)
        return flt.slope_filter(locs, cfg, counters)

    def align_batch(self, reads: List[Read], counters=None) -> List[str]:
        """Seed, filter, extend and print one batch of reads."""
        cfg = self.cfg
        if counters is None:
            counters = self.counters
        counters["num_reads"] += len(reads)
        mgr = ExtensionManager(self.store, reads, cfg, self.params,
                               self.ref_codes)
        seeded = self.seeder.seed_batch(reads)
        counters["num_queried_buckets"] += seeded.n_queried_buckets
        counters["num_capped_buckets"] += seeded.n_capped_buckets
        fw_d = self._filter_dispatch(reads, seeded.fw_anchors, "+",
                                     counters, mgr)
        rc_d = self._filter_dispatch(reads, seeded.rc_anchors, "-",
                                     counters, mgr)
        fw_locs = self._filter_collect(fw_d, counters)
        rc_locs = self._filter_collect(rc_d, counters)

        # per read, per strand (fw then rc), slope-filter order kept — the
        # reference's effective one-read batches
        fw_by_read = [[] for _ in reads]
        rc_by_read = [[] for _ in reads]
        for loc in fw_locs:
            fw_by_read[loc.read_num].append(loc)
        for loc in rc_locs:
            rc_by_read[loc.read_num].append(loc)
        groups = []
        for i in range(len(reads)):
            groups.append((i, "+", fw_by_read[i]))
            groups.append((i, "-", rc_by_read[i]))
        emitted = mgr.run(groups, reads, counters)
        alignments = []
        for i in range(len(reads)):
            alignments.extend(emitted[2 * i])
            alignments.extend(emitted[2 * i + 1])
        if cfg.do_overlap:
            return printer.mhap_lines(alignments, reads, self.store, cfg)
        return printer.sam_lines(alignments, reads, self.store)


def run(ref_path: str, reads_path: str, do_overlap: bool,
        cfg: Config | None = None, out=None, err=None,
        reads_per_batch: int = 128, device="cuda") -> dict:
    """Align ``reads_path`` against ``ref_path`` on ``device``; SAM
    (``do_overlap`` false) or MHAP (true; ``ref_path`` is then a reads
    file too, usually the same one) to ``out``, progress and counters to
    ``err``.  Read batches run one at a time (darwin_tpu's default
    overlaps two; outputs are the same at any depth).  Returns the counter
    dict."""
    dev = resolve_device(device)
    out = out or sys.stdout
    err = err or sys.stderr
    cfg = cfg or Config()
    cfg.do_overlap = do_overlap

    print("Loading reference genome ...", file=err)
    t0 = time.time()
    store = load_genome(ref_path)
    print(f"Reference length: {store.size}", file=err)
    print(f"Time elapsed (loading reference): "
          f"{int((time.time() - t0) * 1000)} msec", file=err)

    print("Finalizing seed position table ...", file=err)
    t0 = time.time()
    aligner = Aligner(cfg, store, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    index_s = time.time() - t0
    print(f"Time elapsed (finalizing seed position table): "
          f"{int(index_s * 1000)} msec", file=err)

    print("Aligning reads ...", file=err)
    t0 = time.time()
    header_done = False
    for batch in iter_read_batches(reads_path, reads_per_batch):
        lines = aligner.align_batch(batch)
        if lines and not do_overlap and not header_done:
            out.write(printer.sam_header(store))
            header_done = True
        out.writelines(lines)
    align_s = time.time() - t0
    c = aligner.counters
    print(f"#reads: {c['num_reads']}", file=err)
    print(f"#filter tiles: {c['num_filter_tiles']}", file=err)
    print(f"#extend requests: {c['num_extend_requests']}", file=err)
    print(f"#slope filtered: {c['num_slope_filtered']}", file=err)
    print(f"#extend tiles: {c['num_extend_tiles']}", file=err)
    print(f"#active tiles: {c['num_active_tiles']}", file=err)
    print(f"#large tiles: {c['num_large_tiles']}", file=err)
    # non-reference telemetry, prefixed so nothing mistakes it for the
    # reference's counter block (software/main.cpp:713-719) above
    print(f"[darwin_tpu_torch] device: {dev}  #extend rounds: "
          f"{c['num_extend_rounds']}", file=err)
    print(f"[darwin_tpu_torch] #queried buckets: {c['num_queried_buckets']}"
          f"  #occupancy-capped: {c['num_capped_buckets']}", file=err)
    print("[darwin_tpu_torch] kernel launches: " + "  ".join(
        f"{k}={v}" for k, v in LAUNCHES.items()), file=err)
    print(f"Time elapsed (aligning reads): {int(align_s * 1000)} msec",
          file=err)
    return c
