"""End-to-end entry points, both modes (counterpart of
``darwin_tpu/pipeline/align.py``'s ``Aligner`` and ``run``).

Index phase: reference FASTA -> GenomeStore -> SeedTable on the device (in
overlap mode the "reference" is the reads file itself).
Align phase, per read batch: Seeder (device D-SOFT + host chaining) ->
filter (device first tiles + host slope filter) -> ExtensionManager (device
GACT tiles + host decode) -> SAM (reference-guided) or MHAP (overlap).
stdout and the 7-line counter block are byte-identical to darwin_tpu's,
at any speculative chain depth and any number of batches in flight.

The seed table is either layout (``index_layout``, ``--index-layout``);
both give the same output.  With a mesh (``mesh``, ``--mesh``) every tile
batch is split over several devices (``parallel/shard.py``) and the pairs
table may be sharded by hash range over them (``shard_index``,
``--shard-index``; ``parallel/shard_index.py``); ``reads_range`` aligns one
slice of the reads file (a multi-host run's, ``parallel/multihost.py``).
The output is the same in every case.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import itertools
import os
import sys
import threading
import time
from typing import List

import numpy as np
import torch

from darwin_tpu_torch import native
from darwin_tpu_torch.config import Config
from darwin_tpu_torch.genome import GenomeStore, Read, encode5
from darwin_tpu_torch.io.fasta import iter_read_batches, load_genome
from darwin_tpu_torch.pipeline import filter as flt
from darwin_tpu_torch.index.seed_table import SeedTable, build_seed_table
from darwin_tpu_torch.ops import build, dispatch, gact
from darwin_tpu_torch.ops.dispatch import SPEC_K
from darwin_tpu_torch.ops.gact_cuda import LAUNCHES
from darwin_tpu_torch.parallel.shard import Mesh, MeshDispatcher, make_mesh
from darwin_tpu_torch.pipeline import printer
from darwin_tpu_torch.pipeline.extend import ExtensionManager
from darwin_tpu_torch.seeding.seeder import Seeder
from darwin_tpu_torch.utils import stages
from darwin_tpu_torch.utils.device import resolve_device
from darwin_tpu_torch.utils.stages import mark
from darwin_tpu_torch.utils.turns import HostTurns, fetch


def new_counters():
    return {
        "num_reads": 0,
        "num_filter_tiles": 0,
        "num_extend_requests": 0,
        "num_slope_filtered": 0,
        "num_extend_tiles": 0,
        "num_active_tiles": 0,
        "num_large_tiles": 0,
        # non-reference telemetry, printed after the counter block:
        # speculative-chain acceptance, extension rounds, and the tiles
        # the extension table decoded in how many calls
        "num_spec_hits": 0,
        "num_spec_misses": 0,
        "num_extend_rounds": 0,
        "num_decoded_tiles": 0,
        "num_decode_calls": 0,
        "num_queried_buckets": 0,
        "num_capped_buckets": 0,
        # overlap mode: the fates of the extended alignments in the MHAP
        # printer's selection (printer.mhap_lines)
        "num_mhap_printed": 0,
        "num_mhap_self": 0,
        "num_mhap_short": 0,
        "num_mhap_unselected": 0,
        "mhap_columns_printed": 0,
        "mhap_columns_dropped": 0,
    }


def counter_block(c) -> list[str]:
    """The reference's 7-line counter block (software/main.cpp:713-719)
    of the counters ``c``, as run() prints it."""
    return [f"#reads: {c['num_reads']}",
            f"#filter tiles: {c['num_filter_tiles']}",
            f"#extend requests: {c['num_extend_requests']}",
            f"#slope filtered: {c['num_slope_filtered']}",
            f"#extend tiles: {c['num_extend_tiles']}",
            f"#active tiles: {c['num_active_tiles']}",
            f"#large tiles: {c['num_large_tiles']}"]


class Aligner:
    """Thread-sharing contract: ``run(pipeline_depth=2)`` calls
    ``align_batch`` from two threads on one Aligner.  Per-batch state stays
    in the per-call ``counters`` and stage dicts; the shared stage totals
    are merged under a lock; the seed table, genome codes and scoring are
    read-only.

    ``stage_seconds``: host seconds per stage over all batches
    (``read_upload``, ``seed``, ``filter``, ``extend``, ``print`` and the
    sub-stages nested in them: the seeder's, the filter's ``filter_build``,
    ``filter_fetch`` and ``filter_collect``, the extension manager's, the
    printer's ``print_select`` and ``print_format``);
    ``stage_seconds_cold``: the first batch's alone."""

    def __init__(self, cfg: Config, store: GenomeStore,
                 table: SeedTable | None = None, device="cuda",
                 spec_k: int = SPEC_K, index_layout: str = "pairs",
                 mesh: Mesh | None = None, shard_index: bool = False):
        """index_layout: the layout of the table built when ``table`` is
        None, 'pairs' or 'csr' (index.seed_table.SeedTable).  mesh: split
        every tile batch over its devices (``mesh_dispatch``, a
        parallel.shard.MeshDispatcher; the genome replicated on them);
        shard_index: also shard the pairs table by hash range over it
        (ignored without a mesh)."""
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1: {spec_k}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.store = store
        self.spec_k = spec_k
        self.table = table or build_seed_table(store, cfg, self.device,
                                               layout=index_layout)
        if self.table.positions.device != self.device:
            raise ValueError(f"seed table is on {self.table.positions.device}"
                             f", the aligner on {self.device}")
        self.seeder = Seeder(self.table, cfg,
                             mesh=mesh if shard_index else None)
        self.params = gact.make_params(cfg)
        self.counters = new_counters()
        self.stage_seconds: dict = {}
        self.stage_seconds_cold: dict = {}
        self._batch_seq = 0
        self._stage_lock = threading.Lock()
        # genome codes + the extender's large-tile 'N' margin, uploaded once
        # (one buffer serves the filter and every extension gather)
        bases = store.bases_with_margin(4 * cfg.large_tile_long)
        self.ref_codes = torch.from_numpy(encode5(bases)).to(self.device)
        self.mesh_dispatch = None
        if mesh is not None:
            self.mesh_dispatch = MeshDispatcher(mesh)
            self.ref_codes = self.mesh_dispatch.replicate(self.ref_codes)

    def _filter_dispatch(self, reads, anchors_per_read, strand, counters,
                         mgr, tacc):
        """Enqueue one strand's first tiles (software/filter.cpp:8-228);
        both strands dispatch before either is fetched."""
        cfg = self.cfg
        t0 = time.perf_counter()
        batch = flt.build_first_tiles(reads, anchors_per_read, self.store,
                                      cfg)
        n = len(batch.meta)
        counters["num_filter_tiles"] += n
        if n == 0:
            mark(tacc, "filter_build", t0)
            return batch, 0, None
        q_start = batch.q_start + np.array(
            [mgr.q_code_start[(m[0], strand)] for m in batch.meta], np.int64)
        T = cfg.first_tile_size
        res = (self.mesh_dispatch or dispatch).first_tile_scores(
            self.ref_codes, mgr.q_codes_dev, batch.r_start, batch.r_size,
            q_start, batch.q_size, self.params, qt=T, rt=T)
        mark(tacc, "filter_build", t0)
        return batch, n, res

    def _filter_collect(self, dispatched, counters, tacc):
        """Fetch + threshold + slope filter for one strand's tiles."""
        cfg = self.cfg
        batch, n, res = dispatched
        if n == 0:
            return []
        t0 = time.perf_counter()
        scores, qmax, rmax = fetch(res["packed"])
        t0 = mark(tacc, "filter_fetch", t0)
        counters["num_extend_requests"] += int(
            (scores >= cfg.first_tile_score_threshold).sum())
        locs = flt.collect_locations(batch, scores, rmax, qmax, self.store,
                                     cfg)
        out = flt.slope_filter(locs, cfg, counters)
        mark(tacc, "filter_collect", t0)
        return out

    def align_batch(self, reads: List[Read], counters=None) -> List[str]:
        """Seed, filter, extend and print one batch of reads.  counters:
        this batch's counter dict (two batches in flight must not share
        one); the Aligner's own by default."""
        cfg = self.cfg
        if counters is None:
            counters = self.counters
        counters["num_reads"] += len(reads)
        with self._stage_lock:
            first_batch = self._batch_seq == 0
            self._batch_seq += 1
        tacc: dict = {}          # this call's; merged under the lock
        t0 = time.perf_counter()
        mgr = ExtensionManager(self.store, reads, cfg, self.params,
                               self.ref_codes, spec_k=self.spec_k,
                               stage_seconds=tacc,
                               mesh_dispatch=self.mesh_dispatch)
        t0 = mark(tacc, "read_upload", t0)
        seeded = self.seeder.seed_batch(reads, stage_seconds=tacc)
        counters["num_queried_buckets"] += seeded.n_queried_buckets
        counters["num_capped_buckets"] += seeded.n_capped_buckets
        t0 = mark(tacc, "seed", t0)
        fw_d = self._filter_dispatch(reads, seeded.fw_anchors, "+",
                                     counters, mgr, tacc)
        rc_d = self._filter_dispatch(reads, seeded.rc_anchors, "-",
                                     counters, mgr, tacc)
        fw_locs = self._filter_collect(fw_d, counters, tacc)
        rc_locs = self._filter_collect(rc_d, counters, tacc)
        t0 = mark(tacc, "filter", t0)

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
        t0 = mark(tacc, "extend", t0)
        alignments = []
        for i in range(len(reads)):
            alignments.extend(emitted[2 * i])
            alignments.extend(emitted[2 * i + 1])
        if cfg.do_overlap:
            lines = printer.mhap_lines(alignments, reads, self.store, cfg,
                                       counters, tacc)
        else:
            lines = printer.sam_lines(alignments, reads, self.store, tacc)
        mark(tacc, "print", t0)
        with self._stage_lock:
            for k, v in tacc.items():
                self.stage_seconds[k] = self.stage_seconds.get(k, 0.0) + v
            if first_batch:
                self.stage_seconds_cold = dict(tacc)
        return lines


def _load_index(index_cache, store, cfg, dev, err, index_layout):
    """The seed table in ``index_cache`` when it matches the reference,
    the config and the layout asked for, if any (darwin_tpu/pipeline/
    align.py:420-433), else None."""
    if index_cache is None or not os.path.exists(index_cache):
        return None
    table = SeedTable.load(index_cache, device=dev)
    if (table.kmer_size != cfg.seed_size
            or table.minimizer_window != cfg.minimizer_window
            or table.ref_size != store.size
            or index_layout not in (None, table.layout)):
        print(f"index cache {index_cache} does not match the "
              "reference/config; rebuilding", file=err)
        return None
    return table


def _in_flight(devices, spans):
    """The worker threads' call of align_batch: the batches take turns on
    the host (utils.turns), and on CUDA each worker thread launches on a
    stream of its own on each of ``devices`` (the aligner's and its
    mesh's), made to wait once on the stream that uploaded the genome, its
    replicas and the index there, so that one batch's fetch does not wait
    for the other batch's kernels.  The first device is left current.
    ``call(seq, fn, *a)``: with ``spans`` (a utils.stages.Spans) the
    worker records batch ``seq``'s spans, its first wait for the turn
    (``wait_turn``) included."""
    turns = HostTurns()
    cards = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
    main = {d: torch.cuda.current_stream(d) for d in cards}
    local = threading.local()

    def call(seq, fn, *a):
        with stages.bound(spans, seq), contextlib.ExitStack() as stack:
            t0 = time.perf_counter()
            stack.enter_context(turns.turn())
            mark(None, "wait_turn", t0)
            streams = getattr(local, "streams", None)
            if streams is None:
                streams = local.streams = [torch.cuda.Stream(d)
                                           for d in cards]
                for s in streams:
                    s.wait_stream(main[s.device])
            # entering a stream makes its device current: the first last
            for s in reversed(streams):
                stack.enter_context(torch.cuda.stream(s))
            return fn(*a)
    return call


def _resolve_mesh(mesh, dev):
    """run()'s mesh parameter -> a Mesh, or None for one device
    (darwin_tpu/pipeline/align.py:320-349).  None / 'auto' takes the
    power-of-two floor of the local cards when ``dev`` is a card and there
    is more than one, else one device; 'off', 0 and 1 give one device; N
    builds a mesh of N devices of ``dev``'s type (make_mesh: N distinct
    cards, raising when fewer exist; N entries of the CPU for a CPU run);
    a Mesh is used as given."""
    if isinstance(mesh, Mesh):
        return mesh
    if mesh in ("off", 0, 1):
        return None
    if mesh in (None, "auto"):
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
        return make_mesh(1 << (n.bit_length() - 1)) if n > 1 else None
    n = int(mesh)
    if n < 2:
        return None
    return make_mesh(n, dev.type)


def run(ref_path: str, reads_path: str, do_overlap: bool,
        cfg: Config | None = None, out=None, err=None,
        reads_per_batch: int = 128, device="cuda", pipeline_depth: int = 2,
        index_cache: str | None = None, stats_out: dict | None = None,
        spec_k: int = SPEC_K, index_layout: str | None = None,
        mesh=None, shard_index: bool = False,
        reads_range: tuple[int, int] | None = None) -> dict:
    """Align ``reads_path`` against ``ref_path`` on ``device``; SAM
    (``do_overlap`` false) or MHAP (true; ``ref_path`` is then a reads
    file too, usually the same one) to ``out``, progress and counters to
    ``err``.  Returns the counter dict.

    pipeline_depth: read batches in flight (darwin_tpu/pipeline/align.py:
    456-490), each on a worker thread: one batch's host work runs while
    another waits for the card (utils.turns); output and counters are
    collected in submission order, so they are the same at any depth.
    spec_k: tiles per speculative extension chain (1: none); outputs are
    the same at any depth.  index_layout: 'pairs' or 'csr' builds that
    seed-table layout; None builds pairs and takes a cache of either.
    index_cache: an .npz seed table, loaded when it matches the reference,
    ``seed_size`` / ``minimizer_window`` and the layout asked for, else
    built and written there.  stats_out: filled with ``align_seconds``,
    ``index_seconds``, ``index_build`` (the table's ``build_stats``),
    ``stage_seconds`` (``Aligner.stage_seconds``), ``stage_seconds_cold``
    (the first batch), ``stage_seconds_warm`` (the rest), ``counters`` and
    ``compile_s`` (seconds this process spent building the native and the
    CUDA libraries), and on a mesh ``mesh``: its devices, and per shard
    the kernel launches and lanes of its dispatches, and the copies that
    crossed between two devices.  Under torch.profiler (on the calling
    thread, when run() starts) stats_out also gets ``spans``
    (utils.stages.Spans.table(): every stage, sub-stage and wait of every
    batch, run()'s own ``run_parse`` / ``run_wait`` / ``run_write`` and
    the collector's ``gc``, with two ``darwin.clock`` anchors that map
    them onto the trace's clock).

    mesh: None / 'auto', 'off', N or a parallel.shard.Mesh
    (``_resolve_mesh``): every tile batch split over the mesh's devices;
    shard_index: the pairs table also sharded by hash range over them.
    reads_range: (start, stop) aligns only that slice of the reads (those
    ``load_reads`` would keep), a multi-host run's share."""
    if pipeline_depth < 1:
        raise ValueError(f"pipeline_depth must be >= 1: {pipeline_depth}")
    if index_layout not in (None, "pairs", "csr"):
        raise ValueError(f"unknown index layout {index_layout!r}")
    dev = resolve_device(device)
    # spans only for a run under torch.profiler that reports its stats
    spans = (stages.Spans() if stats_out is not None
             and torch._C._autograd._profiler_enabled() else None)
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
    table = _load_index(index_cache, store, cfg, dev, err, index_layout)
    mesh_obj = _resolve_mesh(mesh, dev)
    if mesh_obj is not None:
        print(f"[darwin_tpu_torch] mesh: {len(mesh_obj)} devices"
              f"{' (sharded index)' if shard_index else ''}", file=err)
    aligner = Aligner(cfg, store, table=table, device=dev, spec_k=spec_k,
                      index_layout=index_layout or "pairs", mesh=mesh_obj,
                      shard_index=shard_index)
    if index_cache is not None and table is None:
        aligner.table.save(index_cache)
        print(f"Seed table saved to {index_cache}", file=err)
    for d in {dev, *(mesh_obj or ())}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    index_s = time.time() - t0
    print(f"Time elapsed (finalizing seed position table): "
          f"{int(index_s * 1000)} msec", file=err)

    print("Aligning reads ...", file=err)
    t0 = time.time()
    header_done = False
    c = aligner.counters
    inflight = collections.deque()

    def drain():
        nonlocal header_done
        fut, cnt, seq = inflight.popleft()
        t1 = time.perf_counter()
        lines = fut.result()
        t1 = mark(None, "run_wait", t1, seq)
        for k, v in cnt.items():
            c[k] += v
        if lines and not do_overlap and not header_done:
            out.write(printer.sam_header(store))
            header_done = True
        out.writelines(lines)
        mark(None, "run_write", t1, seq)

    in_flight = _in_flight([dev, *(mesh_obj or ())], spans)
    start, stop = reads_range or (None, None)
    batches = iter_read_batches(reads_path, reads_per_batch, start=start,
                                stop=stop)
    with stages.recording(spans), \
            concurrent.futures.ThreadPoolExecutor(pipeline_depth) as pool:
        for seq in itertools.count():
            t1 = time.perf_counter()
            batch = next(batches, None)
            mark(None, "run_parse", t1, seq)
            if batch is None:
                break
            cnt = new_counters()
            if pipeline_depth > 1:
                fut = pool.submit(in_flight, seq, aligner.align_batch, batch,
                                  cnt)
            else:       # on the calling thread and its stream
                fut = concurrent.futures.Future()
                with stages.bound(spans, seq):
                    fut.set_result(aligner.align_batch(batch, cnt))
            inflight.append((fut, cnt, seq))
            if len(inflight) >= pipeline_depth:
                drain()
        while inflight:
            drain()
    align_s = time.time() - t0
    for line in counter_block(c):
        print(line, file=err)
    # non-reference telemetry, prefixed so nothing mistakes it for the
    # reference's counter block (software/main.cpp:713-719) above
    h, m = c["num_spec_hits"], c["num_spec_misses"]
    rate = f"{h / (h + m):.3f}" if h + m else "n/a"
    print(f"[darwin_tpu_torch] device: {dev}", file=err)
    print(f"[darwin_tpu_torch] #spec hits: {h}  #spec misses: {m}  "
          f"hit rate: {rate}  #extend rounds: {c['num_extend_rounds']}  "
          f"#decoded tiles: {c['num_decoded_tiles']}  #decode calls: "
          f"{c['num_decode_calls']}", file=err)
    print(f"[darwin_tpu_torch] #queried buckets: {c['num_queried_buckets']}"
          f"  #occupancy-capped: {c['num_capped_buckets']}", file=err)
    if do_overlap:
        print(f"[darwin_tpu_torch] #mhap printed: {c['num_mhap_printed']}  "
              f"#self: {c['num_mhap_self']}  #short: {c['num_mhap_short']}  "
              f"#unselected: {c['num_mhap_unselected']}  columns printed: "
              f"{c['mhap_columns_printed']}  columns dropped: "
              f"{c['mhap_columns_dropped']}", file=err)
    print("[darwin_tpu_torch] kernel launches: " + "  ".join(
        f"{k}={v}" for k, v in LAUNCHES.items()), file=err)
    print(f"Time elapsed (aligning reads): {int(align_s * 1000)} msec",
          file=err)
    if stats_out is not None:
        total = aligner.stage_seconds
        cold = aligner.stage_seconds_cold
        stats_out["align_seconds"] = align_s
        stats_out["index_seconds"] = index_s
        stats_out["index_build"] = dict(aligner.table.build_stats)
        stats_out["stage_seconds"] = dict(total)
        stats_out["stage_seconds_cold"] = dict(cold)
        stats_out["stage_seconds_warm"] = {
            k: v - cold.get(k, 0.0) for k, v in total.items()}
        stats_out["counters"] = dict(c)
        stats_out["compile_s"] = (native.BUILD_INFO["seconds"]
                                  + build.BUILD_INFO.get("seconds", 0.0))
        if spans is not None:
            stats_out["spans"] = spans.table()
        md = aligner.mesh_dispatch
        if md is not None:
            stats_out["mesh"] = {"devices": [str(d) for d in md.mesh],
                                 "launches": md.launches,
                                 "lanes": md.lanes,
                                 "cross_copies": md.cross_copies}
    return c
