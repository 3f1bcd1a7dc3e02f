"""Where the align phase's time goes, on one CUDA card.

    python -m darwin_tpu_torch.tools.profile_align [--out DIR] \
        [--case ecoli|ecoli_generic|overlap|chr21] [--spec-k K] \
        [--pipeline-depth D] [--index-layout pairs|csr]
    python -m darwin_tpu_torch.tools.profile_align --chain-launches

Writes one of ``chip_smoke.py``'s real-size cases (seed 0) — ``ecoli``:
the E. coli K-12-size reference-guided case of phase 5
(``utils.synth.ecoli_case``); ``ecoli_generic``: the same with the
generic-scoring ``params.cfg`` of phase 6; ``overlap``: the reads-vs-reads
case of phase 7 (``utils.synth.overlap_case``); ``chr21``: the repeat
genome of phase 10 (``utils.synth.chr21_case``) — and aligns it ``RUNS``
times in one process through ``pipeline.align.run`` on ``cuda``, at
run()'s defaults or the given speculative chain depth, batches in flight
and index layout.  The first run is cold: it builds the kernels unless
``_build/`` already holds them.

Per run it prints the index build's seconds (run()'s "finalizing seed
position table" line), the align phase's seconds and reads/s, the
speculative chains' hits, misses and extension rounds, and the host
seconds of each stage as ``run(..., stats_out=...)`` reports them (``Aligner.
stage_seconds``: ``read_upload``, ``seed``, ``filter``, ``extend``,
``print`` and the stages nested in them — ``seed_*`` in ``seed``,
``extend_*`` in ``extend``, ``ru_*`` in ``read_upload``).  With two read
batches in flight the stages of both batches add up, so their sum exceeds
the align phase's wall time.  In the profiled run, ``gc_collections``
is the time Python's cyclic collector took, inside whichever stage it fell
(a full collection beside a run's data takes tens of milliseconds): the
``gc`` spans run() records under the profiler (``utils.stages.Spans``).

The last run is under ``torch.profiler``: it prints the device self time
of each kernel, their sum, the same by group (``gact_dp``, ``gact_tb``,
``gact_next``, copies, memsets, and the other — torch's — kernels, the
largest of them named), and the card's busy share — the union of the
device activity intervals over the wall time of ``run`` (index + align
phase; the profiler's own host cost is in that wall time).  A last run,
one batch in flight and not timed, counts the torch ops that run on the
card by the module of the package that called them (``OpsByModule``), so
with another checkout's package first on ``PYTHONPATH`` it counts that
checkout's.

``--chain-launches`` instead counts the device launches (kernels, copies,
memsets) one speculative dispatch of 512 lanes enqueues, at K = 2 and
K = 12, under ``torch.profiler``: the difference over 10 is the launches
per chain level, the rest the dispatch's fixed part.  It calls only
``ops.dispatch.extend_tiles_spec_async``, so with another checkout's
package first on ``PYTHONPATH`` it counts that checkout's chains.  With
``--out DIR`` the profiler's whole table goes to
``DIR/profile_table.txt``.  The last line is one JSON object of the
numbers printed.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from darwin_tpu_torch.config import Config, load_config
from darwin_tpu_torch.ops import dispatch
from darwin_tpu_torch.pipeline import align

GC_STAGE = "gc_collections"
RUNS = 3          # cold, warm, and warm under the profiler


def run_row(stats, n_reads) -> dict:
    """One run's JSON row from ``run``'s stats_out; a profiled run's
    stages also hold the collector's time (its ``gc`` spans)."""
    c = stats["counters"]
    stages = dict(stats["stage_seconds"])
    if "spans" in stats:
        stages[GC_STAGE] = sum(e - s for k, _, _, s, e in
                               stats["spans"]["spans"] if k == "gc") / 1e9
    return {"align_s": stats["align_seconds"],
            "reads_per_s": n_reads / stats["align_seconds"],
            "spec_hits": c["num_spec_hits"],
            "spec_misses": c["num_spec_misses"],
            "extend_rounds": c["num_extend_rounds"],
            "stages_s": dict(sorted(stages.items(), key=lambda kv: -kv[1]))}


def _busy_ms(events) -> float:
    """Length of the union of the device activity intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1000


# the groups the profiled run's device time is itemized by: (group, the
# part of the profiler's event name that puts an event in it)
GROUPS = (("gact_dp", "gact_dp_kernel"), ("gact_tb", "gact_tb_kernel"),
          ("gact_next", "gact_next_kernel"), ("copies", "Memcpy"),
          ("memsets", "Memset"))


class OpsByModule(TorchDispatchMode):
    """Counts the torch ops that run on ``device_type`` by the module of
    this package whose code called them (the innermost frame under
    ``darwin_tpu_torch/``); views and allocations, which launch nothing,
    are not counted.  The profiler cannot give this split: it records the
    ops of the thread that started it only, and ties few launches to a
    Python frame.  Like any dispatch mode it sees the ops of the thread
    that entered it, so the run it counts keeps one batch in flight."""

    def __init__(self, device_type="cuda"):
        super().__init__()
        self.device_type = device_type
        self.counts: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or str(func).startswith("aten.empty"):
            return out
        tensors = [t for t in (*args, *(kwargs or {}).values(),
                               *(out if isinstance(out, (tuple, list))
                                 else (out,)))
                   if isinstance(t, torch.Tensor)]
        if not any(t.device.type == self.device_type for t in tensors):
            return out
        where = "(no frame of the package)"
        f = sys._getframe(1)
        while f is not None:
            name = f.f_code.co_filename.replace(os.sep, "/")
            if "darwin_tpu_torch/" in name:
                where = name.rsplit("darwin_tpu_torch/", 1)[1]
                break
            f = f.f_back
        self.counts[where] = self.counts.get(where, 0) + 1
        return out


def group_of(name: str) -> str:
    return next((g for g, part in GROUPS if part in name), "other")


def by_group(kernels) -> dict:
    """{group: {"self_ms", "count"}} of the profiler's device rows, and
    under "other_top" the largest other kernels."""
    out = {g: {"self_ms": 0.0, "count": 0}
           for g in [g for g, _ in GROUPS] + ["other"]}
    for e in kernels:
        g = out[group_of(e.key)]
        g["self_ms"] += e.self_device_time_total / 1000
        g["count"] += e.count
    out["other_top"] = [
        {"name": e.key[:80], "count": e.count,
         "self_ms": e.self_device_time_total / 1000}
        for e in kernels if group_of(e.key) == "other"][:8]
    return out


def chain_launches(device="cuda", B=512, T=384, seed=0) -> dict:
    """Device launches of one speculative dispatch of B lanes at K = 2 and
    K = 12 (see the module docstring); random codes, both
    orientations."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from darwin_tpu_torch.ops import gact
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    n_ref, read = 4_000_000, 10_000
    ref = torch.from_numpy(rng.integers(0, 4, n_ref).astype(np.uint8)
                           ).to(dev)
    query = torch.from_numpy(rng.integers(0, 4, B * read).astype(np.uint8)
                             ).to(dev)
    rev = np.arange(B) % 2
    r_start = rng.integers(T, n_ref - 2 * T, B)
    q_buf = np.arange(B, dtype=np.int64) * read
    q_start = q_buf + rng.integers(T, read - 2 * T, B)
    size = np.full(B, T, np.int64)
    args = (ref, query, r_start, size, q_start, size, rev,
            np.zeros(B, np.int64), np.full(B, n_ref, np.int64), q_buf,
            np.full(B, read, np.int64), gact.make_params(Config()))
    kw = dict(qt=T, rt=T, max_tb=2 * T, stop_thr=T - Config().tile_overlap)
    counts = {}
    for K in (2, 12):
        dispatch.extend_tiles_spec_async(*args, K=K, **kw)()      # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            resolve = dispatch.extend_tiles_spec_async(*args, K=K, **kw)
            torch.cuda.synchronize()
        resolve()
        names = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                g = group_of(e.name)
                names[g] = names.get(g, 0) + 1
        counts[K] = names
    total = {K: sum(c.values()) for K, c in counts.items()}
    per_level = (total[12] - total[2]) / 10
    return {"lanes": B, "launches": {str(K): c for K, c in counts.items()},
            "per_level": per_level, "fixed": total[2] - 2 * per_level,
            "per_level_by_group": {
                g: (counts[12].get(g, 0) - counts[2].get(g, 0)) / 10
                for g in set(counts[12]) | set(counts[2])}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for profile_table.txt")
    ap.add_argument("--case", default="ecoli",
                    choices=("ecoli", "ecoli_generic", "overlap", "chr21"))
    ap.add_argument("--spec-k", type=int, default=dispatch.SPEC_K,
                    help="tiles per speculative chain (run()'s spec_k)")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="read batches in flight (run()'s pipeline_depth)")
    ap.add_argument("--index-layout", default=None,
                    choices=("pairs", "csr"),
                    help="seed-table layout (run()'s index_layout)")
    ap.add_argument("--chain-launches", action="store_true",
                    help="only count one speculative dispatch's launches "
                         "per chain level")
    args = ap.parse_args(argv)
    path = dict(spec_k=args.spec_k, pipeline_depth=args.pipeline_depth)
    if args.index_layout:
        path["index_layout"] = args.index_layout
    if not torch.cuda.is_available():
        print("profile_align: no CUDA device", file=sys.stderr)
        return 2
    if args.chain_launches:
        res = chain_launches()
        print(f"device launches per chain level: {res['per_level']} "
              f"({res['per_level_by_group']}); fixed part of a dispatch "
              f"{res['fixed']}", flush=True)
        print(json.dumps(res))
        return 0
    from torch.profiler import ProfilerActivity, profile
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from darwin_tpu_torch.utils import synth
    summary = {"card": smi, "case": args.case, **path, "runs": []}
    print(f"case {args.case}, spec_k={args.spec_k}, pipeline_depth="
          f"{args.pipeline_depth}", flush=True)
    overlap = args.case == "overlap"
    with tempfile.TemporaryDirectory() as tmp:
        ref, reads = f"{tmp}/ref.fa", f"{tmp}/reads.fa"
        cfg = Config()
        if overlap:
            truth = synth.overlap_case(0, tmp)
            ref = reads
        elif args.case == "chr21":
            truth = synth.chr21_case(0, tmp)
        else:
            truth = synth.ecoli_case(0, tmp)
        if args.case == "ecoli_generic":
            with open(f"{tmp}/params.cfg", "w") as f:
                f.write(synth.GENERIC_PARAMS_CFG)
            cfg = load_config(f"{tmp}/params.cfg")
        for i in range(RUNS):
            last = i == RUNS - 1
            out, err = io.StringIO(), io.StringIO()
            stats = {}
            if last:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    align.run(ref, reads, overlap, cfg=cfg, out=out,
                              err=err, device="cuda", stats_out=stats,
                              **path)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            else:
                align.run(ref, reads, overlap, cfg=cfg, out=out, err=err,
                          device="cuda", stats_out=stats, **path)
            row = run_row(stats, len(truth))
            m = re.search(r"finalizing seed position table\): (\d+) msec",
                          err.getvalue())
            row["index_s"] = int(m.group(1)) / 1000
            print(f"run {i}{' (profiled)' if last else ''}: index "
                  f"{row['index_s']:.3f} s, align "
                  f"{row['align_s']:.3f} s -> {row['reads_per_s']:.1f} "
                  f"reads/s; spec hits {row['spec_hits']}, misses "
                  f"{row['spec_misses']}, extend rounds "
                  f"{row['extend_rounds']}", flush=True)
            print("   stages (host s): " + ", ".join(
                f"{k}={v:.3f}" for k, v in row["stages_s"].items()),
                flush=True)
            summary["runs"].append(row)
        with OpsByModule() as ops:
            align.run(ref, reads, overlap, cfg=cfg, out=io.StringIO(),
                      err=io.StringIO(), device="cuda",
                      **dict(path, pipeline_depth=1))
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1000
    busy = _busy_ms(prof.events())
    print(f"   device self time {dev_ms:.1f} ms, busy (union) {busy:.1f} ms "
          f"over run() wall {wall * 1000:.1f} ms = "
          f"{busy / (wall * 1000):.4f} busy share (profiled run)")
    for e in kernels[:12]:
        print(f"   {e.self_device_time_total / 1000:9.2f} ms x "
              f"{e.count:5d}  {e.key[:90]}")
    groups = by_group(kernels)
    print("   by group: " + ", ".join(
        f"{g} {v['self_ms']:.2f} ms x {v['count']}"
        for g, v in groups.items() if g != "other_top"))
    print("   other, largest: " + "; ".join(
        f"{o['self_ms']:.2f} ms x {o['count']} {o['name'][:60]}"
        for o in groups["other_top"]))
    summary.update(device_self_ms=dev_ms, device_busy_ms=busy,
                   profiled_wall_ms=wall * 1000, kernels=[
                       {"name": e.key[:120], "count": e.count,
                        "self_ms": e.self_device_time_total / 1000}
                       for e in kernels[:12]], groups=groups)
    print(f"   torch ops on the card by module, pipeline_depth=1 "
          f"({sum(ops.counts.values())} in all): " + ", ".join(
              f"{m} {n}" for m, n in sorted(ops.counts.items(),
                                             key=lambda kv: -kv[1])))
    summary["torch_ops_by_module"] = ops.counts
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_table.txt"), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=60,
                max_name_column_width=120))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
