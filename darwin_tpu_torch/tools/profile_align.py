"""Where the align phase's time goes, on one CUDA card.

    python -m darwin_tpu_torch.tools.profile_align [--out DIR] \
        [--case ecoli|ecoli_generic|overlap]

Writes one of ``chip_smoke.py``'s real-size cases (seed 0) — ``ecoli``:
the E. coli K-12-size reference-guided case of phase 5
(``utils.synth.ecoli_case``); ``ecoli_generic``: the same with the
generic-scoring ``params.cfg`` of phase 6; ``overlap``: the reads-vs-reads
case of phase 7 (``utils.synth.overlap_case``) — and aligns it ``RUNS``
times in one process through ``pipeline.align.run`` on ``cuda``.  The
first run is cold: it builds the kernels unless ``_build/`` already holds
them.

Per run it prints the align phase's seconds and reads/s and the host
seconds of each stage.  Stages are timed by wrapping the port's functions
from outside (see ``STAGES``); nothing in the pipeline is instrumented.
They nest (``ext_native_decode`` is inside ``ext_decode_wave``, which is
inside ``extend_total``) and a stage that waits on the card includes
that wait.  ``gc_collections`` is the time Python's cyclic collector took
during the run, inside whichever stage it fell (a full collection beside
a run's data takes tens of milliseconds; one that falls between the two
events of an extension dispatch is counted in its device time).  ``ext.
device ms`` is ``ops.dispatch.EXT_STATS``'s: per extension dispatch, the
time between an event recorded before the DP launch and one after the
traceback launch.

The last run is under ``torch.profiler``: it prints the device self time
of each kernel, their sum, and the card's busy share — the union of the
device activity intervals over the wall time of ``run`` (index + align
phase; the profiler's own host cost is in that wall time).  With
``--out DIR`` the profiler's whole table goes to
``DIR/profile_table.txt``.  The last line is one JSON object of the
numbers printed.
"""

from __future__ import annotations

import argparse
import functools
import gc
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

import torch

from darwin_tpu_torch import native
from darwin_tpu_torch.config import Config, load_config
from darwin_tpu_torch.ops import dispatch
from darwin_tpu_torch.pipeline import align, extend, printer
from darwin_tpu_torch.seeding import seeder

# (stage, owner, attribute): owner.attribute is wrapped by a timer
STAGES = (
    ("read_upload", extend.ExtensionManager, "__init__"),
    ("seed_total", seeder.Seeder, "seed_batch"),
    ("seed_chain_native", seeder.chain, "chain_anchors"),
    ("filter_dispatch", align.Aligner, "_filter_dispatch"),
    ("filter_collect", align.Aligner, "_filter_collect"),
    ("extend_total", extend.ExtensionManager, "run"),
    ("ext_enqueue", extend, "extend_tiles_async"),
    ("ext_decode_wave", extend.ExtensionManager, "_decode_wave"),
    ("ext_native_decode", native, "decode_ops_batch_native"),
    ("print", printer, "sam_lines"),
    ("print", printer, "mhap_lines"),
)
# the resolve() closures ext_enqueue returns: fetch + record expansion
RESOLVE_STAGE = "ext_resolve_fetch_expand"
GC_STAGE = "gc_collections"
RUNS = 3          # cold, warm, and warm under the profiler


@contextmanager
def stage_timers():
    """Wrap every STAGES function with a host timer for the duration of
    the block; yields {stage: seconds}, filled as the block runs."""
    acc = {name: 0.0 for name, _, _ in STAGES}
    acc[RESOLVE_STAGE] = 0.0
    acc[GC_STAGE] = 0.0
    began = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            began[0] = time.perf_counter()
        else:
            acc[GC_STAGE] += time.perf_counter() - began[0]

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
            finally:
                acc[name] += time.perf_counter() - t0
            if name == "ext_enqueue":
                out = timed(RESOLVE_STAGE, out)
            return out
        return wrapper

    saved = []
    gc.callbacks.append(on_gc)
    try:
        for name, owner, attr in STAGES:
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, timed(name, fn))
        yield acc
    finally:
        gc.callbacks.remove(on_gc)
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


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


def _align_s(err_text: str) -> float:
    m = re.search(r"Time elapsed \(aligning reads\): (\d+) msec", err_text)
    return int(m.group(1)) / 1000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for profile_table.txt")
    ap.add_argument("--case", default="ecoli",
                    choices=("ecoli", "ecoli_generic", "overlap"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_align: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from darwin_tpu_torch.utils import synth
    summary = {"card": smi, "case": args.case, "runs": []}
    overlap = args.case == "overlap"
    with tempfile.TemporaryDirectory() as tmp:
        ref, reads = f"{tmp}/ref.fa", f"{tmp}/reads.fa"
        cfg = Config()
        if overlap:
            truth = synth.overlap_case(0, tmp)
            ref = reads
        else:
            truth = synth.ecoli_case(0, tmp)
        if args.case == "ecoli_generic":
            with open(f"{tmp}/params.cfg", "w") as f:
                f.write(synth.GENERIC_PARAMS_CFG)
            cfg = load_config(f"{tmp}/params.cfg")
        for i in range(RUNS):
            last = i == RUNS - 1
            out, err = io.StringIO(), io.StringIO()
            dispatch.reset_ext_stats()
            with stage_timers() as acc:
                if last:
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        t0 = time.perf_counter()
                        align.run(ref, reads, overlap, cfg=cfg, out=out,
                                  err=err, device="cuda")
                        torch.cuda.synchronize()
                        wall = time.perf_counter() - t0
                else:
                    align.run(ref, reads, overlap, cfg=cfg, out=out,
                              err=err, device="cuda")
            align_s = _align_s(err.getvalue())
            row = {"align_s": align_s, "reads_per_s": len(truth) / align_s,
                   "ext_device_ms": dispatch.EXT_STATS["device_ms"],
                   "stages_s": dict(sorted(acc.items(),
                                           key=lambda kv: -kv[1]))}
            print(f"run {i}{' (profiled)' if last else ''}: align "
                  f"{align_s:.3f} s -> {row['reads_per_s']:.1f} reads/s, "
                  f"ext. device ms {row['ext_device_ms']:.1f}", flush=True)
            print("   stages (host s): " + ", ".join(
                f"{k}={v:.3f}" for k, v in row["stages_s"].items()),
                flush=True)
            summary["runs"].append(row)
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
    summary.update(device_self_ms=dev_ms, device_busy_ms=busy,
                   profiled_wall_ms=wall * 1000, kernels=[
                       {"name": e.key[:120], "count": e.count,
                        "self_ms": e.self_device_time_total / 1000}
                       for e in kernels[:12]])
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
