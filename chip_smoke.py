#!/usr/bin/env python3
"""Smoke test of darwin_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N] [--phases 1,2,3]

(--phases runs a subset — e.g. a short first call after a kernel change —
and then prints no result lines.)

Phases (each prints its lines; any failure raises, so the exit is nonzero):
  1. environment: torch, CUDA, nvcc, and the card's name and power limit;
  2. build the CUDA kernels from the checkout's csrc/ with nvcc (sm_90a);
  3. every kernel against its plain PyTorch twin on the card, at the main
     path's tile geometries, exact integer equality;
  4. a small end-to-end run on cuda and on cpu: SAM and counters identical;
  5. the main path at real size through the CLI: a synthetic genome of
     E. coli K-12 MG1655's length, 512 simulated 10 kb reads plus 16 with
     a planted 1.5 kb deletion; loci checked against the simulation, and
     every kernel's launch count from that run must be > 0.
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.  Needs one CUDA device; exits nonzero
without one.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

KERNELS = {
    "gact_dp": {"route": "cuda", "source": "darwin_tpu_torch/csrc/gact_dp.cu",
                "replaces": "darwin_tpu/ops/gact_pallas.py:103"},
    "gact_tb": {"route": "cuda", "source": "darwin_tpu_torch/csrc/gact_tb.cu",
                "replaces": "darwin_tpu/ops/gact_pallas.py:620"},
}


def say(phase, msg):
    print(f"[phase {phase}] {msg}", flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------- phase 1

def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from darwin_tpu_torch.ops import build
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    say(1, f"python {sys.version.split()[0]}  torch {torch.__version__}  "
           f"torch.version.cuda {torch.version.cuda}  "
           f"device {torch.cuda.get_device_name(0)} "
           f"x{torch.cuda.device_count()}")
    say(1, f"nvcc: {nvcc.splitlines()[-1]}")
    print(smi, flush=True)
    return smi


# ---------------------------------------------------------------- phase 2

def phase_build():
    from darwin_tpu_torch.ops import build
    t0 = time.perf_counter()
    build.load()
    say(2, f"built {os.path.relpath(build.BUILD_INFO['path'])} in "
           f"{time.perf_counter() - t0:.2f} s (nvcc "
           f"{build.BUILD_INFO['seconds']:.2f} s)")
    for ln in build.BUILD_INFO["log"].splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            say(2, "ptxas: " + ln.strip())


# ---------------------------------------------------------------- phase 3

def _tiles(rng, B, qt, rt, full_frac=0.5):
    """Ragged tiles with ~2% N codes; even tiles are a mutated copy of the
    ref tile (real alignments: long diagonals, indels), odd ones random;
    tile 0 has no query and tile 1 no ref."""
    acgt = np.arange(4, dtype=np.uint8)
    q = np.zeros((B, qt), np.uint8)
    r = np.zeros((B, rt), np.uint8)
    ql = np.empty(B, np.int32)
    rl = np.empty(B, np.int32)
    for b in range(B):
        full = rng.random() < full_frac
        ql[b] = qt if full else rng.integers(1, qt + 1)
        rl[b] = rt if full else rng.integers(1, rt + 1)
        rr = rng.integers(0, 4, rt).astype(np.uint8)
        if b % 2 == 0:
            keep = rng.random(rt) >= 0.03
            qq = rr[keep]
            subs = rng.random(len(qq)) < 0.04
            qq[subs] = (qq[subs] + rng.integers(1, 4, subs.sum())) % 4
            ins = np.flatnonzero(rng.random(len(qq)) < 0.03)
            qq = np.insert(qq, ins, rng.choice(acgt, len(ins)))
            qq = np.concatenate([qq, rng.integers(0, 4, qt).astype(np.uint8)])
        else:
            qq = rng.integers(0, 4, qt).astype(np.uint8)
        q[b] = qq[:qt]
        r[b] = rr
    q[rng.random(q.shape) < 0.02] = 4
    r[rng.random(r.shape) < 0.02] = 4
    # an empty side, as the extender asks for at a sequence end
    ql[0], rl[1] = 0, 0
    return q, r, ql, rl


def _time_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels(seed, kstats):
    from darwin_tpu.config import Config
    from darwin_tpu_torch.ops import gact, gact_cuda
    dev = torch.device("cuda", 0)
    params = gact.make_params(Config())
    rng = np.random.default_rng(seed)
    # (name, qt, rt, B, start_end); (qt, rt) = (query, ref) tile sides —
    # the escalation tiles are 1984 ref x 960 query and 960 x 1984
    geoms = [("filter max-cell", 128, 128, 256, False),
             ("extend start-to-end", 384, 384, 512, True),
             ("large tile", 960, 1984, 64, True),
             ("large tile", 1984, 960, 64, True)]
    for name, qt, rt, B, se in geoms:
        q, r, ql, rl = _tiles(rng, B, qt, rt)
        args = [torch.from_numpy(x).to(dev) for x in (q, r, ql, rl)]
        sev = torch.full((B,), se, dtype=torch.bool, device=dev)
        with_trace = se

        def kern():
            return gact_cuda.dp_tiles(*args, sev, params, with_trace)

        def plain():
            return gact.batch_align(*args, sev, params,
                                    with_trace=with_trace)

        k = kern()
        p = plain()
        torch.cuda.synchronize()
        err = 0
        for key in ("score", "query_max_pos", "ref_max_pos"):
            err = max(err, int((k[key] - p[key]).abs().max()))
        geo = f"{name} {rt}x{qt} (ref x query) B={B}"
        if with_trace:
            qi = torch.arange(qt, device=dev)
            ri = torch.arange(rt, device=dev)
            valid = ((ri[None, :, None] < args[3][:, None, None])
                     & (qi[None, None, :] < args[2][:, None, None]))
            diff = (k["trace"].int() - p["trace"].int()).abs() * valid
            err = max(err, int(diff.max()))
        check(err == 0, f"gact_dp != plain at {geo}: max |diff| {err}")
        reps = 20 if qt * rt * B <= 384 * 384 * 512 else 5
        kms = _time_ms(kern, reps)
        pms = _time_ms(plain, 1)
        cells = B * qt * rt
        say(3, f"gact_dp   {geo}: exact; kernel {kms:.3f} ms "
               f"({cells / kms / 1e6:.2f} GCUPS), plain {pms:.1f} ms")
        st = kstats["gact_dp"]
        st["max_abs_err"] = max(st.get("max_abs_err", 0), err)
        if (qt, rt, se) == (384, 384, True):
            st["ms"], st["plain_ms"] = kms, pms
        if not with_trace:
            continue
        max_tb = 768
        sq = (args[2] - 1).contiguous()
        sr = (args[3] - 1).contiguous()
        tr = k["trace"]

        def kern_tb():
            return gact_cuda.traceback_tiles(tr, sq, sr, max_tb)

        def plain_tb():
            return gact.traceback(tr, sq, sr, max_tb)

        kt = kern_tb()
        pt = plain_tb()
        torch.cuda.synchronize()
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(kt, pt))
        check(err == 0, f"gact_tb != plain at {geo}: max |diff| {err}")
        kms = _time_ms(kern_tb, reps)
        pms = _time_ms(plain_tb, 1)
        say(3, f"gact_tb   {geo} max_tb={max_tb}: exact; kernel "
               f"{kms:.3f} ms, plain {pms:.1f} ms")
        st = kstats["gact_tb"]
        st["max_abs_err"] = max(st.get("max_abs_err", 0), err)
        if (qt, rt) == (384, 384):
            st["ms"], st["plain_ms"] = kms, pms

    # two insert runs in one column: only exact gap-lane ties make these;
    # darwin_tpu's fast sweep (_tb_kernel) spills here and reruns the
    # safe one (tests/test_gact_pallas.py:175-200)
    tr = torch.zeros((1, 8, 32), dtype=torch.uint8)
    tr[0, 3, 5] = gact.T8_INS
    tr[0, 3, 4] = gact.T8_INS | gact.F_OPEN8
    tr[0, 3, 3] = gact.T8_INS_L | gact.FL_OPEN8
    tr[0, 3, 2] = gact.T8_DIAG
    sq = torch.tensor([5], dtype=torch.int32)
    sr = torch.tensor([3], dtype=torch.int32)
    kt = gact_cuda.traceback_tiles(tr.to(dev), sq.to(dev), sr.to(dev), 64)
    pt = gact.traceback(tr, sq, sr, 64)
    torch.cuda.synchronize()
    for a, b in zip(kt, pt):
        check(torch.equal(a.cpu(), b), "gact_tb != plain on the two-run tile")
    ops, n = gact.expand_records(kt[0].cpu().numpy(), 1, 40)
    check(ops[0, :n[0]].tolist() == [1, 1, 1, 3]
          and (int(kt[1][0]), int(kt[2][0])) == (4, 1),
          "two-run tile: walk is not I I I M")
    say(3, "gact_tb   two insert runs in one column: I I I M, exact")

    # an empty batch launches nothing, so the launch counts stay true
    before = dict(gact_cuda.LAUNCHES)
    e8 = torch.zeros((0, 128), dtype=torch.uint8, device=dev)
    e32 = torch.zeros(0, dtype=torch.int32, device=dev)
    res = gact_cuda.dp_tiles(e8, e8, e32, e32, e32.bool(), params, True)
    rec = gact_cuda.traceback_tiles(res["trace"], e32, e32, 768)[0]
    check(gact_cuda.LAUNCHES == before
          and tuple(res["trace"].shape) == (0, 128, 128)
          and tuple(rec.shape) == (128, 0),
          "an empty batch launched a kernel or gave misshapen outputs")
    say(3, "empty batch (B=0): no launch, empty outputs")


# ---------------------------------------------------------------- phase 4/5

def _counter_block(err_text):
    return [ln for ln in err_text.splitlines() if ln.startswith("#")]


def phase_parity(seed):
    """The same small run on cuda and on cpu: SAM and counters equal."""
    from darwin_tpu.utils.simulate import simulate_reads, write_fasta
    from darwin_tpu_torch.pipeline.align import run
    from darwin_tpu_torch.utils import synth
    rng = np.random.default_rng(seed + 1)
    store = synth.random_genome(rng, [("chrA", 120_000), ("chrB", 80_000)])
    sim = simulate_reads(store, 24, 3000, seed=seed + 2)
    with tempfile.TemporaryDirectory() as tmp:
        ref, reads = f"{tmp}/ref.fa", f"{tmp}/reads.fa"
        synth.write_reference(ref, store)
        write_fasta(reads, sim)
        res = {}
        for dev in ("cuda", "cpu"):
            out, err = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            run(ref, reads, False, out=out, err=err, device=dev)
            res[dev] = (out.getvalue(), _counter_block(err.getvalue()),
                        time.perf_counter() - t0)
    (sam_g, blk_g, t_g), (sam_c, blk_c, t_c) = res["cuda"], res["cpu"]
    n_rec = sum(1 for ln in sam_g.splitlines() if not ln.startswith("@"))
    check(n_rec > 0, "parity run produced no SAM records")
    check(sam_g == sam_c, "SAM differs between cuda and cpu")
    check(blk_g == blk_c, f"counters differ: {blk_g} vs {blk_c}")
    say(4, f"200 kb genome, 24 x 3 kb reads: SAM ({n_rec} records, "
           f"{len(sam_g)} bytes) and counter block identical on cuda "
           f"({t_g:.1f} s) and cpu ({t_c:.1f} s)")


def phase_real(seed, kstats, smi):
    """The slice at real size through the CLI, in-process so the kernel
    launch counts of exactly this run are read."""
    from darwin_tpu_torch import cli
    from darwin_tpu_torch.ops import dispatch, gact_cuda
    from darwin_tpu_torch.utils import synth
    with tempfile.TemporaryDirectory() as tmp:
        truth = synth.ecoli_case(seed, tmp)
        out, err = io.StringIO(), io.StringIO()
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            gact_cuda.reset_launches()
            dispatch.reset_ext_stats()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = cli.main(["ref.fa", "reads.fa", "0", "--device=cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(gact_cuda.LAUNCHES)
            ext = dict(dispatch.EXT_STATS)
        finally:
            os.chdir(cwd)
    check(rc == 0, f"cli exited {rc}")
    err_text = err.getvalue()

    best = {}
    n_rec = 0
    for ln in out.getvalue().splitlines():
        if ln.startswith("@"):
            continue
        f = ln.split("\t")
        n_rec += 1
        qlen = sum(int(x) for x, op in re.findall(r"(\d+)([SMID])", f[5])
                   if op in "SMI")
        check(qlen == len(f[9]), f"CIGAR of {f[0]} does not span the read")
        chrom, start, _ = truth[f[0]]
        if f[2] == chrom and abs(int(f[3]) - 1 - start) <= 200:
            best[f[0]] = True
    share = len(best) / len(truth)
    blk = _counter_block(err_text)
    large = int(next(ln for ln in blk if ln.startswith("#large tiles"))
                .split(":")[1])
    m = re.search(r"Time elapsed \(aligning reads\): (\d+) msec", err_text)
    align_s = int(m.group(1)) / 1000
    m = re.search(r"finalizing seed position table\): (\d+) msec",
                  err_text)
    index_s = int(m.group(1)) / 1000
    gcups = (ext["cells"] / ext["device_ms"] / 1e6 if ext["device_ms"]
             else float("nan"))
    say(5, f"{len(truth)} reads vs {synth.ECOLI_LEN} bp: {n_rec} SAM "
           f"records; {len(best)}/{len(truth)} = {share:.4f} reads on the "
           f"true locus (+-200 bp)")
    say(5, "counters: " + "; ".join(blk))
    say(5, f"kernel launches in this run: {launches}")
    say(5, f"index {index_s:.3f} s, align {align_s:.3f} s, cli wall "
           f"{wall:.1f} s: {len(truth) / align_s:.1f} reads/s "
           f"[{smi}]")
    say(5, f"extension DP+traceback: {ext['dispatches']} dispatches, "
           f"{ext['tiles']} tiles, {ext['cells']} cells in "
           f"{ext['device_ms']:.1f} ms device time = {gcups:.2f} GCUPS "
           f"[{smi}]")
    check(share >= 0.95, f"only {share:.4f} of reads on the true locus")
    check(large > 0, "no large tiles fired")
    for k in KERNELS:
        kstats[k]["launches"] = launches[k]
        check(launches[k] > 0, f"kernel {k} never launched on the main path")


# ---------------------------------------------------------------- main

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="1,2,3,4,5",
                    help="comma list (a partial run prints no result)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    import darwin_tpu_torch  # noqa: F401  (fails outside a checkout)
    phases = {int(p) for p in args.phases.split(",")}
    kstats = {k: {} for k in KERNELS}
    smi = phase_env() if 1 in phases else None
    if 2 in phases:
        phase_build()
    if 3 in phases:
        phase_kernels(args.seed, kstats)
    if 4 in phases:
        phase_parity(args.seed)
    if 5 in phases:
        phase_real(args.seed, kstats, smi)
    if phases != {1, 2, 3, 4, 5}:
        return 0
    summary = [{"name": k, **KERNELS[k], "launches": kstats[k]["launches"],
                "max_abs_err": kstats[k]["max_abs_err"],
                "ms": kstats[k]["ms"], "plain_ms": kstats[k]["plain_ms"]}
               for k in KERNELS]
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
