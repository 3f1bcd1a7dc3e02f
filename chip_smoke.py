#!/usr/bin/env python3
"""Smoke test of darwin_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N] [--phases 1,2,3]

(--phases runs a subset — e.g. a short first call after a kernel change —
and then prints no result lines.)

Phases (each prints its lines; any failure raises, so the exit is nonzero):
  1. environment: torch, CUDA, nvcc, the native host library (must load),
     and the card's name and power limit;
  2. build the CUDA kernels from the checkout's csrc/ with nvcc (sm_90a);
  3. every kernel against its plain PyTorch twin on the card, at the
     paths' tile geometries, with the default, a generic and a mixed
     scoring, at odd geometries with max-cell and start-to-end tiles mixed,
     the walker also on random trace words and on runs longer than its
     look-ahead and than max_tb, and the op-rate probe in its five modes:
     exact integer equality; each kernel's time per call of its wrapper
     (calls enqueued back to back between two events) and its device self
     time under torch.profiler beside its bound, the DP's rows per lane and
     warps per tile, its time on either side of the batch sizes where the
     warps per tile change, the trace's share of its time, its compiled
     instructions per cell;
  4. a small end-to-end run on cuda and on cpu, with the default and with
     the generic-scoring params.cfg: SAM and counters identical;
  5. reference-guided mode at real size through the CLI: a synthetic
     genome of E. coli K-12 MG1655's length, 512 simulated 10 kb reads plus
     16 with a planted 1.5 kb deletion; loci checked against the
     simulation;
  6. the same case with a generic-scoring params.cfg (gap opens cheaper
     than gap extends), which darwin_tpu's DP needs a branch of its own
     for;
  7. overlap mode: a small run on cuda and on cpu with identical MHAP and
     counters, then 512 x 10 kb reads at 10x coverage against themselves
     through the CLI; pairs checked against the simulation;
  8. the op-rate probe through its own entry point.
Every kernel's launch count is set to 0 just before each of the runs of
phases 5-8 and read just after; a kernel its path never launched fails.
The line before the last is the kernels' JSON summary, preceded by the
card's name and power limit; the last line is {"ok": true, "device":
{...}}.  Needs one CUDA device; exits nonzero without one.
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
    # one kernel for _dp_kernel (:103), _dp_strip_kernel (:343) and the
    # generic-scoring branches of both (:196, :417)
    "gact_dp": {"route": "cuda", "source": "darwin_tpu_torch/csrc/gact_dp.cu",
                "replaces": "darwin_tpu/ops/gact_pallas.py:103"},
    "gact_tb": {"route": "cuda", "source": "darwin_tpu_torch/csrc/gact_tb.cu",
                "replaces": "darwin_tpu/ops/gact_pallas.py:620"},
    "int_probe": {"route": "cuda",
                  "source": "darwin_tpu_torch/csrc/int_probe.cu",
                  "replaces": "tools/vpu_probe.py:63"},
}

# The card's peaks for the kernels' bounds (NVIDIA's H100 SXM data sheet):
# 3.35 TB/s of HBM; 67 TFLOP/s fp32 outside the tensor cores = 132 SMs x
# 128 lanes x 2 (an FMA is two) x 1.98 GHz.  An integer add, max, compare
# or select counts once and can issue on the int32 lanes or, as a
# multiply-add, on fp32 lanes, so the peak taken for them is all 128 lanes:
# half that figure, 33.5 T/s.  It is above every rate the op-rate probe
# sustains (16.5 T instructions/s on a max/add chain, 23.2 T/s on
# compare + select + add), so no bound here is looser than the card.
PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 67e12 / 2

# Integer operations the tile DP needs per cell, counted in the recurrence
# (csrc/gact_dp.cu's column loop) without moves, addressing or loop
# overhead.  The recurrence: substitution add and clamp at 0 (2); Hp =
# max(diag, E, E_L) (2); H + go and H + goL, shared by the four gap lanes
# (2); extend add and max for each of E, E_L, F, F_L (8); H = max(Hp, F,
# F_L) (2).  Max-cell mode adds one compare and three selects (score, row,
# column).  The trace word adds the T field's 5 compares and 7 selects, 4
# compares, 4 selects and 2 ors for the open bits and 2 adds to join them.
DP_OPS_RECURRENCE = 16
DP_OPS_MAX_CELL = 4
DP_OPS_TRACE = 24
# SASS opcodes that are not arithmetic: memory, control, moves
NOT_ALU = {"LDG", "STG", "LDS", "STS", "LDC", "ULDC", "LD", "ST", "LDL",
           "STL", "BRA", "BAR", "BSSY", "BSYNC", "EXIT", "NOP", "WARPSYNC",
           "CALL", "RET", "MOV", "UMOV", "S2R", "CS2R", "R2UR", "S2UR",
           "DEPBAR", "YIELD", "BMOV", "BREAK", "ERRBAR", "MEMBAR", "CCTL"}
# integer ops per walker step, about, counted in the twin's loop
# (ops/gact.traceback)
TB_OPS_PER_STEP = 20


# path A's params.cfg: a legal scoring whose gap opens are cheaper than its
# gap extends on both lanes (gap_open, gap_extend, long_gap_open,
# long_gap_extend), every other setting default
GENERIC_GAPS = (-1, -3, -2, -6)


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time the card could take."""
    tb, to = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_INT32_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


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
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    say(1, f"python {sys.version.split()[0]}  torch {torch.__version__}  "
           f"torch.version.cuda {torch.version.cuda}  "
           f"device {torch.cuda.get_device_name(0)} "
           f"x{torch.cuda.device_count()}")
    say(1, f"nvcc: {nvcc.splitlines()[-1]}")
    # the host library (FASTA scan, chaining, tile decode): the card's
    # numbers must not silently be a Python path's
    from darwin_tpu_torch import native
    check(native.available(), native.unavailable_reason())
    say(1, f"native host library loaded: "
           f"{os.path.relpath(native._so_path())}")
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


def _self_ms(jobs, reps):
    """Mean device self time of kernels under torch.profiler, in one
    trace (starting one costs about a second): ``jobs`` maps a label to
    (fn, part of the kernel's name); each fn runs ``reps`` times.  The mean
    is over the launches the profiler recorded (it can miss one).
    _time_ms around the same calls reads more where the wrapper's host work
    (checks, allocations, its other launches) outlasts the kernel."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn, _ in jobs.values():
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    out = {}
    for label, (_, part) in jobs.items():
        seen = [e for e in prof.key_averages() if part in e.key]
        n = sum(e.count for e in seen)
        check(n > 0, f"the profiler saw no kernel named {part}")
        out[label] = sum(e.self_device_time_total for e in seen) / 1000 / n
    return out


def dp_ops_per_cell(start_end, with_trace):
    """Integer operations per cell that this tile mode needs."""
    return (DP_OPS_RECURRENCE + (0 if start_end else DP_OPS_MAX_CELL)
            + (DP_OPS_TRACE if with_trace else 0))


def _generic(params, go, ge, goL, geL):
    return params._replace(gap_open=go, gap_extend=ge, long_gap_open=goL,
                           long_gap_extend=geL)


def phase_kernels(seed, kstats):
    from darwin_tpu_torch.config import Config
    from darwin_tpu_torch.ops import gact, gact_cuda
    from darwin_tpu_torch.tools import vpu_probe
    dev = torch.device("cuda", 0)
    default = gact.make_params(Config())
    # the scoring of path A (phase 6): open cheaper than extend, both lanes
    generic = _generic(default, *GENERIC_GAPS)
    # one lane open-cheaper, the other not
    mixed = _generic(default, -1, -3, -25, -1)
    say(3, f"integer ops the DP needs per cell (counted in the recurrence; "
           f"the bounds use these): {dp_ops_per_cell(True, False)} "
           f"start-to-end, {dp_ops_per_cell(False, False)} max-cell, "
           f"{dp_ops_per_cell(True, True)} start-to-end with trace")
    # what the compiler made of it, for the reader only: the start-to-end
    # column loop of each instantiation with trace is the shortest loop
    # that holds the three edge shuffles; two heights give the
    # instructions per cell and per step
    sass = vpu_probe.sass_counts()
    loops = {}
    for fn, info in sass.items():
        m = re.search(r"gact_dp_kernelILi(\d+)ELb1EE", fn)
        spans = [lp for lp in info["loops"] if lp.get("SHFL") == 3]
        if m and spans:
            loops[int(m.group(1))] = min(spans, key=lambda lp: sum(
                lp.values()))
    check({6, 12} <= set(loops), f"no column loop found in the SASS of "
          f"gact_dp_kernel<6 | 12, true>: {sorted(sass)}")

    def n_alu(lp):
        return sum(n for o, n in lp.items() if o not in NOT_ALU)
    n6, n12 = sum(loops[6].values()), sum(loops[12].values())
    a6, a12 = n_alu(loops[6]), n_alu(loops[12])
    top = sorted(loops[12].items(), key=lambda kv: -kv[1])[:10]
    say(3, f"column loop of gact_dp_kernel<S, trace> as compiled: {n12} "
           f"instructions per step at S=12, {n6} at S=6 = "
           f"{(n12 - n6) / 6:.1f} per cell + {2 * n6 - n12} per step; "
           f"arithmetic {(a12 - a6) / 6:.1f} per cell + {2 * a6 - a12} per "
           f"step; S=12: " + ", ".join(f"{o} {n}" for o, n in top))
    rng = np.random.default_rng(seed)
    # (name, qt, rt, B, start_end); (qt, rt) = (query, ref) tile sides —
    # the escalation tiles are 1984 ref x 960 query and 960 x 1984; B = 103
    # is the mean batch of the main path's extension dispatches
    geoms = [("filter max-cell", 128, 128, 256, False),
             ("extend start-to-end", 384, 384, 512, True),
             ("extend start-to-end", 384, 384, 103, True),
             ("large tile", 960, 1984, 64, True),
             ("large tile", 1984, 960, 64, True)]
    cases = [(default, g) for g in geoms]
    cases += [(generic, g) for g in geoms if g[3] != 103]
    cases += [(mixed, geoms[1])]
    kname = "gact_dp"
    for params, (name, qt, rt, B, se) in cases:
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
        gaps = "/".join(str(v) for v in params[1:])
        geo = f"{name} {rt}x{qt} (ref x query) B={B} gaps {gaps}"
        if with_trace:
            qi = torch.arange(qt, device=dev)
            ri = torch.arange(rt, device=dev)
            valid = ((ri[None, :, None] < args[3][:, None, None])
                     & (qi[None, None, :] < args[2][:, None, None]))
            diff = (k["trace"].int() - p["trace"].int()).abs() * valid
            err = max(err, int(diff.max()))
        check(err == 0, f"{kname} != plain at {geo}: max |diff| {err}")
        st = kstats[kname]
        st["max_abs_err"] = max(st.get("max_abs_err", 0), err)
        main_row = (qt, rt, B, se) == (384, 384, 512, True) and \
            params is default

        def bare():
            return gact_cuda.dp_tiles(*args, sev, params, False)

        if with_trace:
            max_tb = 768
            sq = (args[2] - 1).contiguous()
            sr = (args[3] - 1).contiguous()
            # each walker on its own DP's trace
            tr, ptrace = k["trace"], p["trace"]

            def kern_tb():
                return gact_cuda.traceback_tiles(tr, sq, sr, max_tb)

            def plain_tb():
                return gact.traceback(ptrace, sq, sr, max_tb)

            kt = kern_tb()
            pt = plain_tb()
            torch.cuda.synchronize()
            err = max(int((a.long() - b.long()).abs().max())
                      for a, b in zip(kt, pt))
            check(err == 0, f"gact_tb != plain at {geo}: max |diff| {err}")
            kstats["gact_tb"]["max_abs_err"] = max(
                kstats["gact_tb"].get("max_abs_err", 0), err)

        reps = 20 if qt * rt * B <= 384 * 384 * 512 else 5
        S, W = gact_cuda.dp_plan(B, qt)
        # the kernels' self time at the default scoring's rows: the other
        # scorings run the same kernels
        self_ms = {}
        if params is default:
            flag = "true" if with_trace else "false"
            jobs = {"dp": (kern, f"gact_dp_kernel<{S}, {flag}>")}
            if main_row:
                jobs["bare"] = (bare, f"gact_dp_kernel<{S}, false>")
            if with_trace:
                jobs["tb"] = (kern_tb, "gact_tb_kernel")
            self_ms = {x: f", {v:.4f} ms device self time"
                       for x, v in _self_ms(jobs, reps).items()}
        kms = _time_ms(kern, reps)
        pms = _time_ms(plain, 1)
        # the work these inputs need: the cells of each tile's valid region
        # (half of the tiles are ragged); GCUPS counts whole tiles, as the
        # main path's does
        cells = B * qt * rt
        need = int((ql.astype(np.int64) * rl).sum())
        n_bytes = B * (qt + rt + 4 + 4 + 1 + 12) + (need if with_trace
                                                    else 0)
        bms, bby = bound(n_bytes, need * dp_ops_per_cell(se, with_trace))
        say(3, f"{kname} {geo}: exact; S={S} rows per lane, W={W} warps "
               f"per tile; kernel {kms:.3f} ms per call of {reps} enqueued "
               f"back to back ({cells / kms / 1e6:.2f} GCUPS of whole "
               f"tiles, {need / cells:.3f} of the cells valid)"
               f"{self_ms.get('dp', '')}, plain {pms:.1f} ms, bound "
               f"{bms:.4f} ms by {bby}")
        if main_row:
            st.update(ms=kms, plain_ms=pms, bound_ms=bms, bound_by=bby)
            # the trace's share of the time: the same tiles without it
            nms = _time_ms(bare, reps)
            nb, _ = bound(B * (qt + rt + 21),
                          need * dp_ops_per_cell(se, False))
            say(3, f"{kname} {geo}, the same tiles without trace: kernel "
                   f"{nms:.3f} ms per call{self_ms['bare']}, bound {nb:.4f} "
                   f"ms: the trace is {1 - nms / kms:.3f} of the time per "
                   f"call")
        if not with_trace:
            continue
        kms = _time_ms(kern_tb, reps)
        pms = _time_ms(plain_tb, 1)
        # what this walk needs: one trace byte per step, the zeroed record
        # matrix written once, starts in and step counts out
        rec = kt[0]
        steps = int((rec & 0x3FFF).sum() + ((rec >> 14) != 0).sum())
        longest = int((kt[1] + kt[2]).max())
        bms, bby = bound(steps + rec.numel() * 4 + B * 16,
                         steps * TB_OPS_PER_STEP)
        say(3, f"gact_tb   {geo} max_tb={max_tb}: exact; kernel "
               f"{kms:.4f} ms per call of {reps} enqueued back to back "
               f"(its zeroed records included){self_ms.get('tb', '')}, "
               f"plain {pms:.1f} ms, bound {bms:.5f} ms by "
               f"{bby}; {steps} steps in all, at most {longest} "
               f"(q + r steps) on one tile's serial chain")
        if main_row:
            kstats["gact_tb"].update(ms=kms, plain_ms=pms, bound_ms=bms,
                                     bound_by=bby)

    # the rule that picks the warps per tile from the batch size, read on
    # either side of the sizes where it switches: full 384x384 tiles with
    # trace (the kernel outlasts its wrapper's host work here)
    q, r, ql, rl = _tiles(rng, 528, 384, 384, full_frac=1.0)
    full = [torch.from_numpy(x).to(dev) for x in (q, r, ql, rl)]
    sev = torch.ones(528, dtype=torch.bool, device=dev)
    for B in (132, 263, 264, 527, 528):
        part = [x[:B].contiguous() for x in full]

        def kern():
            return gact_cuda.dp_tiles(*part, sev[:B], default, True)
        S, W = gact_cuda.dp_plan(B, 384)
        kms = _time_ms(kern, 20)
        say(3, f"gact_dp 384x384 full tiles with trace, B={B}: S={S}, "
               f"W={W}; kernel {kms:.4f} ms per call of 20 enqueued back "
               f"to back = {kms / B * 1e3:.3f} us per tile")

    # exactness only, at geometries off the main path: one row and column,
    # a tile narrower than a warp and longer than a strip of columns, sides
    # that are no multiple of 4, the tallest tile; max-cell and start-to-end
    # tiles mixed in one batch, with trace
    for qt, rt, B in ((1, 1, 5), (33, 1000, 40), (385, 383, 70),
                      (2048, 64, 9), (128, 128, 300)):
        q, r, ql, rl = _tiles(rng, B, qt, rt)
        args = [torch.from_numpy(x).to(dev) for x in (q, r, ql, rl)]
        sev = torch.from_numpy(np.arange(B) % 3 != 0).to(dev)
        for params in (default, generic):
            k = gact_cuda.dp_tiles(*args, sev, params, True)
            p = gact.batch_align(*args, sev, params, with_trace=True)
            torch.cuda.synchronize()
            for key in ("score", "query_max_pos", "ref_max_pos"):
                check(torch.equal(k[key], p[key]),
                      f"gact_dp != plain at {rt}x{qt}: {key}")
            valid = ((torch.arange(rt, device=dev)[None, :, None]
                      < args[3][:, None, None])
                     & (torch.arange(qt, device=dev)[None, None, :]
                        < args[2][:, None, None]))
            check(bool(((k["trace"] == p["trace"]) | ~valid).all()),
                  f"gact_dp != plain at {rt}x{qt}: trace")
            sq = torch.where(sev, args[2] - 1, k["query_max_pos"])
            sr = torch.where(sev, args[3] - 1, k["ref_max_pos"])
            # each walker on its own DP's trace; a max-cell tile with an
            # empty side starts at (0, 0), where both traces hold ZERO
            kt = gact_cuda.traceback_tiles(k["trace"], sq, sr, 2 * qt)
            pt = gact.traceback(p["trace"], sq, sr, 2 * qt)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(kt, pt)),
                  f"gact_tb != plain at {rt}x{qt}")
        S, W = gact_cuda.dp_plan(B, qt)
        say(3, f"gact_dp, gact_tb {rt}x{qt} (ref x query) B={B}, max-cell "
               f"and start-to-end mixed, default and generic gaps: exact; "
               f"S={S}, W={W}")

    # the walker on words no DP made: any T field in 0-5 under any open
    # bits, starts on the tile's edges and outside it; then runs longer
    # than the 32 words of one look-ahead and longer than max_tb
    B, side = 4096, 64
    t = np.where(rng.random((B, side, side)) < 0.6, gact.T8_DIAG,
                 rng.integers(0, 6, (B, side, side)))
    words = (t | (rng.integers(0, 16, t.shape) << 3)).astype(np.uint8)
    sq = rng.integers(-1, side + 2, B).astype(np.int32)
    sr = rng.integers(-1, side + 2, B).astype(np.int32)
    long_runs = np.full((6, 200, 200), gact.T8_DIAG, np.uint8)
    long_runs[1] = gact.T8_DEL
    long_runs[2] = gact.T8_INS_L
    long_runs[3] = gact.T8_DEL_L
    long_runs[3, 199 - 63, 199] |= gact.EL_OPEN8
    long_runs[4] = gact.T8_INS
    long_runs[4, 199, 199 - 64] |= gact.F_OPEN8
    long_runs[5, 100:] = gact.T8_DEL | gact.E_OPEN8
    ends = np.full(6, 199, np.int32)
    for what, tr, a, b, caps in (
            ("random trace words, B=4096 of 64x64", words, sq, sr, (7, 128)),
            ("runs of 200 cells, B=6 of 200x200", long_runs, ends, ends,
             (1, 33, 100, 400))):
        trd, a, b = (torch.from_numpy(x).to(dev) for x in (tr, a, b))
        for max_tb in caps:
            kt = gact_cuda.traceback_tiles(trd, a, b, max_tb)
            pt = gact.traceback(trd, a, b, max_tb)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(kt, pt)),
                  f"gact_tb != plain on {what}, max_tb={max_tb}")
        say(3, f"gact_tb   {what}, max_tb in {caps}: exact")

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
    res = gact_cuda.dp_tiles(e8, e8, e32, e32, e32.bool(), default, True)
    rec = gact_cuda.traceback_tiles(res["trace"], e32, e32, 768)[0]
    check(gact_cuda.LAUNCHES == before
          and tuple(res["trace"].shape) == (0, 128, 128)
          and tuple(rec.shape) == (128, 0),
          "an empty batch launched a kernel or gave misshapen outputs")
    say(3, "empty batch (B=0): no launch, empty outputs")

    # the op-rate probe, every mode, against its plain twin: exact
    # (wraparound included: the chains overflow int32 within 64 reps)
    x = torch.from_numpy(rng.integers(0, 1 << 20, (vpu_probe.QT,
                                                   vpu_probe.LANES))
                         .astype(np.int32)).to(dev)
    programs = 8192
    st = kstats["int_probe"]
    for mode in vpu_probe.MODES:
        k = vpu_probe.probe_block(x, mode, programs)
        p = vpu_probe.probe_plain(x, mode)
        torch.cuda.synchronize()
        err = int((k.long() - p.long()).abs().max())
        check(err == 0, f"int_probe != plain in mode {mode}: {err}")
        kms = _time_ms(lambda: vpu_probe.probe_block(x, mode, programs), 5)
        pms = _time_ms(lambda: vpu_probe.probe_plain(x, mode), 1)
        n_ops = x.numel() * programs * 2 * vpu_probe.REPS
        bms, bby = bound(2 * x.numel() * 4 * programs, n_ops)
        say(3, f"int_probe mode {mode} programs={programs}: exact; kernel "
               f"{kms:.3f} ms = {n_ops / kms / 1e9:.3f} Tops (2 ops per "
               f"rep), plain (one program) {pms:.2f} ms, bound {bms:.3f} "
               f"ms by {bby}")
        st["max_abs_err"] = max(st.get("max_abs_err", 0), err)
        if mode == "max":
            # every program computes the same block, so the twin's one
            # pass is the same function of the same input
            st.update(ms=kms, plain_ms=pms, bound_ms=bms, bound_by=bby)
    for fn, info in sorted(sass.items()):
        m = re.search(r"int_probe_kernelILi(\d)E", fn)
        if m:
            top = sorted(info["all"].items(), key=lambda kv: -kv[1])[:6]
            say(3, f"int_probe SASS, mode "
                   f"{vpu_probe.MODES[int(m.group(1))]}: "
                   f"{info['total']} instructions for 12 elements x 64 "
                   f"reps; " + ", ".join(f"{o} {n}" for o, n in top))


# ---------------------------------------------------------------- phase 4-8

def _counter_block(err_text):
    return [ln for ln in err_text.splitlines() if ln.startswith("#")]


def _both_devices(ref, reads, overlap, cfg=None):
    """The same run on cuda and on cpu: (stdout, counter block, seconds)
    per device."""
    import copy
    from darwin_tpu_torch.pipeline.align import run
    res = {}
    for dev in ("cuda", "cpu"):
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        run(ref, reads, overlap, cfg=copy.copy(cfg), out=out, err=err,
            device=dev)
        res[dev] = (out.getvalue(), _counter_block(err.getvalue()),
                    time.perf_counter() - t0)
    return res["cuda"], res["cpu"]


def phase_parity(seed):
    """The same small run on cuda and on cpu, with the default scoring and
    with path A's: SAM and counters equal."""
    from darwin_tpu_torch.config import Config
    from darwin_tpu_torch.utils import synth
    from darwin_tpu_torch.utils.simulate import simulate_reads, write_fasta
    rng = np.random.default_rng(seed + 1)
    store = synth.random_genome(rng, [("chrA", 120_000), ("chrB", 80_000)])
    sim = simulate_reads(store, 24, 3000, seed=seed + 2)
    with tempfile.TemporaryDirectory() as tmp:
        ref, reads = f"{tmp}/ref.fa", f"{tmp}/reads.fa"
        synth.write_reference(ref, store)
        write_fasta(reads, sim)
        sams = {}
        for label, gaps in (("default", None), ("generic", GENERIC_GAPS)):
            cfg = Config()
            if gaps:
                (cfg.gap_open, cfg.gap_extend, cfg.long_gap_open,
                 cfg.long_gap_extend) = gaps
            (sam_g, blk_g, t_g), (sam_c, blk_c, t_c) = _both_devices(
                ref, reads, False, cfg)
            n_rec = sum(1 for ln in sam_g.splitlines()
                        if not ln.startswith("@"))
            check(n_rec > 0, f"parity run ({label}) produced no SAM records")
            check(sam_g == sam_c,
                  f"SAM differs between cuda and cpu ({label} scoring)")
            check(blk_g == blk_c,
                  f"counters differ ({label}): {blk_g} vs {blk_c}")
            say(4, f"200 kb genome, 24 x 3 kb reads, {label} scoring: SAM "
                   f"({n_rec} records, {len(sam_g)} bytes) and counter "
                   f"block identical on cuda ({t_g:.1f} s) and cpu "
                   f"({t_c:.1f} s)")
            sams[label] = sam_g
    check(sams["default"] != sams["generic"],
          "the generic scoring changed no alignment")


def _run_cli(phase, argv, tmp, n_reads, smi):
    """One CLI run in ``tmp`` (where its params.cfg is read), in-process
    so the kernel launch counts of exactly this run are read: every count
    is set to 0 just before and read just after.  Returns (stdout, counter
    block, launches)."""
    from darwin_tpu_torch import cli
    from darwin_tpu_torch.ops import dispatch, gact_cuda
    out, err = io.StringIO(), io.StringIO()
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        gact_cuda.reset_launches()
        dispatch.reset_ext_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = cli.main(argv + ["--device=cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(gact_cuda.LAUNCHES)
        ext = dict(dispatch.EXT_STATS)
    finally:
        os.chdir(cwd)
    check(rc == 0, f"cli exited {rc}")
    err_text = err.getvalue()
    blk = _counter_block(err_text)
    m = re.search(r"Time elapsed \(aligning reads\): (\d+) msec", err_text)
    align_s = int(m.group(1)) / 1000
    m = re.search(r"finalizing seed position table\): (\d+) msec",
                  err_text)
    index_s = int(m.group(1)) / 1000
    gcups = (ext["cells"] / ext["device_ms"] / 1e6 if ext["device_ms"]
             else float("nan"))
    say(phase, "counters: " + "; ".join(blk))
    say(phase, f"kernel launches in this run: {launches}")
    say(phase, f"index {index_s:.3f} s, align {align_s:.3f} s, cli wall "
               f"{wall:.1f} s: {n_reads / align_s:.1f} reads/s [{smi}]")
    say(phase, f"extension DP+traceback: {ext['dispatches']} dispatches, "
               f"{ext['tiles']} tiles, {ext['cells']} cells in "
               f"{ext['device_ms']:.1f} ms device time = {gcups:.2f} GCUPS "
               f"[{smi}]")
    return out.getvalue(), blk, launches


def _took(kstats, launches, names):
    """Record a path's launch counts; each named kernel must have run."""
    for k in names:
        kstats[k]["launches"] = kstats[k].get("launches", 0) + launches[k]
        check(launches[k] > 0, f"kernel {k} never launched on its path")


def phase_real(phase, seed, kstats, smi, params_cfg, min_share):
    """Reference-guided mode at real size through the CLI: the E. coli
    K-12-size case, with the default scoring (phase 5) or the generic
    params.cfg (phase 6, path A)."""
    from darwin_tpu_torch.utils import synth
    with tempfile.TemporaryDirectory() as tmp:
        truth = synth.ecoli_case(seed, tmp)
        if params_cfg:
            with open(f"{tmp}/params.cfg", "w") as f:
                f.write(params_cfg)
        sam, blk, launches = _run_cli(phase, ["ref.fa", "reads.fa", "0"],
                                      tmp, len(truth), smi)
    best = {}
    where = {n: [] for n in truth}
    n_rec = 0
    for ln in sam.splitlines():
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
        ref_bp = sum(int(x) for x, op in re.findall(r"(\d+)([MD])", f[5]))
        where[f[0]].append(f"{int(f[3]) - 1 - start:+d} bp from it, "
                           f"{ref_bp} ref bp aligned" if f[2] == chrom
                           else f"on {f[2]}")
    share = len(best) / len(truth)
    large = int(next(ln for ln in blk if ln.startswith("#large tiles"))
                .split(":")[1])
    say(phase, f"{len(truth)} reads vs {synth.ECOLI_LEN} bp: {n_rec} SAM "
               f"records; {len(best)}/{len(truth)} = {share:.4f} reads on "
               f"the true locus (+-200 bp)")
    for n in sorted(set(truth) - set(best)):
        say(phase, f"not within 200 bp: {n}: "
                   + ("; ".join(where[n]) or "no record"))
    check(share >= min_share,
          f"only {share:.4f} of reads on the true locus")
    check(large > 0, "no large tiles fired")
    _took(kstats, launches, ["gact_dp", "gact_tb"])


def _mhap_pairs(mhap):
    return {frozenset(ln.split()[:2]) for ln in mhap.splitlines()
            if " " in ln}


def phase_overlap(seed, kstats, smi):
    """Path B, overlap mode: a small run on cuda and on cpu with identical
    MHAP and counters, then 512 x 10 kb reads at 10x coverage against
    themselves through the CLI, checked against the simulation."""
    from darwin_tpu_torch.config import Config
    from darwin_tpu_torch.utils import synth
    with tempfile.TemporaryDirectory() as tmp:
        synth.overlap_case(seed + 7, tmp, genome_len=40_000, n_reads=32,
                           read_len=3000)
        cfg = Config()
        cfg.seed_size = 11          # a 100 kb read set wants a shorter seed
        (m_g, blk_g, t_g), (m_c, blk_c, t_c) = _both_devices(
            f"{tmp}/reads.fa", f"{tmp}/reads.fa", True, cfg)
    n_rec = len(_mhap_pairs(m_g))
    check(n_rec > 0, "overlap parity run found no overlaps")
    check(m_g == m_c, "MHAP differs between cuda and cpu")
    check(blk_g == blk_c, f"counters differ: {blk_g} vs {blk_c}")
    say(7, f"32 x 3 kb reads of a 40 kb genome vs themselves: MHAP "
           f"({n_rec} pairs, {len(m_g)} bytes) and counter block identical "
           f"on cuda ({t_g:.1f} s) and cpu ({t_c:.1f} s)")

    min_overlap = Config().min_overlap
    with tempfile.TemporaryDirectory() as tmp:
        truth = synth.overlap_case(seed, tmp)
        mhap, blk, launches = _run_cli(7, ["reads.fa", "reads.fa", "1"],
                                       tmp, len(truth), smi)
    check(not mhap.startswith("@"), "overlap mode printed a SAM header")

    def span(a, b):
        (s1, e1, _), (s2, e2, _) = truth[a], truth[b]
        return min(e1, e2) - max(s1, s2)
    pairs = _mhap_pairs(mhap)
    check(all(len(p) == 2 for p in pairs), "a read overlaps itself")
    real = sum(1 for p in pairs if span(*p) > 0)
    names = sorted(truth)
    want = {frozenset((a, b)) for i, a in enumerate(names)
            for b in names[i + 1:] if span(a, b) > 2 * min_overlap}
    found = len(want & pairs)
    bands = {}
    for p in want:
        band = span(*p) // 2000 * 2
        hit, n = bands.get(band, (0, 0))
        bands[band] = (hit + (p in pairs), n + 1)
    say(7, "true overlaps found, by overlap length: " + ", ".join(
        f"{b}-{b + 2} kb {h}/{n} = {h / n:.3f}"
        for b, (h, n) in sorted(bands.items())))
    # by the strands of the pair's earlier and later read on the genome:
    # D-SOFT seeds a query densely over its first num_seeds minimizers and
    # strided after, and with (-, +) the overlap is the tail of the
    # matching strand of whichever read is the query
    orient = {}
    for p in want:
        a, b = sorted(p, key=lambda n: truth[n][0])
        key = truth[a][2] + truth[b][2]
        hit, n = orient.get(key, (0, 0))
        orient[key] = (hit + (p in pairs), n + 1)
    say(7, "true overlaps found, by strands (earlier, later read): "
        + ", ".join(f"{k} {h}/{n} = {h / n:.3f}"
                    for k, (h, n) in sorted(orient.items())))
    say(7, f"{len(truth)} reads vs themselves: {len(pairs)} pairs printed, "
           f"{real} of them true overlaps ({real / max(len(pairs), 1):.4f});"
           f" {found}/{len(want)} = {found / len(want):.4f} of the true "
           f"overlaps over {2 * min_overlap} bp found [{smi}]")
    check(real >= 0.95 * len(pairs), "printed pairs do not overlap")
    # floors set from a correct run (identical to darwin_tpu's on the CPU
    # at a small size): the (-, +) quarter of the pairs is found only when
    # the overlap is most of the read
    check(found >= 0.75 * len(want), "true overlaps were missed")
    long_hit, long_n = bands[max(bands)]
    check(long_hit >= 0.95 * long_n, "long true overlaps were missed")
    _took(kstats, launches, ["gact_dp", "gact_tb"])


def phase_probe(kstats, smi):
    """The probe's own entry point, in-process: its rates, and int_probe's
    launch count from that run."""
    from darwin_tpu_torch.ops import gact_cuda
    from darwin_tpu_torch.tools import vpu_probe
    out = io.StringIO()
    gact_cuda.reset_launches()
    with contextlib.redirect_stdout(out):
        rc = vpu_probe.main(["--samples", "3"])
    launches = dict(gact_cuda.LAUNCHES)
    check(rc == 0, f"vpu_probe exited {rc}")
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    for mode in vpu_probe.MODES:
        r = res[mode]
        check(0 < r["tops"] < 100, f"implausible rate in mode {mode}: {r}")
        say(8, f"int32 op rate, mode {mode}: {r['tops']:.3f} Tops (2 ops "
               f"per rep); {r['ms']:.3f} / {r['ms_median']:.3f} / "
               f"{r['ms_max']:.3f} ms per launch (min / median / max of 3 "
               f"windows of {res['launches_per_window']}) [{smi}]")
    _took(kstats, launches, ["int_probe"])


# ---------------------------------------------------------------- main

ALL_PHASES = {1, 2, 3, 4, 5, 6, 7, 8}
# measured on a correct run: the generic scoring's cheap gap opens change
# CIGARs, not loci
MIN_LOCUS_SHARE = 0.95


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(map(str, sorted(
        ALL_PHASES))), help="comma list (a partial run prints no result)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    import darwin_tpu_torch  # noqa: F401  (fails outside a checkout)
    from darwin_tpu_torch.utils.synth import GENERIC_PARAMS_CFG
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
        phase_real(5, args.seed, kstats, smi, None, MIN_LOCUS_SHARE)
    if 6 in phases:
        phase_real(6, args.seed, kstats, smi, GENERIC_PARAMS_CFG,
                   MIN_LOCUS_SHARE)
    if 7 in phases:
        phase_overlap(args.seed, kstats, smi)
    if 8 in phases:
        phase_probe(kstats, smi)
    if phases != ALL_PHASES:
        return 0
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by")
    # no single PyTorch call computes any of these functions
    summary = [{"name": k, **KERNELS[k], **{x: kstats[k][x] for x in keys},
                "library_ms": None} for k in KERNELS]
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
