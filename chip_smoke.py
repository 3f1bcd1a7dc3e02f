#!/usr/bin/env python3
"""Smoke test of darwin_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N] [--phases 1,2,3]

(--phases runs a subset — e.g. a short first call after a kernel change —
and then prints no result lines; so does a --seed other than the goldens',
whose real-size runs are then held to nothing of darwin_tpu's.)

Phases (each prints its lines; any failure raises, so the exit is nonzero):
  1. environment: torch, CUDA, nvcc, the native host library (must load),
     and the card's name and power limit;
  2. build the CUDA kernels from the checkout's csrc/ with nvcc (sm_90a);
  3. every kernel against its plain PyTorch twin on the card, at the
     paths' tile geometries, with the default, a generic and a mixed
     scoring, at odd geometries with max-cell and start-to-end tiles mixed,
     the walker also on random trace words and on runs longer than its
     look-ahead and than max_tb, the next-tile kernel (request, gathered
     tiles and sizes) on the walker's records, on synthetic ones and at
     odd record heights, and the op-rate probe in its five
     modes at 1, 3 and 8192 programs: exact integer equality; the probe's
     program loop holds every rep of its chain (SASS); each kernel's time
     per call of its wrapper (calls enqueued back to back between two
     events) and its
     device self time under torch.profiler beside its bound, the DP's rows
     per lane and warps per tile, its time on either side of the batch
     sizes where the warps per tile change, the trace's share of its time,
     its compiled instructions per cell;
  4. a small end-to-end run on cuda and on cpu at run()'s defaults
     (speculative chains of 12 tiles, two read batches in flight), with
     the default and with the generic-scoring params.cfg: SAM, counters
     and the speculative chains' hits, misses and rounds identical;
  5. reference-guided mode at real size through the CLI, at the defaults:
     a synthetic genome of E. coli K-12 MG1655's length, 512 simulated
     10 kb reads plus 16 with a planted 1.5 kb deletion; loci checked
     against the simulation; parity with the ``ecoli`` golden
     (darwin_tpu_torch/goldens/real_size.json: darwin_tpu's own run on
     the CPU, made by ``tests/test_torch_goldens.py --make``): the input
     files' sha256 first, then stdout's sha256 and the 7-line counter
     block; a mismatch names the first 20 differing records and every
     differing counter line;
  6. the same case with a generic-scoring params.cfg (gap opens cheaper
     than gap extends), which darwin_tpu's DP needs a branch of its own
     for; parity with the ``ecoli_generic`` golden;
  7. overlap mode: a small run on cuda and on cpu with identical MHAP,
     counters and chains (chains of 2: the CPU's twins pay for every
     level), then 512 x 10 kb reads at 10x coverage against
     themselves through the CLI; parity with the ``overlap`` golden
     (MHAP); pairs checked against the simulation;
  8. the op-rate probe through its own entry point, with the SM clock
     read beside its windows;
  9. the cases of phases 5 and 7 again without speculation, one read batch
     at a time (spec_k=1, pipeline_depth=1): SAM / MHAP and the counter
     block identical to the defaults', and more extension rounds;
 10. a chr21-size (46.7 Mbp) repeat genome, reference-guided, 512 reads of
     ONT-like lengths and errors plus 16 across a planted deletion: the
     pairs table (automatic method) and the csr table the same bucket for
     bucket, the CLI with --index-layout=pairs and =csr giving the same SAM
     and counter block, the occupancy cap and the large tiles live, >= 90%
     of reads on their locus; then one read in 32 (17 reads,
     reads_sub.fa) through the CLI with each layout: parity with the
     ``chr21_sub`` golden;
 11. GRCh38's coordinate space (24 chromosomes at their lengths, 3.09 Gbp,
     uniform random bases) as a 3.09 GB FASTA and 512 reads of 10 kb:
     408 from chr14 on (past 2^31), 8 ending at chrY's last base (the end
     of the coordinate space), 64 from chr1, 16 holding global coordinate
     2^31 and 16 across a planted 1.5 kb deletion in chrX; the csr index at
     k = 14, w = 3 and the pairs table by the automatic method (the
     streaming build) the same bucket for bucket; the pairs table sharded
     by hash range over a mesh of 2 (two cards, or cuda:0 named twice):
     its shards' resident bytes and peak, dsoft_sharded on the 512 reads
     against the replicated D-SOFT (every valid hit, anchor and count);
     the CLI with --index-layout=csr (loading the FASTA, building its own
     index): parity with the ``human`` golden, >= 95% on their locus;
     then the reads in run()'s batches by Aligner(mesh, shard_index=True)
     on the sharded pairs table: SAM and counter block held to the golden
     and to the CLI's;
 12. a mesh (every card, a power of two, when there are two or more, else
     cuda:0 named twice): phase 5's case through run(mesh=) and
     run(mesh=, shard_index=True), phase 7's through run(mesh=), each with
     SAM / MHAP and counter block identical to the one-device run of this
     process (on more than one card the defaults' runs of phases 5 and 7
     mesh every card, so mesh='off' runs each case on one device too); reads/s beside the one-device run's, each shard's kernel
     launches, and the copies that crossed between two devices;
 13. two ranks of ``python -m darwin_tpu_torch.parallel.multihost`` on
     127.0.0.1 over gloo, both on this machine's card(s), over phase 5's
     case: each a real half of the reads, the merged SAM identical to the
     one-process run's, the summed counters equal to its counters (the
     extension rounds and decode calls apart: they count per read batch),
     no rank rebuilding a library;
 14. GRCh38 with its N gaps: phase 11's genome with 133 Mbp of N in
     GRCh38's gap classes (telomeres, short arms, heterochromatin, 100-N
     scaffold gaps; ``utils.synth.HUMAN_GAPS``) and 512 reads of 10 kb:
     128 holding 1-9 kb of a block's edge, 64 beside a block, 32 across a
     scaffold gap, 288 from N-free windows; the csr index's
     ``goldens.index_digest``, seed count and largest bucket (the N
     blocks' poly-A bucket) equal to darwin_tpu's table (the
     ``human_gaps`` golden), the streaming pairs build the same bucket for
     bucket, the CLI with --index-layout=csr held to the golden's SAM and
     counter block, >= 95% of the far and flank reads on their locus.
Phases 10, 11 and 14 print each index build's passes, seconds, seeds and
peak device memory, and fail if a build fell back to the host.
Phases 5-7, 9-12 and 14 print the align phase's reads/s, the extension
dispatches' tiles and cells, the chains' hits, misses and rounds and the
stage seconds of run()'s stats_out.  Every kernel's launch count is set to
0 just before each of the runs of phases 5-12 and 14 and read just after;
a kernel its path never launched fails.
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
    # XLA code in darwin_tpu (_device_consumed + the next-request
    # arithmetic of _extend_round_spec_pallas), not a Pallas kernel
    "gact_next": {"route": "cuda",
                  "source": "darwin_tpu_torch/csrc/gact_next.cu",
                  "replaces": "darwin_tpu/ops/dispatch.py:273"},
    "int_probe": {"route": "cuda",
                  "source": "darwin_tpu_torch/csrc/int_probe.cu",
                  "replaces": "tools/vpu_probe.py:63"},
}

# The card's peaks for the kernels' bounds (NVIDIA's H100 SXM data sheet):
# 3.35 TB/s of HBM; 67 TFLOP/s fp32 outside the tensor cores = 132 SMs x
# 128 lanes x 2 (an FMA is two) x 1.98 GHz.  An integer add, max, compare
# or select counts once and can issue on the int32 lanes or, as a
# multiply-add, on fp32 lanes, so the peak taken for them is all 128 lanes:
# half that figure, 33.5 T/s: one warp-instruction a clock on each of an
# SM's four schedulers.  The op-rate probe sustains 0.97 of it on a
# max/add chain (32.4 T thread-instructions/s) and on compare + select +
# add (32.3 T/s; NVIDIA H100 80GB HBM3, 700 W, SM clock read at 1980 MHz),
# so no bound here is looser than the card.  The
# probe's own rows take the larger of this and its ALU-only operations
# (min / max, logic) over the 64 int32 lanes (tools/vpu_probe.mode_bounds);
# the DP's maxes pair with its adds into DPX instructions, so it keeps
# this one.
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


def _next_inputs(rng, B, dev, n_ref, n_q):
    """(lane (5, B), curr (2, B)) int64 on the card: both orientations,
    positions anywhere, at 0, near and at the chromosome's and the read's
    far ends, so that every clamp of the next-tile rule fires; chromosomes
    and reads start anywhere in code buffers of n_ref and n_q codes, some
    near their ends, and lane 0 is a right extension at the start of a
    chromosome shorter than a tile at the buffer's start, so that the
    gather's clamps fire below 0 and past both buffers."""
    rev = rng.integers(0, 2, B)
    clen = rng.integers(192, 6000, B)
    qlen = rng.integers(192, 11_000, B)
    pick = rng.integers(0, 4, B)

    def at(n):
        return np.select([pick == 0, pick == 1, pick == 2],
                         [rng.integers(0, n), np.zeros(B, np.int64),
                          np.maximum(n - rng.integers(1, 500, B), 0)], n)
    lane = np.stack([rev, rng.integers(0, n_ref, B), clen,
                     rng.integers(0, n_q, B), qlen])
    curr = np.stack([at(clen), at(qlen)])
    lane[:3, 0], curr[0, 0] = (1, 0, 100), 10
    return (torch.from_numpy(lane.astype(np.int64)).to(dev),
            torch.from_numpy(curr.astype(np.int64)).to(dev))


def _synthetic_records(rng, RT):
    """Walks no DP made: all M, all D, empty, insert runs up to the 14-bit
    limit, a walk that ends in inserts, random mixes of every closing op."""
    cols = [np.full(RT, 3 << 14), np.full(RT, 2 << 14), np.zeros(RT)]
    c = np.zeros(RT)
    c[RT - 1] = 0x3FFF
    cols.append(c)
    c = np.full(RT, 3 << 14)
    c[RT // 2] = 0x3FFF | 3 << 14
    cols.append(c)
    c = np.full(RT, 3 << 14)
    c[:RT // 2] = 0
    c[RT // 2] = 7
    cols.append(c)
    for _ in range(58):
        n_ins = np.where(rng.random(RT) < 0.2, rng.integers(0, 60, RT), 0)
        cols.append(n_ins | rng.integers(0, 4, RT) << 14)
    return np.stack(cols, 1).astype(np.int32)


def _check_next(rng, kstats, params):
    """gact_next against its twin (spec_next_tiles) on the card: the
    walker's records of 512 ragged 384x384 start-to-end tiles (the main
    path's chain levels) and 64 synthetic walks, stop_thr 0, 1, 320 (the
    main path's: 384 - the tile overlap) and 384, both orientations, all
    clamps; then records shorter than a step and longer than a staged
    chunk.  Requests, both gathered tiles and the sizes, exact as whole
    arrays.  Then its time on the walker's records at stop_thr 320."""
    from darwin_tpu_torch.ops import gact, gact_cuda
    dev = torch.device("cuda", 0)
    T, B = 384, 512
    q, r, ql, rl = (torch.from_numpy(x).to(dev)
                    for x in _tiles(rng, B, T, T))
    res = gact_cuda.dp_tiles(q, r, ql, rl, torch.ones(B, dtype=torch.bool,
                                                      device=dev),
                             params, True)
    walked = gact_cuda.traceback_tiles(res["trace"], ql - 1, rl - 1,
                                       2 * T)[0]
    synth = torch.from_numpy(_synthetic_records(rng, T)).to(dev)
    # code buffers of a genome's and a read batch's size
    ref = torch.from_numpy(rng.integers(0, 5, 4_641_652).astype(np.uint8)
                           ).to(dev)
    query = torch.from_numpy(rng.integers(0, 5, 1_500_000).astype(np.uint8)
                             ).to(dev)
    st = kstats["gact_next"]

    def exact(rec, lane, curr, side, thr, what):
        k = gact_cuda.next_tiles(rec, lane, curr, ref, query, side, thr,
                                 2 * side)
        p = gact.spec_next_tiles(rec, lane, curr, ref, query, side, thr,
                                 2 * side)
        torch.cuda.synchronize()
        names = ("requests", "query tiles", "ref tiles", "sizes")
        for name, a, b in zip(names, k, p):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"gact_next {name} on {what}: {a.shape} {a.dtype} vs "
                  f"{b.shape} {b.dtype}")
            err = int((a.long() - b.long()).abs().max())
            check(err == 0, f"gact_next != plain on {what}, stop_thr={thr}: "
                  f"{name} max |diff| {err}")
            st["max_abs_err"] = max(st.get("max_abs_err", 0), err)
        return k

    for what, rec in (("walker records, B=512", walked),
                      ("synthetic records, B=64", synth)):
        lane, curr = _next_inputs(rng, rec.shape[1], dev, len(ref),
                                  len(query))
        for thr in (0, 1, 320, 384):
            k = exact(rec, lane, curr, T, thr, what)
        clamped = int((k[0][1] < T).sum() + (k[0][3] < T).sum())
        say(3, f"gact_next {what}, stop_thr in (0, 1, 320, 384), both "
               f"orientations: requests, query and ref tiles, sizes exact "
               f"({clamped} tile sides clamped at a sequence end at "
               f"stop_thr 384)")
    for RT, nb in ((45, 37), (1000, 100)):
        n_ins = np.where(rng.random((RT, nb)) < 0.02,
                         rng.integers(0, 10, (RT, nb)), 0)
        rec = torch.from_numpy((n_ins | rng.integers(0, 4, (RT, nb)) << 14)
                               .astype(np.int32)).to(dev)
        lane, curr = _next_inputs(rng, nb, dev, len(ref), len(query))
        for thr in (0, RT - 64, 2 * RT):
            exact(rec, lane, curr, RT, thr, f"random records {RT}x{nb}")
    say(3, "gact_next random records 45x37 and 1000x100 (tile side = rows; "
           "three staged chunks at 1000), three stop_thr each: exact")

    lane, curr = _next_inputs(rng, B, dev, len(ref), len(query))

    def kern():
        return gact_cuda.next_tiles(walked, lane, curr, ref, query, T, 320,
                                    2 * T)

    def plain():
        return gact.spec_next_tiles(walked, lane, curr, ref, query, T, 320,
                                    2 * T)
    self_ms = _self_ms({"next": (kern, "gact_next_kernel")}, 20)["next"]
    kms = _time_ms(kern, 20)
    pms = _time_ms(plain, 1)
    # what the function must move: the records and the lane inputs read
    # once, the codes of both tiles read once, the (8, B) int64 requests,
    # both (B, T) tiles and the (4, B) int32 sizes written once
    n_bytes = (walked.numel() * 4 + (5 + 2) * B * 8 + 2 * B * T
               + 8 * B * 8 + 2 * B * T + 4 * B * 4)
    bms, bby = bound(n_bytes, 0)
    say(3, f"gact_next walker records 384x512, stop_thr 320, with the next "
           f"level's gather: kernel {kms:.4f} ms per call of 20 enqueued "
           f"back to back, {self_ms:.4f} ms device self time, plain "
           f"{pms:.2f} ms, bound {bms:.5f} ms by {bby}")
    st.update(ms=kms, plain_ms=pms, bound_ms=bms, bound_by=bby)


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

    _check_next(rng, kstats, default)

    # the op-rate probe, every mode, against its plain twin: exact
    # (wraparound included: the chains overflow int32 within 64 reps) at
    # one program, at fewer programs than the persistent grid has blocks
    # for, and at the timed count
    x = torch.from_numpy(rng.integers(0, 1 << 20, (vpu_probe.QT,
                                                   vpu_probe.LANES))
                         .astype(np.int32)).to(dev)
    programs = 8192
    st = kstats["int_probe"]
    # each mode's bound by its operations and the pipes that issue them,
    # with the compiled kernel's split beside it (vpu_probe.mode_bounds)
    blocks = {m: vpu_probe.grid_blocks(m, programs) for m in vpu_probe.MODES}
    pipe_bounds = vpu_probe.mode_bounds(programs, sass, blocks)
    for mode in vpu_probe.MODES:
        p = vpu_probe.probe_plain(x, mode)
        for n in (1, 3, programs):
            k = vpu_probe.probe_block(x, mode, n)
            torch.cuda.synchronize()
            err = int((k.long() - p.long()).abs().max())
            check(err == 0, f"int_probe != plain in mode {mode} at {n} "
                            f"programs: {err}")
            st["max_abs_err"] = max(st.get("max_abs_err", 0), err)
        kms = _time_ms(lambda: vpu_probe.probe_block(x, mode, programs), 5)
        pms = _time_ms(lambda: vpu_probe.probe_plain(x, mode), 1)
        n_ops = x.numel() * programs * 2 * vpu_probe.REPS
        pb = pipe_bounds[mode]
        cp = pb["compiled"]
        # the block read once and written once
        bms, bby = bound(2 * x.numel() * 4, 0)
        if pb["bound_ms"] > bms:
            bms, bby = pb["bound_ms"], "operations"
        say(3, f"int_probe mode {mode}: exact at programs 1, 3, "
               f"{programs}; at {programs} on {blocks[mode]} blocks kernel "
               f"{kms:.3f} ms = {n_ops / kms / 1e9:.3f} Tops (2 ops per "
               f"rep), plain (one program) {pms:.2f} ms, bound {bms:.4f} "
               f"ms by {bby} ({pb['ops'][0]} ALU-only of {pb['ops'][1]} "
               f"operations per element, set by {pb['bound_pipe']}) = "
               f"{bms / kms:.3f} of the time; the compiled kernel's floor "
               f"{cp['floor_ms']:.4f} ms by {cp['floor_pipe']} = "
               f"{cp['floor_ms'] / kms:.3f} (thread-instructions executed "
               f"{cp['pipes']}, others {cp['other']})")
        fn = next(f for f in sass
                  if f"int_probe_kernelILi{vpu_probe.MODES.index(mode)}E"
                  in f)
        loop = sum(sass[fn]["loop"].values())
        every = sum(cp["pipes"].values()) + sum(cp["other"].values())
        top = sorted(sass[fn]["loop"].items(), key=lambda kv: -kv[1])[:6]
        say(3, f"int_probe SASS, mode {mode}: {loop} instructions in the "
               f"program loop for {vpu_probe.R} elements x 64 reps "
               f"({cp['loop_per_element']:.2f} per element against the "
               f"chain's {pb['ops'][1]} operations; ALU-only "
               f"{cp['loop_alu_per_element']:.2f} against "
               f"{pb['ops'][0]}), "
               f"{sass[fn]['total'] - loop} outside it; {every} "
               f"thread-instructions a launch = "
               f"{every / (kms * 1e-3) / (vpu_probe.SMS * vpu_probe.CLOCK_HZ):.1f}"
               f" per SM per clock at 1.98 GHz; loop: "
               + ", ".join(f"{o} {n}" for o, n in top))
        # the timed work is the function's: every program runs every rep
        # of the chain, so each rep's max, min or xor is in the loop (its
        # constant adds the compiler may fold: vpu_probe.mode_bounds)
        check(cp["loop_alu_per_element"] >= pb["ops"][0],
              f"int_probe mode {mode}: the program loop holds "
              f"{cp['loop_alu_per_element']:.2f} ALU-only instructions per "
              f"element, fewer than the chain's {pb['ops'][0]}")
        if mode == "max":
            # every program computes the same block, so the twin's one
            # pass is the same function of the same input
            st.update(ms=kms, plain_ms=pms, bound_ms=bms, bound_by=bby)
            self_ms = _self_ms({"probe": (
                lambda: vpu_probe.probe_block(x, mode, programs),
                "int_probe_kernel<0>")}, 5)["probe"]
            say(3, f"int_probe mode max: {self_ms:.3f} ms device self time")


# ---------------------------------------------------------------- phase 4-8

def _counter_block(err_text):
    return [ln for ln in err_text.splitlines() if ln.startswith("#")]


def _chains(err_text):
    """(hits, misses, extension rounds) from run()'s spec line."""
    ln = next(x for x in err_text.splitlines() if "#spec hits" in x)
    return tuple(int(re.search(f"#{k}: (\\d+)", ln).group(1))
                 for k in ("spec hits", "spec misses", "extend rounds"))


def _both_devices(ref, reads, overlap, cfg=None, **run_kw):
    """The same run on cuda and on cpu, at run()'s defaults but for
    ``run_kw``: (stdout, counter block, chains, seconds) per device."""
    import copy
    from darwin_tpu_torch.pipeline.align import run
    res = {}
    for dev in ("cuda", "cpu"):
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        run(ref, reads, overlap, cfg=copy.copy(cfg), out=out, err=err,
            device=dev, **run_kw)
        res[dev] = (out.getvalue(), _counter_block(err.getvalue()),
                    _chains(err.getvalue()), time.perf_counter() - t0)
    return res["cuda"], res["cpu"]


def _same_on_both(phase, what, gpu, cpu):
    """Check a _both_devices pair: output, counter block and chains equal;
    returns the message's middle part."""
    check(gpu[0] == cpu[0], f"{what}: output differs between cuda and cpu")
    check(gpu[1] == cpu[1], f"{what}: counters differ: {gpu[1]} vs {cpu[1]}")
    check(gpu[2] == cpu[2], f"{what}: chains differ (hits, misses, rounds) "
          f"{gpu[2]} vs {cpu[2]}")
    check(gpu[2][0] > 0, f"{what}: no speculative tile was accepted")
    return (f"counter block and chains (hits, misses, rounds {gpu[2]}) "
            f"identical on cuda ({gpu[3]:.1f} s) and cpu ({cpu[3]:.1f} s)")


def phase_parity(seed):
    """The same small run on cuda and on cpu, with the default scoring and
    with path A's: SAM, counters and chains equal."""
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
            gpu, cpu = _both_devices(ref, reads, False, cfg)
            n_rec = sum(1 for ln in gpu[0].splitlines()
                        if not ln.startswith("@"))
            check(n_rec > 0, f"parity run ({label}) produced no SAM records")
            same = _same_on_both(4, f"{label} scoring", gpu, cpu)
            say(4, f"200 kb genome, 24 x 3 kb reads, {label} scoring, "
                   f"defaults (spec_k=12, pipeline_depth=2): SAM ({n_rec} "
                   f"records, {len(gpu[0])} bytes), {same}")
            sams[label] = gpu[0]
    check(sams["default"] != sams["generic"],
          "the generic scoring changed no alignment")


def _run_cli(phase, argv, tmp, n_reads, smi, into=None, **run_kw):
    """One CLI run in ``tmp`` (where its params.cfg is read), in-process
    so the kernel launch counts of exactly this run are read: every count
    is set to 0 just before and read just after.  ``run_kw`` go to run()
    (spec_k, pipeline_depth).  Fails if the index build fell back to the
    host.  Returns (stdout, counter block, launches, chains); ``into`` (a
    dict) also gets run()'s stats_out and the stderr text."""
    from darwin_tpu_torch import cli
    from darwin_tpu_torch.ops import gact_cuda
    out, err = io.StringIO(), io.StringIO()
    stats = {}
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        gact_cuda.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = cli.main(argv + ["--device=cuda"], stats_out=stats,
                          **run_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(gact_cuda.LAUNCHES)
    finally:
        os.chdir(cwd)
    check(rc == 0, f"cli exited {rc}")
    err_text = err.getvalue()
    check("falling back to the host build" not in err_text,
          "the index build fell back to the host")
    if into is not None:
        into.update(stats, err=err_text)
    blk = _counter_block(err_text)
    chains = _chains(err_text)
    m = re.search(r"finalizing seed position table\): (\d+) msec",
                  err_text)
    index_s = int(m.group(1)) / 1000
    align_s = stats["align_seconds"]
    hits, misses, rounds = chains
    path = ", ".join(f"{k}={v}" for k, v in run_kw.items()) or \
        "defaults (spec_k=12, pipeline_depth=2)"
    say(phase, f"path: {path}")
    say(phase, "counters: " + "; ".join(blk))
    say(phase, f"kernel launches in this run: {launches}")
    say(phase, f"index {index_s:.3f} s, align {align_s:.3f} s, cli wall "
               f"{wall:.1f} s: {n_reads / align_s:.1f} reads/s [{smi}]")
    say(phase, "index build: " + _build_line(stats["index_build"]))
    say(phase, f"speculative chains: {hits} hits, {misses} misses, hit "
               f"rate {hits / max(hits + misses, 1):.4f}; {rounds} "
               f"extension rounds")
    say(phase, "stage seconds (stats_out, all batches): " + ", ".join(
        f"{k}={v:.3f}" for k, v in sorted(stats["stage_seconds"].items(),
                                          key=lambda kv: -kv[1])))
    say(phase, "first batch's stages (cold): " + ", ".join(
        f"{k}={v:.3f}" for k, v in sorted(
            stats["stage_seconds_cold"].items(), key=lambda kv: -kv[1])[:6])
        + f"; build seconds in this process {stats['compile_s']:.2f}")
    return out.getvalue(), blk, launches, chains


def _build_line(b):
    """One line of a SeedTable's build_stats."""
    from darwin_tpu_torch.index.minimizers import ROWS, SORT_PIECE
    keys = ("count_pass_s", "scan_pass_s")
    return (f"{b['layout']} by {b['method']}"
            + "".join(f", {k} {b[k]:.3f}" for k in keys if k in b)
            + f", {b['batches']} scan batches of <= {ROWS} rows for "
            f"{b['rows']} rows, {b['sequences_per_batch']:.1f} sequences "
            f"per batch"
            + (f", largest sort piece {b['largest_piece']} keys = "
               f"{b['largest_piece'] / SORT_PIECE:.3f} x SORT_PIECE"
               if "largest_piece" in b else ""))


def _took(kstats, launches, names):
    """Record a path's launch counts; each named kernel must have run."""
    for k in names:
        kstats[k]["launches"] = kstats[k].get("launches", 0) + launches[k]
        check(launches[k] > 0, f"kernel {k} never launched on its path")


# the kernels of the default extension path; spec_k=1 launches no gact_next
DEFAULT_PATH = ["gact_dp", "gact_tb", "gact_next"]


def _locus_share(phase, sam, truth, what):
    """Share of the simulated reads with a SAM record within 200 bp of
    their origin on the right chromosome; every CIGAR must span its read.
    Prints the share and the reads that missed (the first 20)."""
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
    say(phase, f"{len(truth)} reads vs {what}: {n_rec} SAM records; "
               f"{len(best)}/{len(truth)} = {share:.4f} reads on the true "
               f"locus (+-200 bp)")
    for n in sorted(set(truth) - set(best))[:20]:
        say(phase, f"not within 200 bp: {n}: "
                   + ("; ".join(where[n]) or "no record"))
    return share


def _large_tiles(blk):
    return int(next(ln for ln in blk if ln.startswith("#large tiles"))
               .split(":")[1])


def _golden_inputs(phase, case, seed, tmp, argv):
    """At the goldens' seed, the golden of ``case`` (darwin_tpu's run on
    the CPU, darwin_tpu_torch/goldens/real_size.json) after checking that
    the inputs written in ``tmp`` and the CLI's argv are the golden's;
    None at another seed."""
    from darwin_tpu_torch.utils import goldens
    if seed != goldens.SEED:
        say(phase, f"--seed {seed} is not the goldens' ({goldens.SEED}): "
                   f"{case} not held to darwin_tpu's output")
        return None
    entry = goldens.load()[case]
    check(entry["argv"] == argv, f"{case}: argv {argv}, the golden's "
          f"{entry['argv']}")
    bad = goldens.diff_inputs(entry, goldens.input_digests(
        tmp, entry["inputs"]))
    for ln in bad:
        say(phase, f"{case} input differs: {ln}")
    check(not bad, f"{case}: the inputs are not the golden's")
    return entry


def _golden_outputs(phase, case, entry, out, blk, what=""):
    """Hold a run's stdout and counter block to ``entry`` (a no-op without
    one); on a mismatch print the differing records and counter lines,
    then fail."""
    from darwin_tpu_torch.utils import goldens
    if entry is None:
        return
    bad = goldens.diff_outputs(entry, out, blk)
    for ln in bad:
        say(phase, f"{case}{what} differs from darwin_tpu: {ln}")
    check(not bad, f"{case}{what}: output or counters differ from "
          f"darwin_tpu's")
    say(phase, f"{case}{what}: inputs ({', '.join(entry['inputs'])}) equal "
               f"the golden's; stdout sha256 {entry['stdout']['sha256']} "
               f"({entry['stdout']['records']} records) and the 7-line "
               f"counter block equal darwin_tpu's on the CPU "
               f"(backend {entry['darwin_tpu']['backend']})"
               + (f"; {entry['reduced']}" if entry["reduced"] else ""))


def phase_real(phase, seed, kstats, smi, params_cfg, min_share, tmp,
               into=None):
    """Reference-guided mode at real size through the CLI: the E. coli
    K-12-size case in ``tmp`` (written there if it is not), with the
    default scoring (phase 5) or the generic params.cfg (phase 6, path
    A).  Returns (SAM, counter block, chains); ``into`` gets run()'s
    stats_out."""
    from darwin_tpu_torch.utils import synth
    truth = _case(tmp, "ecoli", seed)
    if params_cfg:
        with open(f"{tmp}/params.cfg", "w") as f:
            f.write(params_cfg)
    case = "ecoli_generic" if params_cfg else "ecoli"
    argv = ["ref.fa", "reads.fa", "0"]
    golden = _golden_inputs(phase, case, seed, tmp, argv)
    sam, blk, launches, chains = _run_cli(phase, argv, tmp, len(truth), smi,
                                          into=into)
    _golden_outputs(phase, case, golden, sam, blk)
    share = _locus_share(phase, sam, truth, f"{synth.ECOLI_LEN} bp")
    check(share >= min_share,
          f"only {share:.4f} of reads on the true locus")
    check(_large_tiles(blk) > 0, "no large tiles fired")
    check(chains[0] > 0, "no speculative tile was accepted")
    _took(kstats, launches, DEFAULT_PATH)
    return sam, blk, chains


def _case(tmp, name, seed):
    """Write phase 5's (``ecoli``) or phase 7's (``overlap``) real-size
    case into ``tmp`` unless it is there; returns its truth."""
    from darwin_tpu_torch.utils import synth
    make = {"ecoli": synth.ecoli_case, "overlap": synth.overlap_case,
            "chr21": synth.chr21_case}[name]
    path = f"{tmp}/truth.json"
    if not os.path.exists(path):
        truth = make(seed, tmp)
        with open(path, "w") as f:
            json.dump(truth, f)
    with open(path) as f:
        return {k: tuple(v) for k, v in json.load(f).items()}


def _mhap_pairs(mhap):
    return {frozenset(ln.split()[:2]) for ln in mhap.splitlines()
            if " " in ln}


def phase_overlap(seed, kstats, smi, tmp_real, stats):
    """Path B, overlap mode: a small run on cuda and on cpu with identical
    MHAP, counters and chains, then 512 x 10 kb reads at 10x coverage
    against themselves through the CLI (the case in ``tmp_real``), checked
    against the simulation.  Returns (MHAP, counter block, chains);
    ``stats`` gets run()'s stats_out."""
    from darwin_tpu_torch.config import Config
    from darwin_tpu_torch.utils import synth
    with tempfile.TemporaryDirectory() as tmp:
        synth.overlap_case(seed + 7, tmp, genome_len=40_000, n_reads=32,
                           read_len=3000)
        cfg = Config()
        cfg.seed_size = 11          # a 100 kb read set wants a shorter seed
        # chains of 2, not 12: the CPU's twins pay for every level (100 s
        # at 12, 70 s at 4); phase 4 holds the defaults to the CPU
        gpu, cpu = _both_devices(f"{tmp}/reads.fa", f"{tmp}/reads.fa",
                                 True, cfg, spec_k=2)
    n_rec = len(_mhap_pairs(gpu[0]))
    check(n_rec > 0, "overlap parity run found no overlaps")
    same = _same_on_both(7, "overlap parity run", gpu, cpu)
    say(7, f"32 x 3 kb reads of a 40 kb genome vs themselves, spec_k=2, "
           f"pipeline_depth=2: MHAP ({n_rec} pairs, {len(gpu[0])} bytes), "
           f"{same}")

    min_overlap = Config().min_overlap
    truth = _case(tmp_real, "overlap", seed)
    argv = ["reads.fa", "reads.fa", "1"]
    golden = _golden_inputs(7, "overlap", seed, tmp_real, argv)
    mhap, blk, launches, chains = _run_cli(7, argv, tmp_real, len(truth),
                                           smi, into=stats)
    _golden_outputs(7, "overlap", golden, mhap, blk)
    check(not mhap.startswith("@"), "overlap mode printed a SAM header")
    # the read index is one work list: a handful of device batches
    check(stats["index_build"]["batches"] <= 4,
          f"the read index took {stats['index_build']['batches']} batches")

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
    # floors set from a correct run, whose MHAP and counters are
    # darwin_tpu's byte for byte (the overlap golden, held above at the
    # goldens' seed): the (-, +) quarter of the pairs is found only when
    # the overlap is most of the read
    check(found >= 0.75 * len(want), "true overlaps were missed")
    long_hit, long_n = bands[max(bands)]
    check(long_hit >= 0.95 * long_n, "long true overlaps were missed")
    check(chains[0] > 0, "no speculative tile was accepted")
    _took(kstats, launches, DEFAULT_PATH)
    return mhap, blk, chains


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
        clk, watts = r["sm_clock_mhz"], r["power_w"]
        check(clk is not None, f"no SM clock read beside mode {mode}")
        say(8, f"int32 op rate, mode {mode}: {r['tops']:.3f} Tops (2 ops "
               f"per rep); {r['ms']:.3f} / {r['ms_median']:.3f} / "
               f"{r['ms_max']:.3f} ms per launch (min / median / max of 3 "
               f"windows of {res['launches_per_window']}); bound "
               f"{r['bound_ms']:.4f} ms by {r['bound_pipe']}, share "
               f"{r['share']:.3f} at 1.98 GHz, share_at_clock "
               f"{r['share_at_clock']:.3f}; sm_clock_mhz {clk['min']:.0f} / "
               f"{clk['median']:.0f} / {clk['max']:.0f}, power "
               + (f"{watts['min']:.1f} / {watts['median']:.1f} / "
                  f"{watts['max']:.1f} W" if watts else "not read")
               + f" (min / median / max of the readings beside the "
               f"windows); the compiled kernel's floor "
               f"{r['compiled']['floor_ms']:.4f} ms by "
               f"{r['compiled']['floor_pipe']}, share "
               f"{r['compiled']['share']:.3f} [{smi}]")
    _took(kstats, launches, ["int_probe"])


CASES = {5: ("ecoli", ["ref.fa", "reads.fa", "0"]),
         7: ("overlap", ["reads.fa", "reads.fa", "1"])}


def _defaults_run(phase, seed, smi, dirs, results, stats, by):
    """The defaults' run of phase 5's or 7's case, made by phase ``by``
    when that phase was not run in this call: (case directory, truth)."""
    name, argv = CASES[phase]
    tmp = dirs(name)
    truth = _case(tmp, name, seed)
    if phase not in results:
        out, blk, _, chains = _run_cli(by, argv, tmp, len(truth), smi,
                                       into=stats.setdefault(phase, {}))
        results[phase] = (out, blk, chains)
    return tmp, truth


def phase_k1(seed, kstats, smi, dirs, results, stats):
    """The cases of phases 5 and 7 without speculation, one read batch at
    a time: the non-speculative path, which must print what the defaults
    print, in more extension rounds.  ``results`` holds the defaults'
    outputs by phase; a phase not run in this call is run here."""
    k1 = dict(spec_k=1, pipeline_depth=1)
    for phase in (5, 7):
        argv = CASES[phase][1]
        tmp, truth = _defaults_run(phase, seed, smi, dirs, results, stats, 9)
        out, blk, launches, chains = _run_cli(9, argv, tmp, len(truth), smi,
                                              **k1)
        d_out, d_blk, d_chains = results[phase]
        check(out == d_out, f"phase {phase}'s case: output at spec_k=1, "
              f"pipeline_depth=1 differs from the defaults'")
        check(blk == d_blk, f"phase {phase}'s case: counters differ: {blk} "
              f"vs {d_blk}")
        check(chains[:2] == (0, 0) and launches["gact_next"] == 0,
              "spec_k=1 speculated")
        check(d_chains[2] < chains[2], f"phase {phase}'s case: the defaults "
              f"took {d_chains[2]} extension rounds, spec_k=1 {chains[2]}")
        say(9, f"phase {phase}'s case at spec_k=1, pipeline_depth=1: output "
               f"({len(out)} bytes) and counter block identical to the "
               f"defaults'; extension rounds {chains[2]} (defaults "
               f"{d_chains[2]})")
        _took(kstats, launches, ["gact_dp", "gact_tb"])


# ---------------------------------------------------------------- 10, 11

def _built(phase, what, store, cfg, **kw):
    """build_seed_table on the card, timed, with the device memory it
    allocated past what was held before it; fails if it fell back to the
    host, or if an all-candidates build took more than the gate priced."""
    from darwin_tpu_torch.index import minimizers as mz
    from darwin_tpu_torch.index.seed_table import build_seed_table
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        t = build_seed_table(store, cfg, "cuda", **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    b = t.build_stats
    check("falling back" not in err.getvalue() and "fallback" not in b,
          f"{what}: the device build fell back to the host")
    table_bytes = sum(x.numel() * x.element_size() for x in (
        t.sorted_hashes, t.positions, t.bucket_offsets) if x is not None)
    lengths = [c.length_unpadded for c in store.chromosomes]
    k, w = cfg.seed_size, cfg.minimizer_window
    scanned = len(mz.work_list(lengths, k)[0]) * (mz.row_len(k, w) - k + 1)
    passes = {"csr": "fill", "stream": "sort"}.get(b["method"])
    first = b.get("count_pass_s", b.get("scan_pass_s"))
    say(phase, f"{what}: {t.num_seeds} seeds "
               f"({t.num_seeds / store.size:.4f} per position), table "
               f"{table_bytes / 2**30:.2f} GiB; {secs:.3f} s"
               + (f" ({passes} pass {secs - first:.3f} s)" if passes
                  else "")
               + f"; peak device memory past the {held / 2**30:.2f} GiB "
               f"held {peak / 2**30:.2f} GiB = {peak / scanned:.1f} B per "
               f"scanned position ({scanned} positions); "
               + _build_line(b))
    if b["method"] == "device":
        gate = mz.device_build_bytes(lengths, k, w)
        check(peak <= gate, f"{what}: the all-candidates build took "
              f"{peak} B, past the gate's {gate} B")
    return t


def _same_buckets(pairs, csr):
    """The two layouts hold the same buckets: the same positions in the
    same order, and csr's offsets are the bucket boundaries of the pairs
    table's hashes."""
    check(torch.equal(pairs.positions, csr.positions),
          "pairs and csr positions differ")
    nb = csr.bucket_offsets.numel() - 1
    dev = pairs.positions.device
    bounds = torch.searchsorted(
        pairs.sorted_hashes, torch.arange(nb + 1, dtype=torch.int32,
                                          device=dev))
    check(torch.equal(bounds.to(torch.int32), csr.bucket_offsets),
          "csr offsets are not the pairs table's bucket boundaries")


def phase_chr21(seed, kstats, smi, tmp):
    """A chr21-size repeat genome, reference-guided, at run()'s defaults:
    the pairs table (automatic method) and the csr table bucket for
    bucket, then the CLI with each layout, whose SAM and counter block
    must be the same, the occupancy cap and the large tiles live."""
    from darwin_tpu_torch.config import Config
    from darwin_tpu_torch.io.fasta import load_genome
    from darwin_tpu_torch.utils import synth
    t0 = time.perf_counter()
    truth = _case(tmp, "chr21", seed)
    store = load_genome(f"{tmp}/ref.fa")
    say(10, f"case written and loaded in {time.perf_counter() - t0:.1f} s: "
            f"{store.size} bp coordinate space, {len(truth)} reads")
    cfg = Config()
    pairs = _built(10, "pairs (automatic method)", store, cfg)
    csr = _built(10, "csr", store, cfg, layout="csr")
    _same_buckets(pairs, csr)
    say(10, "pairs and csr tables: the same buckets, positions and order")
    del pairs, csr
    runs = {}
    for layout in ("pairs", "csr"):
        stats = {}
        sam, blk, launches, chains = _run_cli(
            10, ["ref.fa", "reads.fa", "0", f"--index-layout={layout}"],
            tmp, len(truth), smi, into=stats)
        check(stats["index_build"]["layout"] == layout,
              f"--index-layout={layout} built {stats['index_build']}")
        runs[layout] = (sam, blk, stats["counters"])
        _took(kstats, launches, DEFAULT_PATH)
    check(runs["pairs"][:2] == runs["csr"][:2],
          "the SAM or the counter block differs between the layouts")
    sam, blk, c = runs["csr"]
    share = _locus_share(10, sam, truth,
                         f"a {synth.CHR21_LEN} bp repeat genome")
    say(10, f"--index-layout=pairs and =csr: SAM ({len(sam)} bytes) and "
            f"counter block identical; {c['num_capped_buckets']} of "
            f"{c['num_queried_buckets']} queried buckets over the "
            f"occupancy cap, {_large_tiles(blk)} large tiles")
    check(c["num_capped_buckets"] > 0, "the occupancy cap never bit")
    check(_large_tiles(blk) > 0, "no large tiles fired")
    check(share >= MIN_REPEAT_LOCUS_SHARE,
          f"only {share:.4f} of reads on the true locus")
    # darwin_tpu's run on the CPU covers a subset of the reads (its CPU
    # time): the CLI on that subset with each layout, held to the golden
    from darwin_tpu_torch.utils import goldens
    n = synth.subset_reads(f"{tmp}/reads.fa", f"{tmp}/reads_sub.fa",
                           slice(None, None,
                                 goldens.CASES["chr21_sub"]["subset"]))
    argv = ["ref.fa", "reads_sub.fa", "0"]
    golden = _golden_inputs(10, "chr21_sub", seed, tmp, argv)
    for layout in ("pairs", "csr"):
        sam, blk, launches, _ = _run_cli(
            10, argv + [f"--index-layout={layout}"], tmp, n, smi)
        _golden_outputs(10, "chr21_sub", golden, sam, blk,
                        f" (--index-layout={layout})")
        _took(kstats, launches, DEFAULT_PATH)


def phase_human(seed, kstats, smi, tmp):
    """GRCh38's coordinate space (3.09 Gbp, 24 chromosomes) through the
    CLI: ``utils.synth.human_case`` written into ``tmp`` (3.09 GB FASTA,
    512 reads), the csr index at k = 14, w = 3 and the pairs table by the
    automatic method the same bucket for bucket, the CLI with
    --index-layout=csr and the pairs table sharded over a mesh of 2 by
    Aligner(mesh, shard_index=True), both held to the ``human`` golden."""
    import resource
    from darwin_tpu_torch.config import Config
    from darwin_tpu_torch.genome import make_read
    from darwin_tpu_torch.index.minimizers import device_build_bytes
    from darwin_tpu_torch.index.seed_table import device_build_fits
    from darwin_tpu_torch.io.fasta import iter_read_batches
    from darwin_tpu_torch.ops import gact_cuda
    from darwin_tpu_torch.pipeline import align, printer
    from darwin_tpu_torch.utils import synth
    t_phase = t0 = time.perf_counter()
    # human_case's two halves, so the drawn store serves the builds below
    store, sim = synth.human_inputs(seed)
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    truth = synth.write_case(tmp, store, sim)
    written_s = time.perf_counter() - t0
    argv = ["ref.fa", "reads.fa", "0", "--index-layout=csr"]
    t0 = time.perf_counter()
    golden = _golden_inputs(11, "human", seed, tmp, argv)
    hashed_s = time.perf_counter() - t0
    start = {c.name: c.start for c in store.chromosomes}
    check(start["chr14"] >= 1 << 31, "chr14 starts below 2^31")
    span = synth.HUMAN_READ_LEN
    across = sum(1 for c, s0, _ in truth.values()
                 if start[c] + s0 < 1 << 31 <= start[c] + s0 + span - 1)
    past = sum(1 for c, s0, _ in truth.values() if start[c] + s0 >= 1 << 31)
    chry = store.chromosomes[-1]
    tail = sum(1 for c, s0, _ in truth.values()
               if c == chry.name and s0 + span == chry.length_unpadded)
    say(11, f"{len(store.chromosomes)} chromosomes, {store.size} bp "
            f"coordinate space, {len(truth)} reads ({past} start past 2^31, "
            f"{across} hold global coordinate 2^31, {tail} end at "
            f"{chry.name}'s last base): drawn in {made_s:.1f} s, ref.fa "
            f"and reads.fa written in {written_s:.1f} s, hashed in "
            f"{hashed_s:.1f} s")
    check(across > 0 and tail > 0, "no read across 2^31 or at the end")
    cfg = Config()
    csr = _built(11, f"csr, k={cfg.seed_size}, w={cfg.minimizer_window}",
                 store, cfg, layout="csr")
    torch.cuda.empty_cache()
    lengths = [c.length_unpadded for c in store.chromosomes]
    k, w = cfg.seed_size, cfg.minimizer_window
    fits = device_build_fits(lengths, k, w, torch.device("cuda", 0))
    say(11, f"all-candidates build would need "
            f"{device_build_bytes(lengths, k, w) / 2**30:.0f} GiB: "
            f"{'fits' if fits else 'past the gate'}")
    pairs = _built(11, "pairs (automatic method)", store, cfg)
    check(pairs.build_stats["method"] == "stream",
          f"the automatic method took {pairs.build_stats['method']}")
    _same_buckets(pairs, csr)
    say(11, "pairs and csr tables: the same buckets, positions and order")
    del csr
    mesh, what = _mesh_of(2)
    _sharded_dsoft(cfg, pairs, [make_read(n, q) for n, q, _ in sim], mesh,
                   what)
    del sim
    torch.cuda.empty_cache()

    # the CLI as a user runs it: the 3.09 GB FASTA, its own csr build
    sam, blk, launches, _ = _run_cli(11, argv, tmp, len(truth), smi)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    _golden_outputs(11, "human", golden, sam, blk)
    share = _locus_share(11, sam, truth, f"a {store.size} bp coordinate "
                                         f"space")
    say(11, f"the CLI: {_large_tiles(blk)} large tiles; host peak RSS "
            f"{rss:.1f} GiB")
    check(share >= MIN_LOCUS_SHARE,
          f"only {share:.4f} of reads on the true locus")
    check(_large_tiles(blk) > 0, "no large tiles fired")
    _took(kstats, launches, DEFAULT_PATH)

    # the same reads, in run()'s batches of 128, through the pairs table
    # sharded over the mesh
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    aligner = align.Aligner(cfg, store, table=pairs, device="cuda",
                            mesh=mesh, shard_index=True)
    init_s = time.perf_counter() - t0
    gact_cuda.reset_launches()
    t0 = time.perf_counter()
    lines = []
    for batch in iter_read_batches(f"{tmp}/reads.fa", 128):
        lines += aligner.align_batch(batch)
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    align_s = time.perf_counter() - t0
    launches = dict(gact_cuda.LAUNCHES)
    out = printer.sam_header(store) + "".join(lines)
    m_blk = align.counter_block(aligner.counters)
    label = " (Aligner(mesh of 2, shard_index=True))"
    _golden_outputs(11, "human", golden, out, m_blk, label)
    check(out == sam, f"{label}: SAM differs from the CLI's")
    check(m_blk == blk, f"{label}: counters {m_blk}, the CLI's {blk}")
    m = aligner.mesh_dispatch
    say(11, f"aligned by Aligner(mesh of 2, shard_index=True) on the pairs "
            f"table: SAM and counter block identical to the CLI's; set-up "
            f"{init_s:.1f} s, align {align_s:.2f} s = "
            f"{len(truth) / align_s:.1f} reads/s; kernel launches "
            f"{launches}; per shard: " + _shard_launches(
                {"devices": [str(d) for d in m.mesh], "lanes": m.lanes,
                 "launches": m.launches}) + f" [{smi}]")
    _took(kstats, launches, DEFAULT_PATH)
    say(11, f"phase 11: {time.perf_counter() - t_phase:.1f} s [{smi}]")


def phase_gaps(seed, kstats, smi, tmp):
    """GRCh38 with its N gaps (``utils.synth.human_gaps_case``: phase 11's
    genome with 133 Mbp of N in GRCh38's gap classes, 512 reads at the
    blocks' edges, beside them, across scaffold gaps and from N-free
    windows): the csr index's digest, seed count and largest bucket held
    to darwin_tpu's table (the ``human_gaps`` golden), the streaming
    pairs build bucket for bucket against it, and the CLI with
    --index-layout=csr held to the golden's SAM and counter block."""
    import resource
    from darwin_tpu_torch.config import Config
    from darwin_tpu_torch.index.minimizers import device_build_bytes
    from darwin_tpu_torch.index.seed_table import device_build_fits
    from darwin_tpu_torch.utils import goldens, synth
    t_phase = t0 = time.perf_counter()
    # human_gaps_case's two halves, so the drawn store serves the builds
    store, sim = synth.human_gaps_inputs(seed)
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    truth = synth.write_case(tmp, store, sim)
    del sim
    written_s = time.perf_counter() - t0
    argv = ["ref.fa", "reads.fa", "0", "--index-layout=csr"]
    t0 = time.perf_counter()
    golden = _golden_inputs(14, "human_gaps", seed, tmp, argv)
    hashed_s = time.perf_counter() - t0
    n_gap = sum(ln for _, _, ln, _ in synth.HUMAN_GAPS)
    say(14, f"{len(store.chromosomes)} chromosomes, {store.size} bp "
            f"coordinate space, {n_gap} bp of N in "
            f"{len(synth.HUMAN_GAPS)} blocks, {len(truth)} reads "
            f"({synth.HUMAN_GAPS_READS}): drawn in {made_s:.1f} s, written "
            f"in {written_s:.1f} s, hashed in {hashed_s:.1f} s")
    cfg = Config()
    k, w = cfg.seed_size, cfg.minimizer_window
    csr = _built(14, f"csr, k={k}, w={w}", store, cfg, layout="csr")
    t0 = time.perf_counter()
    meta = np.array([csr.kmer_size, csr.minimizer_window, csr.ref_size,
                     csr.kmer_max_occurence], np.int64)
    index = goldens.index_entry(
        meta, csr.bucket_offsets.cpu().numpy(),
        csr.positions.cpu().numpy().view(np.uint32))
    digest_s = time.perf_counter() - t0
    h, n = index["largest_bucket"]
    say(14, f"csr table: index_digest {index['sha256']}, {index['seeds']} "
            f"seeds, largest bucket {h} with {n} positions "
            f"({n / csr.kmer_max_occurence:.0f} x the occupancy cap "
            f"{csr.kmer_max_occurence}); digest in {digest_s:.1f} s")
    if golden is not None:
        check(index == golden["index"], f"the csr table {index} differs "
              f"from darwin_tpu's {golden['index']}")
        say(14, "csr table: digest, seed count and largest bucket equal "
                "darwin_tpu's table (the human_gaps golden)")
    torch.cuda.empty_cache()
    lengths = [c.length_unpadded for c in store.chromosomes]
    fits = device_build_fits(lengths, k, w, torch.device("cuda", 0))
    say(14, f"all-candidates build would need "
            f"{device_build_bytes(lengths, k, w) / 2**30:.0f} GiB: "
            f"{'fits' if fits else 'past the gate'}")
    pairs = _built(14, "pairs (automatic method)", store, cfg)
    check(pairs.build_stats["method"] == "stream",
          f"the automatic method took {pairs.build_stats['method']}")
    _same_buckets(pairs, csr)
    say(14, "pairs and csr tables: the same buckets, positions and order")
    # the streaming build's sort pieces are hash ranges of equal width
    n_pieces = pairs.build_stats["sort_pieces"]
    shift = 2 * k - (n_pieces.bit_length() - 1)
    bounds = torch.searchsorted(pairs.sorted_hashes, torch.arange(
        n_pieces + 1, dtype=torch.int32, device="cuda") << shift)
    sizes = (bounds[1:] - bounds[:-1]).tolist()
    big = max(sizes)
    say(14, f"streaming sort pieces: {n_pieces}, keys {min(sizes)}-{big} "
            f"(the largest piece {sizes.index(big)}); the N bucket's piece "
            f"{h >> shift} holds {sizes[h >> shift]} keys, {n} of them the "
            f"N bucket's")
    del pairs, csr, store
    torch.cuda.empty_cache()

    sam, blk, launches, _ = _run_cli(14, argv, tmp, len(truth), smi)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    _golden_outputs(14, "human_gaps", golden, sam, blk)
    groups = [g for g, c in synth.HUMAN_GAPS_READS.items()
              for _ in range(c)]
    by_group = {}
    for name, g in zip(truth, groups):
        by_group.setdefault(g, set()).add(name)
    held = by_group["far"] | by_group["flank"]
    share = _locus_share(
        14, "".join(ln + "\n" for ln in sam.splitlines()
                    if ln.split("\t", 1)[0] in held),
        {n: truth[n] for n in held}, "GRCh38 with N gaps, far and flank "
                                     "reads")
    check(share >= MIN_LOCUS_SHARE,
          f"only {share:.4f} of the far and flank reads on the true locus")
    # a read holding N aligns from its first base outside it: count the
    # reads with a record on their chromosome inside their span
    inside = set()
    for ln in sam.splitlines():
        f = ln.split("\t")
        if ln.startswith("@") or f[0] in held:
            continue
        c, s0, _ = truth[f[0]]
        if f[2] == c and s0 - 200 <= int(f[3]) - 1 < s0 + synth.HUMAN_READ_LEN:
            inside.add(f[0])
    say(14, "reads with a record inside their span: " + ", ".join(
        f"{g} {len(by_group[g] & inside)}/{len(by_group[g])}"
        for g in ("edge", "scaffold")))
    say(14, f"the CLI: {_large_tiles(blk)} large tiles; host peak RSS "
            f"{rss:.1f} GiB")
    _took(kstats, launches, DEFAULT_PATH)
    say(14, f"phase 14: {time.perf_counter() - t_phase:.1f} s [{smi}]")


def _sharded_dsoft(cfg, pairs, reads, mesh, what):
    """The pairs table sharded over ``mesh``: its shards' resident bytes
    and the peak past what was held (on one card the full shards are views
    of the table), then dsoft_sharded on the reads against the replicated
    D-SOFT of the Seeder: every count, valid hit and anchor."""
    from darwin_tpu_torch.parallel.shard_index import dsoft_sharded, \
        shard_seed_table
    from darwin_tpu_torch.seeding import dsoft
    from darwin_tpu_torch.seeding.seeder import Seeder
    devs = [d.index for d in mesh.distinct()]
    for d in devs:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    held = [torch.cuda.memory_allocated(d) for d in devs]
    t0 = time.perf_counter()
    st = shard_seed_table(pairs, mesh)
    for d in devs:
        torch.cuda.synchronize(d)
    secs = time.perf_counter() - t0
    peak = sum(torch.cuda.max_memory_allocated(d) - h
               for d, h in zip(devs, held))
    own = st.resident_bytes()
    say(11, f"pairs table ({pairs.num_seeds} seeds, "
            f"{8 * pairs.num_seeds / 2**30:.2f} GiB) sharded over {what}: "
            f"{len(st.hashes[0])} rows a shard in {secs:.3f} s; bytes each "
            f"shard holds of its own {own} (0: a view of the table); peak "
            f"past the memory held {peak / 2**30:.3f} GiB")
    check(peak <= sum(own) + (1 << 20),
          f"sharding took {peak} B past the {sum(own)} B its shards own")
    seeder = Seeder(pairs, cfg)
    codes2, lengths, kw = seeder.query_rows(reads)
    need = dsoft.dsoft_count(codes2, lengths, pairs.sorted_hashes, **kw)
    hit_cap = max(int(need.max()), 1)
    kw.update(threshold=cfg.dsoft_threshold, bin_size=cfg.bin_size)
    t0 = time.perf_counter()
    want = dsoft.dsoft_device(codes2, lengths, pairs.sorted_hashes,
                              pairs.positions, a_cap=hit_cap,
                              hit_cap=hit_cap, **kw)
    torch.cuda.synchronize()
    rep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = dsoft_sharded(codes2, lengths, st, **kw)
    for d in devs:
        torch.cuda.synchronize(d)
    sh_s = time.perf_counter() - t0
    got = {k: v.cpu().numpy() for k, v in got.items()}
    want = {k: v.cpu().numpy() for k, v in want.items()}
    for k in ("n_hits", "n_anchors", "n_anchors_raw", "n_queried_buckets",
              "n_capped"):
        check((got[k] == want[k]).all(), f"dsoft_sharded != replicated: {k}")
    high = 0
    for row in range(len(got["n_hits"])):
        for k in ("hits_bin", "hits_off", "hits_pos", "anc_pos", "anc_off",
                  "anc_bin"):
            n = int(want["n_hits" if k.startswith("hits") else
                         "n_anchors"][row])
            check((got[k][row, :n] == want[k][row, :n]).all(),
                  f"dsoft_sharded != replicated: {k} of row {row}")
        n = int(want["n_hits"][row])
        high += int((want["hits_pos"][row, :n] >= 1 << 31).sum())
    check(high > 0, "no hit past 2^31")
    say(11, f"dsoft_sharded on {len(got['n_hits'])} rows ({len(reads)} "
            f"reads, both strands) against the replicated D-SOFT: counts, "
            f"{int(want['n_hits'].sum())} hits ({high} past 2^31) and "
            f"{int(want['n_anchors'].sum())} anchors identical; "
            f"{sh_s:.3f} s sharded, {rep_s:.3f} s replicated")


# ---------------------------------------------------------------- 12, 13

def _mesh_of(n=None):
    """A mesh of n devices (by default every card, a power of two): n
    distinct cards where the machine has them, else cuda:0 named n times
    (default 2).  Returns (mesh, what it is)."""
    from darwin_tpu_torch.parallel.shard import Mesh, make_mesh
    have = torch.cuda.device_count()
    if have >= 2:
        n = n or 1 << (have.bit_length() - 1)
        return make_mesh(n), f"{n} distinct cards"
    n = n or 2
    return Mesh(("cuda:0",) * n), f"cuda:0 named {n} times (one card)"


def _shard_launches(m):
    return "; ".join(f"shard {i} ({d}): {m['lanes'][i]} lanes, {la}"
                     for i, (d, la) in enumerate(zip(m["devices"],
                                                     m["launches"])))


def _run_api(phase, ref, reads, overlap, n_reads, smi, **run_kw):
    """run() in-process at its defaults on the card, every launch count set
    to 0 just before and read just after.  Returns (output, counter block,
    launches, stats_out, stderr)."""
    from darwin_tpu_torch.ops import gact_cuda
    from darwin_tpu_torch.pipeline.align import run
    out, err, stats = io.StringIO(), io.StringIO(), {}
    gact_cuda.reset_launches()
    run(ref, reads, overlap, out=out, err=err, device="cuda",
        stats_out=stats, **run_kw)
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    launches = dict(gact_cuda.LAUNCHES)
    say(phase, f"kernel launches in this run: {launches} [{smi}]")
    say(phase, "stage seconds: " + ", ".join(
        f"{k}={v:.3f}" for k, v in sorted(stats["stage_seconds"].items(),
                                          key=lambda kv: -kv[1])[:8]))
    return (out.getvalue(), _counter_block(err.getvalue()), launches, stats,
            err.getvalue())


def phase_mesh(seed, kstats, smi, dirs, results, stats):
    """Phase 5's case through run(mesh=) and run(mesh=, shard_index=True)
    and phase 7's through run(mesh=): output and counter block identical
    to the one-device run of this process; every shard launches every
    kernel of the path."""
    mesh, what = _mesh_of()
    cards = torch.cuda.device_count()
    say(12, f"mesh {[str(d) for d in mesh]}: {what}; "
            f"torch.cuda.device_count() = {cards}")
    for phase, overlap, kws in ((5, False, ({}, {"shard_index": True})),
                                (7, True, ({},))):
        tmp, truth = _defaults_run(phase, seed, smi, dirs, results, stats,
                                   12)
        d_out, d_blk, _ = results[phase]
        d_rps = len(truth) / stats[phase]["align_seconds"]
        ref = f"{tmp}/reads.fa" if overlap else f"{tmp}/ref.fa"
        if cards > 1:
            # the defaults' run (--mesh=auto) meshed every card: the
            # one-device run is mesh='off'
            out, blk, _, st, _ = _run_api(12, ref, f"{tmp}/reads.fa",
                                          overlap, len(truth), smi,
                                          mesh="off")
            check((out, blk) == (d_out, d_blk), f"phase {phase}'s case: "
                  f"--mesh=auto on {cards} cards differs from one device")
            d_rps = len(truth) / st["align_seconds"]
            say(12, f"phase {phase}'s case on one device (mesh='off'): "
                    f"output and counter block identical to the defaults' "
                    f"(--mesh=auto, {cards} cards); {d_rps:.1f} reads/s")
        for kw in kws:
            label = (f"phase {phase}'s case, mesh of {len(mesh)}"
                     + (", sharded index" if kw else ""))
            out, blk, launches, st, err = _run_api(
                12, ref, f"{tmp}/reads.fa", overlap, len(truth), smi,
                mesh=mesh, **kw)
            check(out == d_out, f"{label}: output differs from the "
                  f"one-device run's")
            check(blk == d_blk, f"{label}: counters differ: {blk} vs {d_blk}")
            line = (f"[darwin_tpu_torch] mesh: {len(mesh)} devices"
                    + (" (sharded index)" if kw else ""))
            check(line in err.splitlines(), f"{label}: no line {line!r}")
            m = st["mesh"]
            for i, la in enumerate(m["launches"]):
                check(all(la.get(k, 0) > 0 for k in DEFAULT_PATH),
                      f"{label}: shard {i} launched {la}")
            _took(kstats, launches, DEFAULT_PATH)
            rps = len(truth) / st["align_seconds"]
            crossed = m["cross_copies"]
            say(12, f"{label}: output ({len(out)} bytes) and counter block "
                    f"identical to the one-device run's; {rps:.1f} reads/s "
                    f"(one device in this process: {d_rps:.1f}) [{smi}]")
            say(12, f"{label}: {_shard_launches(m)}")
            say(12, f"{label}: {crossed} copies between two distinct "
                    f"devices; torch.cuda.device_count() = {cards}: "
                    + ("copies crossed cards" if crossed else
                       "no copy crossed cards" + (
                           " (one card: none can)" if cards < 2 else "")))
            check(cards < 2 or crossed > 0,
                  f"{label}: a mesh of distinct cards copied nothing")


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_multihost(seed, smi, dirs, results, stats):
    """Two ranks of the multi-host entry point over phase 5's case, on
    127.0.0.1 over gloo: a real split, the merged SAM the one-process
    run's, the summed counters its counters but the extension rounds, no
    library rebuilt by a rank."""
    from darwin_tpu_torch import native
    from darwin_tpu_torch.ops import build
    tmp, truth = _defaults_run(5, seed, smi, dirs, results, stats, 13)
    want = stats[5]["counters"]
    build.load()
    libs = [build.BUILD_INFO["path"], native._so_path()]
    before = [os.stat(p) for p in libs]
    coord = f"127.0.0.1:{_free_port()}"
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    logs = [open(f"{tmp}/rank{r}.err", "w+") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "darwin_tpu_torch.parallel.multihost",
         "ref.fa", "reads.fa", "0", "multi.sam", "--coordinator", coord,
         "--num-processes", "2", "--process-id", str(r)],
        cwd=tmp, env=env, stdout=subprocess.DEVNULL, stderr=logs[r])
        for r in range(2)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    text = []
    for log in logs:
        log.seek(0)
        text.append(log.read())
        log.close()
    for r, rc in enumerate(rcs):
        check(rc == 0, f"rank {r} exited {rc}:\n{text[r][-3000:]}")
    half = len(truth) // 2
    for r, (a, b) in enumerate(((0, half), (half, len(truth)))):
        check(f"[host {r}/2] reads [{a}, {b})" in text[r],
              f"rank {r} did not take reads [{a}, {b})")
    with open(f"{tmp}/multi.sam") as f:
        sam = f.read()
    check(sam == results[5][0], "the merged SAM differs from the "
          "one-process run's")
    line = next((ln for ln in text[0].splitlines()
                 if ln.startswith("global counters: ")), None)
    check(line is not None, "rank 0 printed no global counters")
    total = {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)", line)}
    rounds = total.pop("num_extend_rounds")
    total.pop("num_decode_calls")       # per read batch too
    check(total == {k: v for k, v in want.items()
                    if k not in ("num_extend_rounds", "num_decode_calls")},
          f"summed counters {total} differ from {want}")
    after = [os.stat(p) for p in libs]
    check([(a.st_ino, a.st_mtime_ns) for a in after]
          == [(b.st_ino, b.st_mtime_ns) for b in before],
          "a rank rebuilt a library")
    align = [int(m.group(1)) / 1000 for m in (
        re.search(r"aligning reads\): (\d+) msec", t) for t in text)]
    say(13, f"2 ranks on 127.0.0.1 over gloo, torch.cuda.device_count() = "
            f"{torch.cuda.device_count()}: reads [0, {half}) and [{half}, "
            f"{len(truth)}); merged SAM ({len(sam)} bytes) identical to the "
            f"one-process run's; summed counters equal to its counters "
            f"(extension rounds {rounds} against {want['num_extend_rounds']}"
            f" in one process: they count per read batch); align phase "
            f"{align[0]:.3f} / {align[1]:.3f} s per rank, {wall:.1f} s of "
            f"wall for both processes; no library rebuilt [{smi}]")


# ---------------------------------------------------------------- main

ALL_PHASES = {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14}
# measured on a correct run: the generic scoring's cheap gap opens change
# CIGARs, not loci
MIN_LOCUS_SHARE = 0.95
# a repeat genome's segmental duplications (2% diverged) and repeat-dense
# reads leave some reads with a better or an equal locus elsewhere
MIN_REPEAT_LOCUS_SHARE = 0.90


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
    from darwin_tpu_torch.utils import goldens
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
    with contextlib.ExitStack() as stack:
        made = {}

        def dirs(name):
            """A directory for a real-size case, kept for phase 9."""
            if name not in made:
                made[name] = stack.enter_context(
                    tempfile.TemporaryDirectory())
            return made[name]
        results, stats = {}, {}
        if 5 in phases:
            results[5] = phase_real(5, args.seed, kstats, smi, None,
                                    MIN_LOCUS_SHARE, dirs("ecoli"),
                                    into=stats.setdefault(5, {}))
        if 6 in phases:
            with tempfile.TemporaryDirectory() as tmp:
                phase_real(6, args.seed, kstats, smi, GENERIC_PARAMS_CFG,
                           MIN_LOCUS_SHARE, tmp)
        if 7 in phases:
            results[7] = phase_overlap(args.seed, kstats, smi,
                                       dirs("overlap"),
                                       stats.setdefault(7, {}))
        if 8 in phases:
            phase_probe(kstats, smi)
        if 9 in phases:
            phase_k1(args.seed, kstats, smi, dirs, results, stats)
        if 12 in phases:
            phase_mesh(args.seed, kstats, smi, dirs, results, stats)
        if 13 in phases:
            phase_multihost(args.seed, smi, dirs, results, stats)
        if 10 in phases:
            with tempfile.TemporaryDirectory() as tmp:
                phase_chr21(args.seed, kstats, smi, tmp)
    if 11 in phases:
        with tempfile.TemporaryDirectory() as tmp:
            phase_human(args.seed, kstats, smi, tmp)
    if 14 in phases:
        with tempfile.TemporaryDirectory() as tmp:
            phase_gaps(args.seed, kstats, smi, tmp)
    if phases != ALL_PHASES or args.seed != goldens.SEED:
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
