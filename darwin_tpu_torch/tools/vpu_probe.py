"""Sustained int32 op rate of the card, by op mix (counterpart of
``tools/vpu_probe.py``, the probe behind darwin_tpu's roofline):

    python -m darwin_tpu_torch.tools.vpu_probe [--programs N] [--samples N]

prints one JSON line ``{"device": ..., "power_limit": ..., mode: {"tops":
..., "ms": ..., "bound_ms": ..., "share": ..., "sm_clock_mhz": {"min",
"median", "max"}, "share_at_clock": ..., ...}}``.  The tile DP
(``csrc/gact_dp.cu``) is made of these ops — int32 max, add, compare +
select — so its bound on a card is its integer ops per cell times its cells
over the rate measured here.

Each mode's bound comes from its own operations (``mode_bounds``,
``MODE_OPS``): the larger of those only the ALU pipe issues (min / max,
logic, compare + select) over its 64 int32 lanes per SM and all of them
over the 128 lanes of the ALU and FMA pipes (an add issues on either).
Every mode's chain is at most half ALU-only, so every bound is the
128-lane one.  ``share`` is that bound over the mode's fastest time, at
the published 1.98 GHz; ``share_at_clock`` the same at the median SM
clock that ``nvidia-smi`` read beside the timed windows
(``sm_clock_mhz``).  The compiled kernel (``cuobjdump`` SASS; the chain
is unrolled inside a loop over the programs, so the loop's span runs once
per program and the rest once per thread: ``executed``) is put through
the same rule beside it, as the compiler's split: its address and loop
instructions are not the function's, so that floor is no bound.  The tile
DP's bound (``chip_smoke.py``) divides all its operations by the 128
lanes: its maxes and adds pair into DPX add-max and three-way max
instructions, so a count of its ALU-only operations is no floor for it.

``probe_block`` launches ``csrc/int_probe.cu`` for a CUDA tensor, on the
current stream, without synchronising; a tensor on the CPU takes the plain
twin ``probe_plain``; any other device raises.  One program reads a
(384, 128) int32 block, runs 64 reps of a dependent chain on every element
and writes ``x + y``; ``programs`` programs compute the same block.
Arithmetic wraps (two's complement), as torch's int32 does.

``tops`` counts 2 ops per rep and element whatever the mode, as the
original does: ``sel`` does 3 operations per rep (its compare + select is
one min), so scale it by 1.5; ``shift`` does 2 and a row move; ``max4``
does 4 per rep over half the reps.
``sass_counts`` says what the compiler really emitted.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import threading

import numpy as np
import torch

from darwin_tpu_torch.ops import build, gact_cuda

MODES = ("max", "add", "sel", "shift", "max4")
QT, LANES = 384, 128
REPS = 64              # chain length per program


def probe_plain(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain twin of the ``int_probe`` kernel (tools/vpu_probe.py:63-93):
    x (384, 128) int32 -> (384, 128) int32, on any device."""
    if mode not in MODES:
        raise ValueError(f"unknown probe mode {mode!r}")
    y = x + 1
    if mode == "max":
        for _ in range(REPS):
            x = torch.maximum(x, y)
            y = y + x
    elif mode == "add":
        for _ in range(REPS):
            x = x + y
            y = y ^ x
    elif mode == "sel":
        for _ in range(REPS):
            x = torch.where(x > y, y, x) + 1
            y = y + 1
    elif mode == "shift":
        pad = torch.zeros((1, x.shape[1]), dtype=x.dtype, device=x.device)
        for _ in range(REPS):
            x = torch.maximum(torch.cat([pad, x[:-1]], 0), y)
            y = y + x
    else:
        a, b, c, d = x, y, x + 3, y ^ 5
        for _ in range(REPS // 2):
            a = torch.maximum(a, b)
            b = b + 1
            c = torch.maximum(c, d)
            d = d + 3
        x, y = a + c, b + d
    return x + y


# What bounds each mode: its integer operations as csrc/int_probe.cu writes
# the chain, per element of one program: (those only the ALU pipe issues,
# all of them).  Min / max, logic (the add mode's xor) and compare + select
# (sel's, one min) issue only on the ALU pipe's 64 int32 lanes per SM; an
# add issues there or, as a multiply-add, on the FMA pipe's 64, so the
# integer operations share 128 lanes (the CUDA programming guide's
# throughput table, compute capability 9.0).  Every mode adds y = x + 1
# and the output x + y; shift's row shift is a move; max4 does two maxes
# and two adds per rep over REPS / 2 reps, with c = x + 3, d = y ^ 5,
# x + c and y + d around them.
MODE_OPS = {"max": (REPS, 2 * REPS + 2), "add": (REPS, 2 * REPS + 2),
            "sel": (REPS, 3 * REPS + 2), "shift": (REPS, 2 * REPS + 2),
            "max4": (REPS + 1, 2 * REPS + 6)}
# lanes per SM per clock: ALU-only, FMA-only (multiplies), either integer
# pipe, the shuffle unit
LANES_OF = {"alu": 64, "fma": 64, "alu+fma": 128, "shfl": 32}
# For reading the compiled chains only (``mode_bounds``' "compiled"): the
# class of each integer opcode the probe compiles to — min / max, logic,
# compare, select and shifts on the ALU pipe, multiplies (IMAD, also used
# for adds) on the FMA pipe, shuffles on their unit, and adds (IADD3,
# VIADD) only in the shared term, their pipe not being documented.
# Memory, control, moves and uniform-datapath opcodes are listed apart.
SASS_CLASS = {"IMNMX": "alu", "VIMNMX": "alu", "VIADDMNMX": "alu",
              "ISETP": "alu", "SEL": "alu", "LOP3": "alu", "SHF": "alu",
              "LEA": "alu", "IABS": "alu", "PRMT": "alu", "IMAD": "fma",
              "IMUL": "fma", "IADD3": "add", "VIADD": "add",
              "SHFL": "shfl"}
# the card's SMs and boost clock (NVIDIA's H100 SXM data sheet)
SMS, CLOCK_HZ = 132, 1.98e9
# csrc/int_probe.cu's geometry: R rows a thread, COLS columns a block of
# BLOCK_THREADS threads, a program LANES / COLS blocks' work
R, COLS = 12, 8
BLOCK_THREADS = QT // R * COLS
THREADS_PER_PROGRAM = LANES // COLS * BLOCK_THREADS


def floor_ms(alu=0, fma=0, every=0, shfl=0):
    """The least ms, and the term that sets it, for ``alu`` ALU-only,
    ``fma`` FMA-only and ``shfl`` shuffle thread-instructions (or element
    operations) and ``every`` integer ones in all."""
    per = {"alu": alu, "fma": fma, "alu+fma": every, "shfl": shfl}
    ms = {p: k / (LANES_OF[p] * SMS * CLOCK_HZ) * 1e3 for p, k in per.items()}
    pipe = max(ms, key=ms.get)
    return ms[pipe], pipe


def executed(info: dict, programs: int, blocks: int) -> dict:
    """Thread-instructions one launch of ``programs`` programs on
    ``blocks`` blocks executes, by opcode, from a kernel's ``sass_counts()``
    entry: the program loop's span ("loop") once per program and column
    slice (THREADS_PER_PROGRAM threads a program), every other instruction
    once per thread of the grid (BLOCK_THREADS a block: the load, the store
    and the loop's way in and out; a block with no program runs fewer)."""
    loop = info["loop"]
    return {op: loop.get(op, 0) * programs * THREADS_PER_PROGRAM
            + (n - loop.get(op, 0)) * blocks * BLOCK_THREADS
            for op, n in info["all"].items()}


def mode_bounds(programs: int, sass: dict | None = None,
                blocks: dict | None = None) -> dict:
    """Each mode's bound for one launch of ``programs`` programs, from its
    operations (``MODE_OPS``): {mode: {"bound_ms", "bound_pipe", "ops":
    [ALU-only, all] per element}}.  With ``sass`` (``sass_counts()``) and
    ``blocks`` ({mode: blocks of the launch}, ``grid_blocks``) also
    "compiled": the thread-instructions the launch executes (``executed``)
    by class, the opcodes outside the classes ("other"), the same floor for
    them ("floor_ms", "floor_pipe") — the compiler's split, not a bound of
    the function — and the program loop's instructions per element
    ("loop_per_element": about the mode's operations, fewer where the
    compiler folds a chain's constant adds into three-source adds and
    add-mins) and its ALU-only ones ("loop_alu_per_element": every rep's
    max, min or xor, which no folding removes, so at least the mode's
    ALU-only operations when every program computes the whole chain)."""
    out = {}
    for mode, (alu, every) in MODE_OPS.items():
        n = QT * LANES * programs
        ms, pipe = floor_ms(alu=alu * n, every=every * n)
        out[mode] = {"bound_ms": ms, "bound_pipe": pipe,
                     "ops": [alu, every]}
    for fn, info in (sass or {}).items():
        m = re.search(r"int_probe_kernelILi(\d)E", fn)
        if not m:
            continue
        mode = MODES[int(m.group(1))]
        pipes = dict.fromkeys(("alu", "fma", "add", "shfl"), 0)
        other = {}
        for op, n in executed(info, programs, blocks[mode]).items():
            if op in SASS_CLASS:
                pipes[SASS_CLASS[op]] += n
            else:
                other[op] = n
        ms, pipe = floor_ms(alu=pipes["alu"], fma=pipes["fma"],
                            every=pipes["alu"] + pipes["fma"] + pipes["add"],
                            shfl=pipes["shfl"])
        out[mode]["compiled"] = {
            "pipes": pipes, "other": other, "floor_ms": ms,
            "floor_pipe": pipe,
            "loop_per_element": sum(info["loop"].values()) / R,
            "loop_alu_per_element": sum(
                n for op, n in info["loop"].items()
                if SASS_CLASS.get(op) == "alu") / R}
    return out


def probe_block(x: torch.Tensor, mode: str, programs: int = 1):
    """One launch of the probe kernel: ``programs`` programs each compute
    ``probe_plain(x, mode)`` into the same (384, 128) output."""
    dev = x.device
    gact_cuda.check_tensor("x", x, torch.int32, 2, dev)
    if tuple(x.shape) != (QT, LANES):
        raise ValueError(f"x must be ({QT}, {LANES}), got {tuple(x.shape)}")
    if mode not in MODES:
        raise ValueError(f"unknown probe mode {mode!r}")
    if dev.type == "cpu":
        return probe_plain(x, mode)
    if dev.type != "cuda":
        raise ValueError(f"probe_block: unsupported device {dev}")
    lib = build.load()
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = lib.int_probe(gact_cuda.ptr(x), gact_cuda.ptr(out),
                            MODES.index(mode), int(programs),
                            gact_cuda.stream_ptr(dev))
    gact_cuda.count_launch("int_probe", err,
                           f"mode {mode}, programs={programs}")
    return out


def grid_blocks(mode: str, programs: int, device="cuda") -> int:
    """The blocks (of BLOCK_THREADS threads) one launch of ``programs``
    programs in ``mode`` takes on the card: as many as it holds at once,
    no more than the programs need (csrc/int_probe.cu:grid_of)."""
    dev = torch.device(device)
    with torch.cuda.device(dev):
        n = build.load().int_probe_grid(MODES.index(mode), int(programs))
    if n <= 0:
        raise RuntimeError(f"int_probe_grid failed: CUDA error {-n}")
    return n


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


SMI_CLOCKS = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
              "--format=csv,noheader,nounits"]


def parse_clocks(text: str) -> tuple[float, float | None] | None:
    """(SM clock MHz, power draw W) from one ``SMI_CLOCKS`` reading — its
    first line, the first card, as ``power_limit`` reads; None when the
    clock is not a number (``[N/A]``), and a power that is not one is
    None."""
    lines = text.strip().splitlines()
    fields = [f.strip() for f in lines[0].split(",")] if lines else []

    def num(f):
        try:
            return float(f)
        except ValueError:
            return None
    mhz = num(fields[0]) if fields else None
    if mhz is None:
        return None
    return mhz, num(fields[1]) if len(fields) > 1 else None


def spread(values) -> dict | None:
    """{"min", "median", "max"} of the values, None when there are none."""
    values = [v for v in values if v is not None]
    if not values:
        return None
    return {"min": min(values), "median": float(np.median(values)),
            "max": max(values)}


class ClockSampler:
    """Reads ``SMI_CLOCKS`` over and over in a thread while the block runs:
    the first reading starts on entry, and readings go on until exit (the
    one under way then finishes).  ``readings``: (MHz, W) pairs."""

    def __init__(self):
        self.readings = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while True:
            got = parse_clocks(subprocess.run(
                SMI_CLOCKS, capture_output=True, text=True).stdout)
            if got is not None:
                self.readings.append(got)
            if self._stop.is_set():
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def time_windows(launch, samples: int, launches: int, dev) -> tuple:
    """``samples`` windows of ``launches`` calls of ``launch`` (after one to
    warm), CUDA events around each window, the SM clock read beside each:
    (ms per launch of each window, the (MHz, W) readings of all)."""
    launch()
    ms, readings = [], []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with ClockSampler() as clocks:
            start.record()
            for _ in range(launches):
                launch()
            end.record()
            torch.cuda.synchronize(dev)
        ms.append(start.elapsed_time(end) / launches)
        readings += clocks.readings
    return ms, readings


def rates(ms: list, readings: list, programs: int, bound_ms: float) -> dict:
    """A mode's JSON entry from its windows: "tops" (2 ops per rep and
    element, from the fastest window), "ms" / "ms_median" / "ms_max",
    "sm_clock_mhz" and "power_w" (``spread`` of the readings), "bound_ms",
    "share" = bound_ms / ms at the published clock and "share_at_clock" at
    the median sampled one (None without a reading)."""
    ops = QT * LANES * programs * 2 * REPS
    clock = spread(r[0] for r in readings)
    return {"tops": ops / (min(ms) * 1e-3) / 1e12, "ms": min(ms),
            "ms_median": float(np.median(ms)), "ms_max": max(ms),
            "sm_clock_mhz": clock, "power_w": spread(r[1] for r in readings),
            "bound_ms": bound_ms, "share": bound_ms / min(ms),
            "share_at_clock": None if clock is None else
            bound_ms * CLOCK_HZ / (clock["median"] * 1e6) / min(ms)}


def probe(modes=MODES, programs: int = 8192, samples: int = 5,
          launches: int = 32, seed: int = 0, device="cuda") -> dict:
    """Time each mode on the card: ``samples`` windows of ``launches``
    launches of ``programs`` programs, CUDA events around each window and
    the SM clock read beside it (``time_windows``).  Returns {mode:
    ``rates``' entry with ``mode_bounds``' "bound_pipe" and "compiled":
    the compiled kernel's split with its floor's share}."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError("the op-rate probe times the card; device must "
                           "be cuda (probe_plain is the CPU twin)")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 1 << 20, (QT, LANES))
                         .astype(np.int32)).to(dev)
    out = {"device": torch.cuda.get_device_name(dev),
           "power_limit": power_limit(), "programs": programs,
           "launches_per_window": launches}
    blocks = {m: grid_blocks(m, programs, dev) for m in MODES}
    bounds = mode_bounds(programs, sass_counts(), blocks)
    for mode in modes:
        ms, readings = time_windows(
            lambda: probe_block(x, mode, programs), samples, launches, dev)
        b = bounds[mode]
        c = dict(b["compiled"], share=b["compiled"]["floor_ms"] / min(ms))
        out[mode] = dict(rates(ms, readings, programs, b["bound_ms"]),
                         bound_pipe=b["bound_pipe"], blocks=blocks[mode],
                         compiled=c)
    return out


def sass_counts(path: str | None = None) -> dict:
    """Instruction counts per kernel of a library (the built one by
    default), from ``cuobjdump -sass``: {kernel: {"total": n, "loop":
    {opcode: n}, "all": {opcode: n}, "loops": [{opcode: n}, ...]}} where
    "loops" holds the span of every backward branch and "loop" the longest
    of them (the probe's program loop, its unrolled chain inside).  Needs
    the CUDA toolkit."""
    if path is None:
        build.load()                  # builds the library if needed
        path = build.BUILD_INFO["path"]
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", path],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    name, ins = None, []

    def count(span):
        ops = {}
        for _, op, _ in span:
            ops[op] = ops.get(op, 0) + 1
        return ops

    def flush():
        if name is None or not ins:
            return
        every = count(ins)
        best = (0, 0)
        loops = []
        for idx, (addr, op, arg) in enumerate(ins):
            m = re.search(r"0x([0-9a-f]+)", arg) if op == "BRA" else None
            if m and int(m.group(1), 16) < addr:
                tgt = int(m.group(1), 16)
                lo = next(i for i, x in enumerate(ins) if x[0] >= tgt)
                loops.append(count(ins[lo:idx + 1]))
                if idx - lo > best[1] - best[0]:
                    best = (lo, idx + 1)
        out[name] = {"total": len(ins), "all": every,
                     "loop": count(ins[best[0]:best[1]]), "loops": loops}

    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            flush()
            name, ins = m.group(1), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?"
                     r"([A-Z0-9_]+)[.\w]*\s*(.*?);", ln)
        if m and name is not None:
            ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
    flush()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--programs", type=int, default=8192)
    ap.add_argument("--samples", type=int, default=5)
    ap.add_argument("--sass", action="store_true",
                    help="also print the kernels' SASS instruction counts")
    args = ap.parse_args(argv)
    res = probe(programs=args.programs, samples=args.samples)
    if args.sass:
        res["sass"] = sass_counts()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
