"""Sustained int32 op rate of the card, by op mix (counterpart of
``tools/vpu_probe.py``, the probe behind darwin_tpu's roofline):

    python -m darwin_tpu_torch.tools.vpu_probe [--programs N] [--samples N]

prints one JSON line ``{"device": ..., "power_limit": ..., mode: {"tops":
..., "ms": ..., ...}}``.  The tile DP (``csrc/gact_dp.cu``) is made of these
ops — int32 max, add, compare + select — so its bound on a card is its
integer ops per cell times its cells over the rate measured here.

``probe_block`` launches ``csrc/int_probe.cu`` for a CUDA tensor, on the
current stream, without synchronising; a tensor on the CPU takes the plain
twin ``probe_plain``; any other device raises.  One program reads a
(384, 128) int32 block, runs 64 reps of a dependent chain on every element
and writes ``x + y``; ``programs`` programs compute the same block.
Arithmetic wraps (two's complement), as torch's int32 does.

``tops`` counts 2 ops per rep and element whatever the mode, as the
original does: ``sel`` does 4 source-level ops per rep and ``shift`` 3, so
scale those by 2 and 1.5; ``max4`` does 4 per rep over half the reps.
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


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def probe(modes=MODES, programs: int = 8192, samples: int = 5,
          launches: int = 8, seed: int = 0, device="cuda") -> dict:
    """Time each mode on the card: ``samples`` windows of ``launches``
    launches of ``programs`` programs, CUDA events around each window.
    Returns {mode: {"tops" (from the fastest window), "ms" per launch
    min / median / max over the windows}}."""
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
    ops = QT * LANES * programs * 2 * REPS
    for mode in modes:
        probe_block(x, mode, programs)              # warm
        ms = []
        for _ in range(samples):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(launches):
                probe_block(x, mode, programs)
            end.record()
            torch.cuda.synchronize(dev)
            ms.append(start.elapsed_time(end) / launches)
        out[mode] = {"tops": ops / (min(ms) * 1e-3) / 1e12,
                     "ms": min(ms), "ms_median": float(np.median(ms)),
                     "ms_max": max(ms)}
    return out


def sass_counts() -> dict:
    """Instruction counts per kernel of the built library, from
    ``cuobjdump -sass``: {kernel: {"total": n, "loop": {opcode: n},
    "all": {opcode: n}, "loops": [{opcode: n}, ...]}} where "loops" holds
    the span of every backward branch and "loop" the longest of them (the
    probe's chains are unrolled and have none worth the name).  Needs the
    CUDA toolkit."""
    build.load()                      # builds the library if needed
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", build.BUILD_INFO["path"]],
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
