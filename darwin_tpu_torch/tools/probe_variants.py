"""The op-rate probe's kernel in several versions on one card, in turns:

    python -m darwin_tpu_torch.tools.probe_variants [--parent SRC]
        [--variants NAME,...] [--programs N] [--rounds N] [--out FILE]

builds ``csrc/int_probe.cu`` as it stands ("change"), each named variant of
it (``VARIANTS``: edits of that source's text — the ops' placement, rows
per thread, blocks per SM, unrolling) and, with ``--parent``,
another source with the same C entry point (an earlier commit's
``int_probe.cu``, "parent"), each alone into a library of its own; holds
every version to ``probe_plain`` in every mode at programs 1, 3 and N;
then times every mode of every version in rounds, the order reversed
every other round (parent, change, change, parent for two versions and
two rounds), with the SM clock read beside each window
(``vpu_probe.time_windows``).  Prints a line per version and mode (ms per
launch of each round, share of the mode's bound at the published and at
the sampled clock, thread-instructions per SM per clock, registers and
spills) and, last, one JSON line with all of it.  Needs the card and
nvcc; the launches here are not counted in ``gact_cuda.LAUNCHES``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from darwin_tpu_torch.ops import build, gact_cuda
from darwin_tpu_torch.tools import vpu_probe

_PLACE = "constexpr bool PTX = MODE == 0 || MODE == 1 || MODE == 3;"
_ADD = """  if (!P) return a + b;
  uint32_t r;
  asm("add.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));"""
_LANES = "int lanes = per_sm * sms / SLICES;"


def _cap(n):
    return [(_LANES, f"int lanes = (per_sm < {n} ? per_sm : {n}) * sms / "
                     f"SLICES;")]


def _rows(r, cols):
    return [("constexpr int R = 12;", f"constexpr int R = {r};"),
            ("constexpr int COLS = 8;", f"constexpr int COLS = {cols};")]


# name -> [(text of csrc/int_probe.cu, what replaces it)]; each text must
# be there, and every copy of it is replaced
VARIANTS = {
    # every mode's max and add in C / as PTX max.s32 and add.u32
    "c": [(_PLACE, "constexpr bool PTX = false;")],
    "ptx": [(_PLACE, "constexpr bool PTX = true;")],
    # every add a mad.lo.u32 by a 1 the compiler cannot see, so that it
    # issues on the FMA pipe
    "mad1": [("template <bool P>\n__device__ __forceinline__ uint32_t add(",
              "__constant__ uint32_t kOne = 1u;\ntemplate <bool P>\n"
              "__device__ __forceinline__ uint32_t add("),
             (_ADD, '  uint32_t r;\n  asm("mad.lo.u32 %0, %1, %2, %3;" : '
                    '"=r"(r) : "r"(a), "r"(kOne), "r"(b));')],
    # 24 / 48 rows (chains) a thread: 16 / 8 threads a column, 256 a block
    "r24": _rows(24, 16),
    "r48": _rows(48, 32),
    # at most 2 / 4 blocks (16 / 32 warps) an SM
    "bps2": _cap(2),
    "bps4": _cap(4),
    # 8 blocks (64 warps) an SM: the compiler held to 32 registers a thread
    "occ8": [("__launch_bounds__(NT)", "__launch_bounds__(NT, 8)")],
    # the reps in a loop unrolled 8 times: an eighth of the code
    "unroll8": [("#pragma unroll\n    for (int rep",
                 "#pragma unroll 8\n    for (int rep")],
}


def variant_source(text: str, name: str) -> str:
    for old, new in VARIANTS[name]:
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def geometry(text: str) -> dict:
    """R and COLS of a source, and what follows from them."""
    r, cols = (int(re.search(rf"constexpr int {n} = (\d+);", text).group(1))
               for n in ("R", "COLS"))
    nt = vpu_probe.QT // r * cols
    return {"R": r, "COLS": cols, "block_threads": nt,
            "threads_per_program": vpu_probe.LANES // cols * nt}


def _ptxas(log: str) -> dict:
    """{mode: [registers, spill bytes stored + loaded]} from -Xptxas -v."""
    out, mode = {}, None
    for ln in log.splitlines():
        m = re.search(r"int_probe_kernelILi(\d)E", ln)
        if m and "Compiling entry" in ln:
            mode = vpu_probe.MODES[int(m.group(1))]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and mode:
            out.setdefault(mode, [0, 0])[1] = int(m.group(1)) + int(
                m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and mode:
            out.setdefault(mode, [0, 0])[0] = int(m.group(1))
    return out


def _build(name, text, tmp):
    src = os.path.join(tmp, f"{name}.cu")
    lib = os.path.join(tmp, f"lib{name}.so")
    with open(src, "w") as f:
        f.write(text)
    log = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                          "-o", lib, src], capture_output=True, text=True)
    if log.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{log.stderr}")
    return lib, _ptxas(log.stderr)


def compare(sources: dict, programs=8192, rounds=2, samples=3, launches=32,
            seed=0, device="cuda") -> dict:
    """``sources``: {name: .cu text}.  Builds, checks and times each (see
    the module's text); returns {name: {"geometry", "ptxas", mode: {"ms":
    [per round], "clock": [median MHz per round], "blocks", "sass_loop",
    "sass_all"}}}."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 1 << 20, (vpu_probe.QT,
                                                   vpu_probe.LANES))
                         .astype(np.int32)).to(dev)
    plain = {m: vpu_probe.probe_plain(x, m) for m in vpu_probe.MODES}
    out = torch.empty_like(x)
    stream = gact_cuda.stream_ptr(dev)
    res = {}
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(min(8, len(sources))) as pool:
        built = dict(zip(sources, pool.map(
            lambda kv: _build(kv[0], kv[1], tmp), sources.items())))
        libs = {}
        for name, (path, ptxas) in built.items():
            lib = ctypes.CDLL(path)
            lib.int_probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
            libs[name] = lib
            sass = vpu_probe.sass_counts(path)
            res[name] = {"geometry": geometry(sources[name]),
                         "ptxas": ptxas}
            for fn, info in sass.items():
                m = re.search(r"int_probe_kernelILi(\d)E", fn)
                if m:
                    res[name][vpu_probe.MODES[int(m.group(1))]] = {
                        "ms": [], "clock": [], "sass_loop": info["loop"],
                        "sass_all": info["all"],
                        "blocks": _blocks(lib, int(m.group(1)), programs,
                                          res[name]["geometry"])}

        def launch(name, mode, n):
            err = libs[name].int_probe(
                gact_cuda.ptr(x), gact_cuda.ptr(out),
                vpu_probe.MODES.index(mode), n, stream)
            if err != 0:
                raise RuntimeError(f"{name} mode {mode}: CUDA error {err}")

        for name in sources:
            for mode in vpu_probe.MODES:
                for n in (1, 3, programs):
                    launch(name, mode, n)
                    torch.cuda.synchronize(dev)
                    if not torch.equal(out, plain[mode]):
                        raise AssertionError(f"{name} mode {mode} programs "
                                             f"{n} != probe_plain")
        order = list(sources)
        for r in range(rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                for mode in vpu_probe.MODES:
                    ms, readings = vpu_probe.time_windows(
                        lambda: launch(name, mode, programs), samples,
                        launches, dev)
                    clock = vpu_probe.spread(rd[0] for rd in readings)
                    res[name][mode]["ms"].append(min(ms))
                    res[name][mode]["clock"].append(
                        clock and clock["median"])
    return res


def _blocks(lib, mode, programs, geo):
    """The blocks of a launch: int_probe_grid where the source has it,
    else one per column slice and program (a grid of programs x slices)."""
    try:
        fn = lib.int_probe_grid
    except AttributeError:
        return programs * vpu_probe.LANES // geo["COLS"]
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return fn(mode, programs)


def thread_instructions(entry: dict, geo: dict, programs: int,
                        looped: bool) -> int:
    """Thread-instructions of one launch: the program loop's span once per
    program and slice, the rest once per thread of the grid — or, for a
    kernel without a program loop, everything once per thread."""
    every = sum(entry["sass_all"].values())
    if not looped:
        return every * programs * geo["threads_per_program"]
    loop = sum(entry["sass_loop"].values())
    return (loop * programs * geo["threads_per_program"]
            + (every - loop) * entry["blocks"] * geo["block_threads"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another int_probe.cu to time beside")
    ap.add_argument("--variants", default="",
                    help="comma list of VARIANTS names")
    ap.add_argument("--programs", type=int, default=8192)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--samples", type=int, default=3)
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_variants: no CUDA device", file=sys.stderr)
        return 2
    with open(os.path.join(build.CSRC, "int_probe.cu")) as f:
        text = f.read()
    sources = {}
    if args.parent:
        with open(args.parent) as f:
            sources["parent"] = f.read()
    sources["change"] = text
    for name in filter(None, args.variants.split(",")):
        sources[name] = variant_source(text, name)
    res = compare(sources, args.programs, args.rounds, args.samples)
    bounds = vpu_probe.mode_bounds(args.programs)
    smi = vpu_probe.power_limit()
    for name, r in res.items():
        looped = "int_probe_grid" in sources[name]
        for mode in vpu_probe.MODES:
            e = r[mode]
            best = min(e["ms"])
            clock = float(np.median([c for c in e["clock"] if c] or [0]))
            n = thread_instructions(e, r["geometry"], args.programs, looped)
            b = bounds[mode]["bound_ms"]
            e.update(best_ms=best, share=b / best, clock_mhz=clock,
                     share_at_clock=(b * vpu_probe.CLOCK_HZ / 1e6 / clock / best
                                     if clock else None),
                     thread_instructions=n,
                     per_sm_clock=n / (best * 1e-3) / (vpu_probe.SMS
                                                       * clock * 1e6)
                     if clock else None,
                     loop_per_element=sum(e["sass_loop"].values())
                     / r["geometry"]["R"] if looped else None)
            print(f"{name:8s} {mode:5s} ms " + " ".join(
                f"{m:.4f}" for m in e["ms"]) + f"  share {e['share']:.3f}"
                f" (at {clock:.0f} MHz: "
                f"{e['share_at_clock'] or 0:.3f})  thread-instructions per "
                f"SM per clock {e['per_sm_clock'] or 0:.1f}  blocks "
                f"{e['blocks']}  registers / spill bytes "
                f"{r['ptxas'].get(mode)}  loop per element "
                f"{e['loop_per_element']}  [{smi}]", flush=True)
    doc = {"device": torch.cuda.get_device_name(0), "power_limit": smi,
           "programs": args.programs, "rounds": args.rounds,
           "order": list(sources), "results": res}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f)
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
