"""One run of one benchmark cell: set-up, the measured window through
``darwin_tpu_torch.pipeline.align.run``, the check of what it printed
against the plain reference, and the per-layer readings of a traced run.

Everything a cell needs is found by name: ``BENCHMARK.json``'s workload
names its configuration (``configs/<config>.json``) and the cell's own
traffic file (``cells/<workload>.json``); each metric is read by
``metrics/<metric>.py``'s ``read(ctx)``, which returns None where it finds
nothing to read.
"""

from __future__ import annotations

import gc
import importlib.util
import inspect
import json
import os
import sys
import time

import numpy as np

from benchmark import profiling
from benchmark.gen import genomes, reads as greads

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "darwin_tpu")
# times the pool is written into the query stream: a program fast enough
# to drain it aligns it again from its first read
PASSES = 2


class Deadline(Exception):
    """Raised into ``run()`` by the output sink once the window closed."""


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_cell(spec: dict, workload: str, base: str = HERE):
    """(workload entry, traffic, configuration) of ``workload``."""
    wl = {w["name"]: w for w in spec["workloads"]}.get(workload)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    with open(os.path.join(base, "cells", f"{workload}.json")) as f:
        traffic = json.load(f)
    with open(os.path.join(base, "configs", f"{wl['config']}.json")) as f:
        config = json.load(f)
    return wl, traffic, config


def cell_metrics(spec: dict, workload: str, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end ones, or with
    ``trace`` its per-layer ones."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in spec[key]
            if workload in m.get("workloads", [workload])]


def reader(name: str, base: str = HERE):
    """``read`` of ``metrics/<name>.py``."""
    path = os.path.join(base, "metrics", f"{name}.py")
    s = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


class Sink:
    """``run()``'s ``out``: keeps each batch's lines in memory with the
    time they were written.  The first ``warm`` batches are the warm-up
    (at ``run()``'s depth they are in flight together); their last one's
    lines open the window, and the first batch written after ``seconds``
    more raises Deadline, which ends ``run()``."""

    def __init__(self, seconds, warm: int, marker=None):
        self.seconds = seconds
        self.warm = warm
        self.marker = marker
        self.batches = []            # (monotonic time, lines)
        self.deadline = None

    def write(self, text):          # the SAM header
        pass

    def writelines(self, lines):
        t = time.monotonic()
        if self.marker is not None:
            self.marker()
        if self.deadline is not None and t > self.deadline:
            raise Deadline()
        self.batches.append((t, list(lines)))
        if len(self.batches) == self.warm and self.seconds:
            self.deadline = t + self.seconds


def memfile(data: bytes) -> tuple[int, str]:
    """An in-memory file holding ``data`` and a path that opens it."""
    fd = os.memfd_create("bench", 0)
    view = memoryview(data)
    while view:
        view = view[os.write(fd, view):]
    return fd, f"/proc/self/fd/{fd}"


def make_inputs(config: dict, traffic: dict, seed: int, n_reads: int):
    """(genome chromosomes, read set or None, the query stream's reads)."""
    chroms, _ = genomes.make_genome(config["genome"])
    profile = config["reads"]
    if traffic["mode"] == "overlap":
        rset = greads.make_pool(chroms, profile, traffic["read_set"], seed)
        return rset, rset[:n_reads]
    return chroms, greads.make_pool(chroms, profile, n_reads, seed)


def records_by_read(batches, names, overlap: bool) -> dict:
    """{read name: its records in printed order} over ``batches``' lines,
    for the reads ``names``, each from the first batch that printed it (a
    pool the window drained is aligned again)."""
    out = {n: [] for n in names}
    first = {}
    step = 6 if overlap else 1
    for k, (_, lines) in enumerate(batches):
        for i in range(0, len(lines), step):
            fields = lines[i].split(" " if overlap else "\t")
            name = fields[1] if overlap else fields[0]
            if name in out and first.setdefault(name, k) == k:
                out[name].extend(lines[i:i + step])
    return out


def pick_sample(rng, done: list, k: int) -> list:
    """``k`` of the distinct reads ``done`` ([(name, seq)]), drawn by
    ``rng``: the longest first (the first of them in ``done``), then the
    rest at random."""
    uniq = list({n: (n, s) for n, s in done}.values())
    lens = [len(s) for _, s in uniq]
    longest = lens.index(max(lens))
    rest = [i for i in range(len(uniq)) if i != longest]
    rng.shuffle(rest)
    return [uniq[i] for i in [longest] + rest[:k - 1]]


def window_reads(stream: list, n_batches: int, per_batch: int,
                 warm: int) -> list:
    """The reads of the batches after the ``warm`` ones, of the first
    ``n_batches`` that ``run()`` read from ``stream`` (written PASSES
    times over)."""
    ids = np.arange(warm * per_batch, n_batches * per_batch) % len(stream)
    return [stream[i] for i in ids]


def run_shape(run_kwargs=None) -> tuple[int, int]:
    """(reads a batch, batches in flight) of ``run()`` at its defaults,
    or as ``run_kwargs`` sets them: the warm-up is that many batches."""
    from darwin_tpu_torch.pipeline import align
    defaults = inspect.signature(align.run).parameters
    return tuple((run_kwargs or {}).get(k, defaults[k].default)
                 for k in ("reads_per_batch", "pipeline_depth"))


def host_state() -> dict:
    """What of the host can move a host-bound rate: the cores this
    process may run on and torch's threads."""
    import torch
    return {"cores": len(os.sched_getaffinity(0)),
            "torch_threads": torch.get_num_threads()}


def check_records(program: dict, reference: dict) -> dict:
    """Per sampled read: the program's records against the reference's,
    compared whole.  Returns counts and the first differences."""
    differ = [n for n in reference if program.get(n) != reference[n]]
    first = []
    for n in differ[:3]:
        p, r = program.get(n) or [], reference[n]
        first.append({"read": n, "program_records": len(p),
                      "reference_records": len(r),
                      "first_diff": next(
                          ([a[:160], b[:160]] for a, b in zip(p, r)
                           if a != b), None)})
    return {"compared": len(reference), "differ": len(differ),
            "examples": first}


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(spec, workload, seed, seconds, trace, device="cuda",
             t_start=None, base=HERE, cell=None, run_kwargs=None):
    """One run of ``workload``.  Returns the result object that ``run.py``
    prints.  ``cell`` (workload entry, traffic, configuration) and
    ``run_kwargs`` (more arguments of ``run()``, such as a smaller batch)
    are for tests at sizes the CPU can run."""
    import torch
    from darwin_tpu_torch.pipeline import align
    from benchmark.reference.darwin import Reference

    t_start = time.monotonic() if t_start is None else t_start
    wl, traffic, config = cell or load_cell(spec, workload, base)
    seed = int(seed) % (1 << 63)
    overlap = traffic["mode"] == "overlap"
    n_stream = traffic["trace_reads"] if trace else traffic["pool_reads"]
    t_gen = time.monotonic()
    genome, stream = make_inputs(config, traffic, seed, n_stream)
    t_fasta = time.monotonic()
    ref_fd, ref_path = memfile(greads.fasta_bytes(genome))
    passes = 1 if trace else PASSES
    q_fd, q_path = memfile(greads.fasta_bytes(stream) * passes)
    t_run = time.monotonic()
    run_kwargs = run_kwargs or {}
    per_batch, warm = run_shape(run_kwargs)
    prof = marker = None
    if trace:
        prof = profiling.start()
        marker = profiling.marker
    sink = Sink(0 if trace else seconds, warm, marker)
    stats = {}
    host = host_state()
    cpu0 = os.times()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        align.run(ref_path, q_path, overlap, out=sink, err=_Null(),
                  device=device, stats_out=stats, **run_kwargs)
    except Deadline:
        pass
    finally:
        os.close(ref_fd)
        os.close(q_fd)
    if prof is not None:
        prof.stop()
    cpu1 = os.times()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = int(torch.cuda.max_memory_allocated(dev))
        kind = torch.cuda.get_device_name(dev)
    else:
        peak, kind = 0, "cpu"
    if len(sink.batches) <= warm:
        raise RuntimeError("the window completed no batch: lengthen "
                           "--seconds or the pool")
    t0 = sink.batches[warm - 1][0]
    setup_s = t0 - t_start
    # the window: the batches completed after the warm ones, to the last
    n_done = len(sink.batches)
    window = window_reads(stream, n_done, per_batch, warm)
    ctx = {"setup_s": setup_s,
           "window_s": sink.batches[-1][0] - t0,
           "reads_done": len(window),
           "passes": (n_done * per_batch) / len(stream),
           "stats": stats, "first_reads": per_batch}
    if prof is not None:
        ctx.update(profiling.reduce(prof, ctx, stats))
    del prof
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check: a sample of the reads the window completed, drawn from
    # the seed
    sample = pick_sample(np.random.default_rng(seed + 1), window,
                         traffic["sample_reads"])
    t_ref = time.monotonic()
    ref = Reference(genome, overlap, device)
    expect = ref.align(sample)
    del ref
    got = records_by_read(sink.batches, [n for n, _ in sample], overlap)
    chk = check_records(got, expect)
    chk["reference_s"] = time.monotonic() - t_ref

    metrics = {}
    for m in cell_metrics(spec, workload, trace):
        v = reader(m["name"], base)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    res = {"correct": chk["differ"] == 0,
           "attempted": len(window), "failed": chk["differ"],
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": kind, "count": 1,
                      "memory_peak_bytes": peak}}
    if trace and "busy_s" in ctx:
        res["device"]["busy_s"] = ctx["busy_s"]
        res["device"]["window_s"] = ctx["trace_window_s"]
        res["breakdown"] = ctx["breakdown"]
    res["run"] = {"seed": seed, "setup_s": setup_s,
                  "setup_parts_s": {
                      "before_generation": t_gen - t_start,
                      "generation": t_fasta - t_gen,
                      "fasta": t_run - t_fasta,
                      "run_to_window": t0 - t_run,
                      "index": stats.get("index_seconds")},
                  "window_s": ctx["window_s"], "reads_done": len(window),
                  "passes": ctx["passes"],
                  "host": dict(host, cpu_s=(cpu1.user + cpu1.system
                                            - cpu0.user - cpu0.system),
                               wall_s=cpu1.elapsed - cpu0.elapsed),
                  "reads_compared": chk["compared"],
                  "reference_s": chk["reference_s"],
                  "examples": chk["examples"]}
    res["checks"] = {"reads_differ": {"value": chk["differ"], "limit": 0}}
    return res


class _Null:
    def write(self, text):
        pass

    def flush(self):
        pass
