"""CLI of the port, matching the reference binary's interface
(software/main.cpp:168-171):

    python -m darwin_tpu_torch.cli <REFERENCE>.fasta <READS>.fasta <0|1> \
        [--device=cuda|cpu] [--index-cache=FILE.npz]
        [--index-layout=pairs|csr] [--mesh=auto|off|N] [--shard-index]
        [--profile=DIR]

``0`` is reference-guided mode (SAM on stdout), ``1`` overlap mode (both
files are reads, usually the same file; MHAP on stdout).  Reads
``params.cfg`` from the current directory when present (the reference's INI
schema); progress and counters go to stderr.  The device defaults to
``cuda`` and the run fails without one; ``cpu`` runs the kernels' plain
twins and is meant for tests.  ``--index-cache`` loads the seed table from
FILE when it matches the reference and the config, else builds it and
writes it there; ``--index-layout`` builds that seed-table layout (a
cache of the other layout is then rebuilt; without it pairs is built and
a cache of either is taken); ``--mesh`` splits the tile batches over N
devices (``auto``, the default: every local card, rounded down to a power
of two, when there is more than one; ``off``: one device; on the CPU, N
entries of it), and ``--shard-index`` shards the pairs table over them too;
``--profile`` writes a torch.profiler trace of the run to DIR/trace.json
(darwin_tpu/cli.py's flags of the same names).
"""

from __future__ import annotations

import os
import sys

from darwin_tpu_torch.config import Config, load_config
from darwin_tpu_torch.pipeline.align import run

USAGE = ("Usage: python -m darwin_tpu_torch.cli <REFERENCE>.fasta "
         "<READS>.fasta OVERLAP(0/1) [--device=cuda|cpu] "
         "[--index-cache=FILE.npz] [--index-layout=pairs|csr] "
         "[--mesh=auto|off|N] [--shard-index] [--profile=DIR]")


def read_config(overlap: bool) -> Config:
    """``params.cfg`` in the working directory when there is one, else the
    defaults."""
    if os.path.exists("params.cfg"):
        print("Reading configuration ...", file=sys.stderr)
        return load_config("params.cfg", do_overlap=overlap)
    return Config()


def main(argv=None, **run_kwargs):
    """The command line in ``argv`` (sys.argv's by default); a caller in
    Python may add keyword arguments of ``run`` (``stats_out``,
    ``spec_k``, ``pipeline_depth``)."""
    argv = sys.argv[1:] if argv is None else argv
    device = "cuda"
    index_cache = None
    layout = None
    profile_dir = None
    mesh = "auto"
    shard_index = False
    rest = []
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith("--mesh="):
            mesh = a.split("=", 1)[1]
            if mesh not in ("auto", "off") and not mesh.isdigit():
                print(f"unknown mesh {mesh!r}\n{USAGE}", file=sys.stderr)
                return 1
        elif a == "--shard-index":
            shard_index = True
        elif a.startswith("--index-cache="):
            index_cache = a.split("=", 1)[1]
        elif a.startswith("--index-layout="):
            layout = a.split("=", 1)[1]
            if layout not in ("pairs", "csr"):
                print(f"unknown index layout {layout!r}\n{USAGE}",
                      file=sys.stderr)
                return 1
        elif a.startswith("--profile="):
            profile_dir = a.split("=", 1)[1]
        elif a.startswith("--"):
            print(f"unknown option {a}\n{USAGE}", file=sys.stderr)
            return 1
        else:
            rest.append(a)
    if len(rest) != 3 or rest[2] not in ("0", "1"):
        print(USAGE, file=sys.stderr)
        return 1
    ref_path, reads_path, overlap = rest[0], rest[1], rest[2] == "1"
    kw = dict(cfg=read_config(overlap), device=device,
              index_cache=index_cache, index_layout=layout,
              mesh=mesh if mesh in ("auto", "off") else int(mesh),
              shard_index=shard_index, **run_kwargs)
    if not profile_dir:
        run(ref_path, reads_path, overlap, **kw)
        return 0
    with _profile(profile_dir, device) as prof:
        run(ref_path, reads_path, overlap, **kw)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    return 0


def _profile(profile_dir, device):
    """torch.profiler over the run: host activity, and the card's where
    the run is on one (darwin_tpu's jax.profiler.trace counterpart)."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if str(device).startswith("cuda"):
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


if __name__ == "__main__":
    sys.exit(main())
