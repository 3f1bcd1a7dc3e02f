"""CLI of the port, matching the reference binary's interface
(software/main.cpp:168-171):

    python -m darwin_tpu_torch.cli <REFERENCE>.fasta <READS>.fasta <0|1> \
        [--device=cuda|cpu]

``0`` is reference-guided mode (SAM on stdout), ``1`` overlap mode (both
files are reads, usually the same file; MHAP on stdout).  Reads
``params.cfg`` from the current directory when present (the reference's INI
schema); progress and counters go to stderr.  The device defaults to
``cuda`` and the run fails without one; ``cpu`` runs the kernels' plain
twins and is meant for tests.
"""

from __future__ import annotations

import os
import sys

from darwin_tpu_torch.config import Config, load_config
from darwin_tpu_torch.pipeline.align import run

USAGE = ("Usage: python -m darwin_tpu_torch.cli <REFERENCE>.fasta "
         "<READS>.fasta OVERLAP(0/1) [--device=cuda|cpu]")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = "cuda"
    rest = []
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith("--"):
            print(f"unknown option {a}\n{USAGE}", file=sys.stderr)
            return 1
        else:
            rest.append(a)
    if len(rest) != 3 or rest[2] not in ("0", "1"):
        print(USAGE, file=sys.stderr)
        return 1
    ref_path, reads_path, overlap = rest[0], rest[1], rest[2] == "1"
    if os.path.exists("params.cfg"):
        print("Reading configuration ...", file=sys.stderr)
        cfg = load_config("params.cfg", do_overlap=overlap)
    else:
        cfg = Config()
    run(ref_path, reads_path, overlap, cfg=cfg, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
