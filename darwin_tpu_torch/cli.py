"""CLI of the port, matching the reference binary's interface
(software/main.cpp:168-171):

    python -m darwin_tpu_torch.cli <REFERENCE>.fasta <READS>.fasta 0 \
        [--device=cuda|cpu]

Reads ``params.cfg`` from the current directory when present (the
reference's INI schema); SAM on stdout, progress and counters on stderr.
The device defaults to ``cuda`` and the run fails without one; ``cpu``
runs the kernels' plain twins and is meant for tests.  Overlap mode
(``1``) is not ported yet.
"""

from __future__ import annotations

import os
import sys

from darwin_tpu.config import Config, load_config
from darwin_tpu_torch.pipeline.align import run

USAGE = ("Usage: python -m darwin_tpu_torch.cli <REFERENCE>.fasta "
         "<READS>.fasta OVERLAP(0) [--device=cuda|cpu]")


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
    if overlap:
        print("overlap mode (1) is not ported to darwin_tpu_torch yet; use "
              "python -m darwin_tpu.cli", file=sys.stderr)
        return 2
    if os.path.exists("params.cfg"):
        print("Reading configuration ...", file=sys.stderr)
        cfg = load_config("params.cfg", do_overlap=False)
    else:
        cfg = Config()
    run(ref_path, reads_path, False, cfg=cfg, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
