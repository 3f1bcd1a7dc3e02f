"""The control of the benchmark's check: the plain reference put in the
program's place with its tile DP saturated to 8-bit lanes, compared with
the exact reference on a cell's own inputs, as a run compares the
program's records.  It has to come out as not correct.

    python3 benchmark/control.py --workload <name> --seeds 11 12 13 \
        [--bits 8] [--device cuda]

Prints one JSON line per seed: the reads compared and the reads whose
records differ (``reads_differ``; a run is correct at 0).  int16 lanes
would hold every value this DP reaches (|score| < 4,000 in a 1984 x 960
tile), so they cannot differ; 8 bits is the nearest precision below the
exact one that can.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:1] = [ROOT]


def control(spec, workload, seed, bits=8, device="cuda", cell=None):
    """(compared, differ) of the ``bits`` reference against the exact one
    on ``workload``'s inputs at ``seed``: the cell's ``sample_reads``
    reads of its pool after the warm batches, drawn as a run draws its
    sample."""
    import numpy as np
    from benchmark import harness
    from benchmark.reference.darwin import Reference

    _, traffic, config = cell or harness.load_cell(spec, workload)
    seed = int(seed) % (1 << 63)
    overlap = traffic["mode"] == "overlap"
    genome, stream = harness.make_inputs(config, traffic, seed,
                                         traffic["pool_reads"])
    per_batch, warm = harness.run_shape()
    sample = harness.pick_sample(np.random.default_rng(seed + 1),
                                 stream[warm * per_batch:],
                                 traffic["sample_reads"])
    exact = Reference(genome, overlap, device).align(sample)
    low = Reference(genome, overlap, device, bits=bits).align(sample)
    chk = harness.check_records(low, exact)
    return chk["compared"], chk["differ"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from benchmark import harness
    spec = harness.load_spec(ROOT)
    for seed in args.seeds:
        t = time.monotonic()
        n, d = control(spec, args.workload, seed, args.bits, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "bits": args.bits, "reads_compared": n,
                          "reads_differ": d,
                          "seconds": time.monotonic() - t}), flush=True)


if __name__ == "__main__":
    main()
