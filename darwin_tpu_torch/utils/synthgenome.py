"""Repeat-structured synthetic genome generator: the port's own copy of
``darwin_tpu/utils/synthgenome.py`` (``diverge``, ``_random_bases``,
``repeat_genome``; numpy only, the same generator state gives the same
bases in both packages).

A uniform random genome leaves out what real references have most of:
repeat structure, which skews seed-bucket occupancy (the
``kmer_max_occurence`` cap of software/seed_pos_table.cpp:55,314) and
plants decoy anchors for the filter and chaining.  This genome carries the
main repeat classes of a mammalian chromosome at roughly chr21-like
fractions:

* interspersed SINEs  (~300 bp consensus, tens of thousands of copies,
  5-25 % diverged — the Alu analog, the occupancy-cap workload)
* interspersed LINEs  (~6 kb consensus, 5'-truncated copies like real L1s)
* tandem satellite arrays (motif periods 2-171 bp, arrays up to tens of kb)
* segmental duplications (10-100 kb blocks re-inserted at ~2 % divergence)
* unique background (random ACGT)

All sizes/fractions are parameters; the defaults give ~45 % repeat content
(GRCh38 chr21 is ~46 % RepeatMasker-annotated).
"""

from __future__ import annotations

import numpy as np

_ACGT = np.frombuffer(b"ACGT", np.uint8)


def diverge(rng, seq: np.ndarray, div: float) -> np.ndarray:
    """A copy of ``seq`` with ~div point divergence (80 % substitutions,
    10 % insertions, 10 % deletions — roughly neutral-drift indel rates)."""
    sub_p, ind_p = 0.8 * div, 0.1 * div
    r = rng.random(len(seq))
    keep = r >= ind_p
    out = seq[keep].copy()
    subs = rng.random(len(out)) < sub_p
    if subs.any():
        out[subs] = _ACGT[(np.searchsorted(_ACGT, out[subs])
                           + rng.integers(1, 4, int(subs.sum()))) % 4]
    ins = np.flatnonzero(rng.random(len(out)) < ind_p)
    if ins.size:
        out = np.insert(out, ins + 1, _ACGT[rng.integers(0, 4, ins.size)])
    return out


def _random_bases(rng, n: int) -> np.ndarray:
    return _ACGT[rng.integers(0, 4, size=n, dtype=np.uint8)]


def repeat_genome(rng, n_bases: int, *,
                  sine_frac: float = 0.11, line_frac: float = 0.17,
                  tandem_frac: float = 0.10, segdup_frac: float = 0.02,
                  n_sine_families: int = 3, n_line_families: int = 2
                  ) -> tuple[np.ndarray, dict]:
    """Assemble an ``n_bases`` repeat-structured chromosome.

    Returns (bases uint8, stats dict with realized per-class bp)."""
    sine_cons = [_random_bases(rng, int(rng.integers(250, 350)))
                 for _ in range(n_sine_families)]
    line_cons = [_random_bases(rng, int(rng.integers(5000, 7000)))
                 for _ in range(n_line_families)]

    target = {"sine": int(n_bases * sine_frac),
              "line": int(n_bases * line_frac),
              "tandem": int(n_bases * tandem_frac)}
    placed = {k: 0 for k in target} | {"unique": 0, "segdup": 0}
    segs = []
    total = 0
    n_body = int(n_bases * (1.0 - segdup_frac))
    uniq_target = n_body - sum(target.values())
    while total < n_body:
        room = n_body - total
        # pick the class by remaining bp deficit so realized fractions
        # converge to the targets (SINE copies are ~100x shorter than
        # unique segments; uniform picks would starve them)
        deficits = {k: target[k] - placed[k] for k in target}
        deficits["unique"] = uniq_target - placed["unique"]
        kinds = [k for k, v in deficits.items() if v > 0] or ["unique"]
        wts = np.array([max(deficits.get(k, 1), 1) for k in kinds], float)
        kind = str(rng.choice(kinds, p=wts / wts.sum()))
        if kind == "sine":
            cons = sine_cons[int(rng.integers(len(sine_cons)))]
            seg = diverge(rng, cons, float(rng.uniform(0.05, 0.25)))
        elif kind == "line":
            cons = line_cons[int(rng.integers(len(line_cons)))]
            # most genomic L1 copies are 5'-truncated
            cut = int(rng.integers(0, int(0.8 * len(cons))))
            seg = diverge(rng, cons[cut:],
                          float(rng.uniform(0.05, 0.25)))
        elif kind == "tandem":
            period = int(rng.choice([2, 3, 4, 5, 6, 17, 42, 171]))
            motif = _random_bases(rng, period)
            reps = int(rng.integers(50, max(51, 20000 // period)))
            arr = np.tile(motif, reps)
            seg = diverge(rng, arr, 0.02)   # slight array heterogeneity
        else:
            seg = _random_bases(rng, int(rng.integers(2000, 50000)))
        seg = seg[:room]
        segs.append(seg)
        placed[kind] += len(seg)
        total += len(seg)

    genome = np.concatenate(segs)
    # segmental duplications: re-insert large diverged blocks
    while len(genome) < n_bases:
        room = n_bases - len(genome)
        blk = int(min(room, rng.integers(10_000, 100_000)))
        src = int(rng.integers(0, max(len(genome) - blk, 1)))
        dup = diverge(rng, genome[src:src + blk], 0.02)[:room]
        at = int(rng.integers(0, len(genome)))
        genome = np.concatenate([genome[:at], dup, genome[at:]])
        placed["segdup"] += len(dup)
    stats = {k: int(v) for k, v in placed.items()}
    stats["repeat_frac"] = round(
        1.0 - placed["unique"] / max(len(genome), 1), 3)
    return genome[:n_bases], stats
