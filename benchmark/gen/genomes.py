"""Reference genomes for the benchmark, drawn from a numpy generator.

Frozen copies, so that a change to the program's own generators cannot move
the yardstick:

* ``uniform_bases`` is ``darwin_tpu_torch/utils/synth.py``'s ``uniform_bases``;
* ``diverge``, ``random_bases`` and ``repeat_genome`` are
  ``darwin_tpu_torch/utils/synthgenome.py``'s ``diverge``, ``_random_bases``
  and ``repeat_genome`` (itself a copy of ``darwin_tpu/utils/synthgenome.py``);
* ``gap_layout`` is ``darwin_tpu_torch/utils/synth.py``'s ``gap_layout``
  (GRCh38's gap classes: telomeres, the acrocentric short arms, scaffold
  gaps), with its constants as arguments.

``make_genome`` turns a configuration's ``genome`` entry into
``[(name, bases)]``, bases as ASCII uint8.
"""

from __future__ import annotations

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)


def uniform_bases(rng, n: int) -> np.ndarray:
    """``n`` uniform random ACGT bytes, four from each random byte."""
    quad = np.ascontiguousarray(
        ACGT[(np.arange(256)[:, None] >> np.arange(0, 8, 2)) & 3])
    r = rng.integers(0, 256, (n + 3) // 4, dtype=np.uint8)
    return quad.view(np.uint32).ravel()[r].view(np.uint8)[:n]


def random_bases(rng, n: int) -> np.ndarray:
    return ACGT[rng.integers(0, 4, size=n, dtype=np.uint8)]


def diverge(rng, seq: np.ndarray, div: float) -> np.ndarray:
    """A copy of ``seq`` with ~div point divergence (80 % substitutions,
    10 % insertions, 10 % deletions)."""
    sub_p, ind_p = 0.8 * div, 0.1 * div
    r = rng.random(len(seq))
    keep = r >= ind_p
    out = seq[keep].copy()
    subs = rng.random(len(out)) < sub_p
    if subs.any():
        out[subs] = ACGT[(np.searchsorted(ACGT, out[subs])
                          + rng.integers(1, 4, int(subs.sum()))) % 4]
    ins = np.flatnonzero(rng.random(len(out)) < ind_p)
    if ins.size:
        out = np.insert(out, ins + 1, ACGT[rng.integers(0, 4, ins.size)])
    return out


def repeat_genome(rng, n_bases: int, *,
                  sine_frac: float = 0.11, line_frac: float = 0.17,
                  tandem_frac: float = 0.10, segdup_frac: float = 0.02,
                  n_sine_families: int = 3, n_line_families: int = 2
                  ) -> tuple[np.ndarray, dict]:
    """An ``n_bases`` repeat-structured chromosome: SINEs (~300 bp
    consensus, 5-25 % diverged), 5'-truncated LINEs (~6 kb consensus),
    tandem arrays (periods 2-171 bp), segmental duplications (10-100 kb at
    2 %) and unique random background.  Returns (bases, realized bp per
    class and ``repeat_frac``)."""
    sine_cons = [random_bases(rng, int(rng.integers(250, 350)))
                 for _ in range(n_sine_families)]
    line_cons = [random_bases(rng, int(rng.integers(5000, 7000)))
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
        # converge to the targets
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
            cut = int(rng.integers(0, int(0.8 * len(cons))))
            seg = diverge(rng, cons[cut:], float(rng.uniform(0.05, 0.25)))
        elif kind == "tandem":
            period = int(rng.choice([2, 3, 4, 5, 6, 17, 42, 171]))
            motif = random_bases(rng, period)
            reps = int(rng.integers(50, max(51, 20000 // period)))
            seg = diverge(rng, np.tile(motif, reps), 0.02)
        else:
            seg = random_bases(rng, int(rng.integers(2000, 50000)))
        seg = seg[:room]
        segs.append(seg)
        placed[kind] += len(seg)
        total += len(seg)

    genome = np.concatenate(segs)
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


def gap_layout(chroms, gaps: dict) -> list:
    """N blocks over ``chroms`` = [(name, length)]: a ``telomere`` at both
    ends of each, the ``short_arms`` {name: end} (the first telomere
    included) and a ``scaffold_len`` run every ``scaffold_every`` bp
    outside those.  Returns [(chrom, start0, length, class)] sorted by
    chromosome (in ``chroms``' order) and start, disjoint."""
    tel = gaps["telomere"]
    every, slen = gaps["scaffold_every"], gaps["scaffold_len"]
    out = []
    for name, n in chroms:
        big = [(0, tel, "telomere"), (n - tel, tel, "telomere")]
        if name in gaps["short_arms"]:
            big.append((tel, gaps["short_arms"][name] - tel, "short_arm"))
        scaffold = [(p, slen, "scaffold") for p in range(every, n, every)
                    if all(p + slen <= s or p >= s + ln
                           for s, ln, _ in big)]
        out += [(name, s, ln, cls) for s, ln, cls in sorted(big + scaffold)]
    return out


def make_genome(spec: dict) -> tuple[list, dict]:
    """A configuration's ``genome`` entry -> ([(name, bases)], stats).
    ``kind`` "uniform": each of ``chromosomes`` ([name, length]) of
    uniform random bases; "repeat": one ``repeat_genome`` chromosome at
    the ``repeat_fracs`` given.  With ``gaps``, N is written over
    ``gap_layout``'s blocks.  Drawn from ``spec["seed"]``: a deployment
    aligns against one fixed reference."""
    rng = np.random.default_rng(spec["seed"])
    if spec["kind"] == "uniform":
        chroms = [(name, uniform_bases(rng, n))
                  for name, n in spec["chromosomes"]]
        stats = {"repeat_frac": 0.0}
    elif spec["kind"] == "repeat":
        (name, n), = spec["chromosomes"]
        bases, stats = repeat_genome(rng, n, **spec["repeat_fracs"])
        chroms = [(name, bases)]
    else:
        raise ValueError(f"unknown genome kind {spec['kind']!r}")
    stats["n_bases"] = 0
    if "gaps" in spec:
        by_name = dict(chroms)
        for c, s, ln, _ in gap_layout(spec["chromosomes"], spec["gaps"]):
            by_name[c][s:s + ln] = ord("N")
            stats["n_bases"] += ln
    return chroms, stats
