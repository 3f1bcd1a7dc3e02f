"""Read pools for the benchmark, drawn from ``--seed``.

Frozen, vectorized counterparts of ``darwin_tpu_torch/utils/simulate.py``
(``mutate_read``, ``simulate_reads``): the same error model (deletions,
then substitutions, then one random base inserted after a position), drawn
in bulk over many reads at once, with insertions placed by ``np.insert`` as
``diverge`` does, instead of one read and one inserted base at a time.

A pool is a list of (name, ASCII uint8 sequence).  Where each read comes
from (chromosome and start, in the genome's N-free sequence) is drawn from
the read profile's fixed ``loci_seed``; ``--seed`` draws the strands and
the sequencing errors.  So every seed gives the same set of reads to
align, each with other errors: on a repeat genome the work of a read
depends mostly on its locus, and a window holds only a few batches.
"""

from __future__ import annotations

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTNacgtn", b"TGCANtgcan"):
    _COMP[_a] = _b
_CHUNK = 1024          # reads mutated per bulk draw


def revcomp(seq: np.ndarray) -> np.ndarray:
    return _COMP[seq[::-1]]


def mutate_many(rng, seqs: list, error) -> list:
    """Each of ``seqs`` with substitutions, insertions and deletions at
    the rates ``error`` = (sub, ins, del)."""
    sub_p, ins_p, del_p = error
    out = []
    for c in range(0, len(seqs), _CHUNK):
        part = seqs[c:c + _CHUNK]
        lens = np.array([len(s) for s in part], np.int64)
        src = np.concatenate(part)
        sid = np.repeat(np.arange(len(part)), lens)
        keep = rng.random(len(src), dtype=np.float32) >= del_p
        bases, sid = src[keep], sid[keep]
        subs = np.flatnonzero(rng.random(len(bases), dtype=np.float32)
                              < sub_p)
        bases[subs] = ACGT[(np.searchsorted(ACGT, bases[subs])
                            + rng.integers(1, 4, subs.size)) % 4]
        ins = np.flatnonzero(rng.random(len(bases), dtype=np.float32)
                             < ins_p)
        bases = np.insert(bases, ins + 1, ACGT[rng.integers(0, 4, ins.size)])
        sid = np.insert(sid, ins + 1, sid[ins])
        bounds = np.concatenate(
            ([0], np.cumsum(np.bincount(sid, minlength=len(part)))))
        out.extend(bases[bounds[i]:bounds[i + 1]] for i in range(len(part)))
    return out


def free_starts(chroms: list, length: int):
    """Every start of a ``length``-base window that holds no N, over
    ``chroms`` ([(name, bases)]): (chromosome index, first start, count of
    starts) per N-free run long enough."""
    out = []
    for ci, (_, bases) in enumerate(chroms):
        isn = np.concatenate(([True], bases == ord("N"), [True]))
        edge = np.flatnonzero(isn[1:] != isn[:-1])
        for s, e in zip(edge[::2], edge[1::2]):
            if e - s >= length:
                out.append((ci, int(s), int(e - s - length + 1)))
    return out


def make_pool(chroms: list, profile: dict, n: int, seed: int) -> list:
    """``n`` simulated reads of the read ``profile`` from the genome
    ``chroms`` ([(name, bases)]): ``length`` bases from a start drawn
    uniformly over every N-free window, a random strand, the ``error``
    profile (substitution, insertion, deletion).  Loci from
    ``loci_seed``, strands and errors from ``seed``.  Returns
    [(name, seq)]."""
    loci = np.random.default_rng(profile["loci_seed"])
    rng = np.random.default_rng(seed)
    ln = profile["length"]
    free = free_starts(chroms, ln)
    count = np.array([f[2] for f in free], np.int64)
    cum = np.cumsum(count)
    u = loci.integers(0, int(cum[-1]), n)
    idx = np.searchsorted(cum, u, side="right")
    srcs, names = [], []
    for i, (j, x) in enumerate(zip(idx, u)):
        ci, first, cnt = free[j]
        start = first + int(x - cum[j] + cnt)
        name, bases = chroms[ci]
        srcs.append(bases[start:start + ln])
        names.append(f"r{i}_{name}_{start}")
    seqs = mutate_many(rng, srcs, profile["error"])
    minus = rng.random(n) < 0.5
    return [(f"{nm}_{'-' if m else '+'}", revcomp(s) if m else s)
            for nm, s, m in zip(names, seqs, minus)]


def fasta_bytes(records) -> bytes:
    """One FASTA record per (name, ASCII uint8 sequence), one line each."""
    parts = []
    for name, seq in records:
        parts.append(f">{name}\n".encode())
        parts.append(seq.tobytes())
        parts.append(b"\n")
    return b"".join(parts)
