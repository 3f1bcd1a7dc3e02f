"""Long-read simulator: reads drawn from a GenomeStore with a simple
PacBio-like error model (substitutions + short indels), on both strands.

The port's own copy of ``darwin_tpu/utils/simulate.py`` (numpy only; the
same seed gives the same reads in both packages).
"""

from __future__ import annotations

import numpy as np

from darwin_tpu_torch.genome import GenomeStore, revcomp_bytes

_ACGT = np.frombuffer(b"ACGT", np.uint8)


def mutate_read(rng, seq: np.ndarray, sub_p=0.04, ins_p=0.03,
                del_p=0.03) -> np.ndarray:
    r = rng.random(len(seq))
    keep = r >= del_p
    out = seq[keep].copy()
    subs = rng.random(len(out)) < sub_p
    out[subs] = _ACGT[(rng.integers(1, 4, subs.sum())
                       + np.searchsorted(_ACGT, out[subs])) % 4]
    ins_mask = rng.random(len(out)) < ins_p
    if ins_mask.any():
        pieces = []
        prev = 0
        for i in np.nonzero(ins_mask)[0]:
            pieces.append(out[prev:i + 1])
            pieces.append(_ACGT[rng.integers(0, 4, 1)])
            prev = i + 1
        pieces.append(out[prev:])
        out = np.concatenate(pieces)
    return out


def ont_lengths(rng, n: int, mean: int = 10000, sigma: float = 0.55,
                lo: int = 1000, hi: int = 40000) -> np.ndarray:
    """ONT-like log-normal read-length draw (long right tail)."""
    mu = np.log(mean) - sigma * sigma / 2
    return np.clip(rng.lognormal(mu, sigma, n).astype(np.int64), lo, hi)


def simulate_reads(store: GenomeStore, n_reads: int, read_len: int,
                   seed: int = 0, error=(0.04, 0.03, 0.03),
                   read_lens=None):
    """Returns list of (name, seq_bytes, truth) where truth =
    (chr_name, start0, strand).  ``read_lens`` (per-read lengths, e.g.
    ont_lengths) overrides the fixed ``read_len``; ``error`` is
    (sub, ins, del) — (0.03, 0.03, 0.04) approximates an ONT profile."""
    rng = np.random.default_rng(seed)
    total = sum(c.length_unpadded for c in store.chromosomes)
    weights = [c.length_unpadded / total for c in store.chromosomes]
    out = []
    for i in range(n_reads):
        ci = int(rng.choice(len(store.chromosomes), p=weights))
        c = store.chromosomes[ci]
        want = read_len if read_lens is None else int(read_lens[i])
        ln = min(want, c.length_unpadded - 1)
        start = int(rng.integers(0, max(c.length_unpadded - ln, 1)))
        seq = store.bases[c.start + start:c.start + start + ln]
        seq = mutate_read(rng, seq, *error)
        strand = "+" if rng.random() < 0.5 else "-"
        if strand == "-":
            seq = revcomp_bytes(seq)
        out.append((f"read{i}_{c.name}_{start}_{strand}", seq,
                    (c.name, start, strand)))
    return out


def write_fasta(path: str, reads):
    with open(path, "w") as f:
        for name, seq, _ in reads:
            f.write(f">{name}\n{seq.tobytes().decode()}\n")
