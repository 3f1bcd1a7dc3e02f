"""Seed position table, pairs layout: k-mer hash -> reference positions
(counterpart of ``darwin_tpu/index/seed_table.py``).

The table is every emitted (hash, position) pair sorted by (hash, position),
on the device: ``sorted_hashes`` and ``positions`` (int64; positions are the
reference's uint32 coordinates, which torch's int64 carries exactly).  A
bucket's range is two ``searchsorted`` lookups at query time; buckets over
``kmer_max_occurence`` are kept and skipped by the seeder, as the reference
does (software/seed_pos_table.cpp:55,314).

Not ported yet: the csr layout and the streaming builds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from darwin_tpu_torch.genome import GenomeStore, Read
from darwin_tpu_torch.index.minimizers import scan_sequence


@dataclasses.dataclass
class SeedTable:
    sorted_hashes: torch.Tensor    # (N,) int64, ascending
    positions: torch.Tensor        # (N,) int64, ascending within a hash
    kmer_size: int
    minimizer_window: int
    ref_size: int                  # full coordinate-space size (incl. guard)
    kmer_max_occurence: int
    _hashes_host: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def num_seeds(self) -> int:
        return int(self.positions.shape[0])

    def is_present(self, kmer_hash: int) -> bool:
        """Whether the bucket is usable: non-empty and within the occupancy
        cap (SeedPosTable::IsPresent).  Searches a memoized host copy."""
        h = self._hashes_host
        if h is None:
            h = self._hashes_host = self.sorted_hashes.cpu().numpy()
        lo = int(np.searchsorted(h, kmer_hash, side="left"))
        hi = int(np.searchsorted(h, kmer_hash, side="right"))
        return 0 < hi - lo <= self.kmer_max_occurence

    def save(self, path: str):
        """The .npz format of darwin_tpu's SeedTable.save (pairs layout):
        uint32 ``hashes`` and ``positions`` + int64 ``meta``."""
        np.savez_compressed(
            path, positions=self.positions.cpu().numpy().astype(np.uint32),
            hashes=self.sorted_hashes.cpu().numpy().astype(np.uint32),
            meta=np.array([self.kmer_size, self.minimizer_window,
                           self.ref_size, self.kmer_max_occurence],
                          np.int64))

    @classmethod
    def from_numpy(cls, sorted_hashes, positions, meta, device="cpu"
                   ) -> "SeedTable":
        """A table from host arrays in darwin_tpu's layout (uint32 sorted
        hashes and positions; meta = (k, w, ref_size, kmer_max_occurence))
        — carries a darwin_tpu table across so both packages run on the
        same index."""
        k, w, ref_size, maxocc = (int(x) for x in np.asarray(meta))
        dev = torch.device(device)

        def up(a):
            return torch.from_numpy(np.asarray(a).astype(np.int64)).to(dev)
        return cls(sorted_hashes=up(sorted_hashes), positions=up(positions),
                   kmer_size=k, minimizer_window=w, ref_size=ref_size,
                   kmer_max_occurence=maxocc)

    @classmethod
    def load(cls, path: str, device="cpu") -> "SeedTable":
        """Read a pairs-layout .npz written by either package's save()."""
        with np.load(path) as z:
            if "hashes" not in z:
                raise NotImplementedError(
                    f"{path} holds a csr-layout table; darwin_tpu_torch "
                    "reads the pairs layout only")
            return cls.from_numpy(z["hashes"], z["positions"], z["meta"],
                                  device)


def build_seed_table(store: GenomeStore, cfg, device="cpu") -> SeedTable:
    """Per-chromosome minimizer scans on the device (the emission state
    resets per chromosome), positions made absolute (local + chromosome
    start), then one sort of the int64 key hash << 32 | pos — keys are
    unique, so this is darwin_tpu's (hash, pos) order exactly."""
    k, w = cfg.seed_size, cfg.minimizer_window
    if not 3 < k <= 15:
        raise ValueError(f"seed_size {k} outside the reference's (3, 15]")
    dev = torch.device(device)
    codes2 = store.codes2
    keys = []
    for c in store.chromosomes:
        seg = torch.from_numpy(codes2[c.start:c.start + c.length]).to(dev)
        pos, hashes = scan_sequence(seg, c.length_unpadded, k, w)
        keys.append((hashes << 32) | (pos + c.start))
    if keys:
        key = torch.sort(torch.cat(keys), stable=True).values
    else:
        key = torch.zeros(0, dtype=torch.int64, device=dev)
    return SeedTable(sorted_hashes=key >> 32, positions=key & 0xFFFFFFFF,
                     kmer_size=k, minimizer_window=w, ref_size=store.size,
                     kmer_max_occurence=cfg.kmer_max_occurence(store.size))


def build_read_seed_table(reads: list[Read], cfg, device="cpu"
                          ) -> tuple[SeedTable, GenomeStore]:
    """Overlap (de-novo) mode: index the reads themselves
    (darwin_tpu/index/seed_table.py:330-344).  The reference runs the same
    index phase on the reads file passed as the 'reference' argument, so
    the reads become the chromosomes of a GenomeStore and coordinates and
    guards match."""
    store = GenomeStore.from_numpy([r.name for r in reads],
                                   [r.seq for r in reads])
    return build_seed_table(store, cfg, device), store
