"""Seed position table: k-mer hash -> reference positions (counterpart of
``darwin_tpu/index/seed_table.py``), in one of two layouts with the same
bucket contents and in-bucket (position-ascending) order:

* pairs (default): ``sorted_hashes`` (int32, ascending) + ``positions``,
  8 B a seed; a bucket's range is two ``searchsorted`` lookups.
* csr: ``bucket_offsets`` ((4^k + 1,) int32, 1.07 GB at k = 14) +
  ``positions``, 4 B a seed; a bucket's range is two direct gathers and
  ``sorted_hashes`` is None.  What fits the default w = 3 index of a
  3.1 Gbp genome with room to spare (1.5 G seeds: 7.3 GB against 12.3 GB
  as pairs).

``positions`` hold the reference's uint32 coordinates as int32 bit
patterns (``minimizers.widen`` reads them).  Buckets over
``kmer_max_occurence`` are kept and skipped by the seeder, as the
reference does (software/seed_pos_table.cpp:55,314).

Builds (``build_seed_table``): the all-candidates device build under a
memory gate, the streaming device build past it, the csr build, and the
host build — the oracle of tests and the lossless fallback when a device
pairs build runs out of memory.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from darwin_tpu_torch.genome import GenomeStore, Read
from darwin_tpu_torch.index import minimizers as mz
from darwin_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class SeedTable:
    sorted_hashes: torch.Tensor | None   # (N,) int32, ascending (pairs)
    positions: torch.Tensor        # (N,) int32 bits of uint32, ascending
    kmer_size: int                 # within a hash
    minimizer_window: int
    ref_size: int                  # full coordinate-space size (incl. guard)
    kmer_max_occurence: int
    bucket_offsets: torch.Tensor | None = None   # (4^k + 1,) int32 (csr)
    # how the table was built: method, layout, scan batches, rows,
    # sequences per batch, the seconds of a pass that ends in a host fetch
    # (csr's count pass, the streaming scan pass), retries, fallback
    # (empty if loaded); callers time and measure the whole build
    build_stats: dict = dataclasses.field(default_factory=dict,
                                          compare=False)
    _hashes_host: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def layout(self) -> str:
        return "pairs" if self.bucket_offsets is None else "csr"

    @property
    def num_seeds(self) -> int:
        return int(self.positions.shape[0])

    def is_present(self, kmer_hash: int) -> bool:
        """Whether the bucket is usable: non-empty and within the occupancy
        cap (SeedPosTable::IsPresent).  csr: a two-element gather; pairs:
        a search of a memoized host copy."""
        if self.bucket_offsets is not None:
            lo, hi = (int(x) for x in
                      self.bucket_offsets[kmer_hash:kmer_hash + 2].cpu())
            return 0 < hi - lo <= self.kmer_max_occurence
        h = self._hashes_host
        if h is None:
            h = self._hashes_host = self.sorted_hashes.cpu().numpy()
        lo = int(np.searchsorted(h, kmer_hash, side="left"))
        hi = int(np.searchsorted(h, kmer_hash, side="right"))
        return 0 < hi - lo <= self.kmer_max_occurence

    def save(self, path: str):
        """darwin_tpu's .npz format: uint32 ``positions``, int64 ``meta``,
        and uint32 ``hashes`` (pairs) or int32 ``offsets`` (csr)."""
        arrays = {
            "positions": self.positions.cpu().numpy().view(np.uint32),
            "meta": np.array([self.kmer_size, self.minimizer_window,
                              self.ref_size, self.kmer_max_occurence],
                             np.int64)}
        if self.bucket_offsets is not None:
            arrays["offsets"] = self.bucket_offsets.cpu().numpy()
        else:
            arrays["hashes"] = self.sorted_hashes.cpu().numpy().view(
                np.uint32)
        np.savez_compressed(path, **arrays)

    @classmethod
    def from_numpy(cls, sorted_hashes, positions, meta, device="cuda",
                   bucket_offsets=None) -> "SeedTable":
        """A table on ``device`` from host arrays in darwin_tpu's layout
        (uint32 sorted hashes — None for csr — and positions; meta = (k,
        w, ref_size, kmer_max_occurence); int32 bucket offsets for csr):
        carries a darwin_tpu table across so both packages run on the same
        index."""
        k, w, ref_size, maxocc = (int(x) for x in np.asarray(meta))
        dev = resolve_device(device)

        def up(a):
            a = np.asarray(a)
            if a.dtype != np.int32:
                a = a.astype(np.uint32).view(np.int32)
            return torch.from_numpy(np.require(a, requirements="CW")).to(dev)
        return cls(
            sorted_hashes=None if sorted_hashes is None else up(sorted_hashes),
            positions=up(positions), kmer_size=k, minimizer_window=w,
            ref_size=ref_size, kmer_max_occurence=maxocc,
            bucket_offsets=(None if bucket_offsets is None
                            else up(bucket_offsets)))

    @classmethod
    def load(cls, path: str, device="cuda") -> "SeedTable":
        """Read a .npz of either layout written by either package's save()
        onto ``device``."""
        with np.load(path) as z:
            return cls.from_numpy(
                z["hashes"] if "hashes" in z else None, z["positions"],
                z["meta"], device,
                z["offsets"] if "offsets" in z else None)


def _csr_hint(k: int) -> str:
    """darwin_tpu's advice when a pairs table does not fit the device."""
    if 2 * k <= 28:
        return "  Consider --index-layout csr for genomes this large."
    return ("  (csr layout needs seed_size <= 14; at this k the host-"
            "resident pairs build is the fallback.)")


def _free_bytes(dev) -> int:
    """Memory a build may still take on ``dev``: the card's free memory
    plus what torch's allocator holds unused, or the host's free pages."""
    if dev.type == "cuda":
        free, _ = torch.cuda.mem_get_info(dev)
        return free + (torch.cuda.memory_reserved(dev)
                       - torch.cuda.memory_allocated(dev))
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def device_build_fits(lengths, k: int, w: int, dev) -> bool:
    """The gate between the all-candidates and the streaming pairs build:
    what the all-candidates build holds for these sequences
    (``minimizers.device_build_bytes``: bytes per scanned position, so a
    read set pays a whole row per short read) must fit 90% of what is free
    (darwin_tpu gates at 512 Mbp, sized for a 16 GB chip)."""
    return mz.device_build_bytes(lengths, k, w) <= 0.9 * _free_bytes(dev)


def build_seed_table(store: GenomeStore, cfg, device="cuda",
                     method: str | None = None,
                     layout: str = "pairs") -> SeedTable:
    """The table of a finalized GenomeStore on ``device``: the minimizers
    of every chromosome (the emission state resets per chromosome) at
    absolute positions (chromosome start + local, software/main.cpp:340),
    scanned as one work list.

    method (pairs only): None picks ``"device"`` (all candidates, one
    sort) when ``device_build_fits``, else ``"stream"`` (8 B per emitted
    seed, a lossless retry when its estimated capacity overflows);
    ``"host"`` sorts on the host (the tests' oracle).  A device build that
    runs out of memory falls back to the host build, which gives the same
    table.  layout ``"csr"`` has one build (two streaming passes) and
    needs seed_size <= 14."""
    k, w = cfg.seed_size, cfg.minimizer_window
    if not 3 < k <= 15:
        raise ValueError(f"seed_size {k} outside the reference's (3, 15]")
    if layout not in ("pairs", "csr"):
        raise ValueError(f"unknown index layout {layout!r}")
    if method not in (None, "device", "stream", "host"):
        raise ValueError(f"unknown build method {method!r}")
    if layout == "csr":
        if method is not None:
            raise ValueError(
                "csr has a single (streaming device) build; the method "
                "parameter selects among pairs builds only")
        if 2 * k > 28:
            raise ValueError(
                f"csr layout supports seed_size <= 14 (the 4^{k} "
                "bucket-offset array would exceed 1 GiB); use the "
                "pairs layout")
    dev = resolve_device(device)
    lengths = [c.length_unpadded for c in store.chromosomes]
    starts = [c.start for c in store.chromosomes]
    table = dict(kmer_size=k, minimizer_window=w, ref_size=store.size,
                 kmer_max_occurence=cfg.kmer_max_occurence(store.size))
    if method is None:
        method = ("csr" if layout == "csr"
                  else "host" if store.size == 0
                  else "device" if device_build_fits(lengths, k, w, dev)
                  else "stream")
    stats = {"method": method, "layout": layout}
    if method != "host":
        try:
            codes = mz.encode2_on(store.bases, dev)
            if method == "csr":
                offsets, positions, n = mz.build_csr(codes, starts, lengths,
                                                     k, w, stats)
                sh = None
            elif method == "device":
                sh, positions = mz.sorted_pairs_device(codes, starts,
                                                       lengths, k, w, stats)
            else:
                # the estimate is the expected density 2/(w+1) with margin;
                # repeat-heavy genomes emit up to ~1/w and retry
                cap = int(store.size * 2.4 / (w + 1)) + (1 << 22)
                while True:
                    sh, positions, n = mz.sorted_pairs_streaming(
                        codes, starts, lengths, k, w, cap, stats)
                    if n >= 0:
                        break
                    cap = max(2 * cap, -n + (1 << 22))
                    stats["retries"] = stats.get("retries", 0) + 1
            del codes
            return SeedTable(sorted_hashes=sh, positions=positions,
                             bucket_offsets=(offsets if method == "csr"
                                             else None),
                             build_stats=stats, **table)
        except torch.cuda.OutOfMemoryError:
            if method == "csr":
                raise
            # the all-candidates sort or the streaming accumulator did not
            # fit beside what the card holds; the host sort gives the
            # identical table, slower
            codes = None
            sys.stderr.write(
                "[darwin_tpu_torch] device seed-table build exhausted HBM; "
                f"falling back to the host build (identical output)."
                f"{_csr_hint(k)}\n")
            stats["fallback"] = stats["method"]
            stats["method"] = "host"
    codes = mz.encode2_on(store.bases, dev)
    hashes, pos = mz.host_pairs(codes, starts, lengths, k, w, stats)
    del codes
    key = (hashes.astype(np.uint64) << np.uint64(32)) | pos.astype(np.uint64)
    order = np.argsort(key, kind="stable")
    try:
        # the resident table (8 B a seed) must still fit beside what the
        # card holds; say what to do instead of a raw allocator error
        sh = torch.from_numpy(hashes[order].view(np.int32)).to(dev)
        positions = torch.from_numpy(pos[order].view(np.int32)).to(dev)
    except torch.cuda.OutOfMemoryError as e:
        raise RuntimeError(
            "[darwin_tpu_torch] the seed table itself does not fit device "
            f"HBM ({hashes.size / 1e6:.0f} M seeds x 8 B beside the genome)."
            f"{_csr_hint(k)}") from e
    return SeedTable(sorted_hashes=sh, positions=positions,
                     build_stats=stats, **table)


def build_read_seed_table(reads: list[Read], cfg, device="cuda",
                          layout: str = "pairs"
                          ) -> tuple[SeedTable, GenomeStore]:
    """Overlap (de-novo) mode: index the reads themselves
    (darwin_tpu/index/seed_table.py:330-344).  The reference runs the same
    index phase on the reads file passed as the 'reference' argument, so
    the reads become the chromosomes of a GenomeStore and coordinates and
    guards match; the work-list scan takes them ROWS rows a batch."""
    store = GenomeStore.from_numpy([r.name for r in reads],
                                   [r.seq for r in reads])
    return build_seed_table(store, cfg, device, layout=layout), store
