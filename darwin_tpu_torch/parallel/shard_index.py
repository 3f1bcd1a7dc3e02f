"""The seed table sharded by hash range over a mesh (counterpart of
``darwin_tpu/parallel/shard_index.py``): the scale-out path for a pairs
table that does not fit one card.

* ``shard_seed_table``: rows of the hash-sorted pairs arrays, in ``Npad /
  n`` blocks, are hash ranges; block i lives on the mesh's device i (a
  view of the table where that is the table's own device), the last ones
  padded with ``PAD_HASH`` rows.  ``torch.searchsorted`` on a block needs
  no prefix LUT, so none is built.
* ``dsoft_sharded``: every shard scans all rows' queried minimizers and
  takes their bucket ranges in its block; a bucket's size in the whole
  table — what the occupancy cap (kmer_max_occurence,
  software/seed_pos_table.cpp:314) reads — is the sum of the shards'
  (darwin_tpu's ``psum``); each shard gathers its flat hits; then row
  block j of every shard's hits goes to shard j, concatenated in shard
  order along the hit axis (darwin_tpu's tiled ``all_to_all``), and the
  sort, count and anchor stage (``dsoft._hits_post``) runs on the owner's
  device.

Tie order: the reference stable-sorts hits by (bin, offset), insertion
order breaking ties.  Equal (bin, offset) keys come from one minimizer's
bucket (the offset names the minimizer, the bin then the position), whose
positions concatenate in shard order = position order, so the sharded
sort equals the replicated one.
"""

from __future__ import annotations

import dataclasses

import torch

from darwin_tpu_torch.parallel.shard import Mesh, block
from darwin_tpu_torch.seeding import dsoft as D
from darwin_tpu_torch.utils.turns import fetch

# hash of the padding rows: int32's largest value sorts after every
# hash, which is masked to 2k <= 30 bits and so never equals it
PAD_HASH = 0x7FFFFFFF


@dataclasses.dataclass
class ShardedSeedTable:
    hashes: tuple            # per shard: (Npad / n,) int32, ascending
    positions: tuple         # per shard: (Npad / n,) int32 bits of uint32
    mesh: Mesh

    def resident_bytes(self) -> list:
        """Bytes each shard holds of its own (0 for a view of the
        table)."""
        return [sum(t.numel() * t.element_size() for t in (h, p)
                    if t._base is None)
                for h, p in zip(self.hashes, self.positions)]


def shard_seed_table(table, mesh: Mesh) -> ShardedSeedTable:
    """Split a pairs SeedTable's rows over ``mesh`` (a power-of-two
    size)."""
    if table.bucket_offsets is not None:
        raise ValueError(
            "hash-sharded seeding partitions the sorted-pair layout; build "
            "the table with layout='pairs' for mesh=... (csr is the "
            "single-card big-table answer)")
    n = len(mesh)
    if n & (n - 1):
        raise ValueError(f"mesh size must be a power of two: {n}")
    N = table.num_seeds
    per = -(-max(N, 1) // n)

    def rows_on(src, lo, rows, fill, dev):
        # one (per,) tensor on dev: a view where it needs no padding
        part = src.narrow(0, lo, rows)
        if rows == per:
            return part.to(dev)
        out = torch.full((per,), fill, dtype=src.dtype, device=dev)
        out[:rows].copy_(part)
        return out

    hashes, positions = [], []
    for i, dev in enumerate(mesh):
        lo = min(i * per, N)
        rows = min(per, N - lo)
        hashes.append(rows_on(table.sorted_hashes, lo, rows, PAD_HASH, dev))
        positions.append(rows_on(table.positions, lo, rows, 0, dev))
    return ShardedSeedTable(tuple(hashes), tuple(positions), mesh)


def dsoft_sharded(codes2, lengths, st: ShardedSeedTable, *, k, w,
                  num_seeds, max_stride, overlap, threshold, bin_size,
                  max_occ, mq_cap):
    """Hash-sharded D-SOFT: ``dsoft.dsoft_device``'s result contract on
    the first shard's device, the hit and anchor width n x hit_cap (a
    row's hits gather a block from every shard).  hit_cap, the per-shard
    flat width, is sized exactly from the largest per-shard count (one
    fetch), so no row loses a hit; ``n_flat_raw`` is a row's largest
    per-shard need."""
    mesh = st.mesh
    B = codes2.shape[0]
    scans = []
    for s, dev in enumerate(mesh):
        offs, qhash, slot_ok = D._queried_minimizers(
            codes2.to(dev), lengths.to(dev), k, w, num_seeds, max_stride,
            overlap, mq_cap)
        start, end = D._bucket_ranges(st.hashes[s], qhash.contiguous())
        scans.append((dev, offs, slot_ok, start, end))
    home = mesh[0]
    cnt_global = sum((end - start).to(home) for *_, start, end in scans)
    need = torch.stack([
        torch.where(slot_ok & (cnt_global.to(dev) <= max_occ), end - start,
                    0).sum(1).max().to(home)
        for dev, _, slot_ok, start, end in scans])
    hit_cap = max(int(fetch(need.max())), 1)

    flats = []
    for s, (dev, offs, slot_ok, start, end) in enumerate(scans):
        cg = cnt_global.to(dev)
        binf, offf, posf, bucket_ok, total = D._bucket_hits_flat(
            st.positions[s], offs, start, end, cg, slot_ok, max_occ,
            bin_size, hit_cap)
        # bucket_ok and the cap depend on replicated values only, so
        # every shard holds the same per-row counts
        nqb = bucket_ok.sum(1)
        ncap = (slot_ok & (cg > max_occ)).sum(1)
        flats.append((binf, offf, posf, total, nqb, ncap))

    # route row block j of every shard's hits to shard j, concatenated
    # in shard order
    owned = []
    for j, dev in enumerate(mesh):
        lo, hi = block(B, j, len(mesh))
        if hi == lo:
            continue

        def gather(f):
            return torch.cat([x[f][lo:hi].to(dev) for x in flats], 1)
        res = D._hits_post(gather(0), gather(1), gather(2),
                           flats[j][4][lo:hi], k, threshold,
                           len(mesh) * hit_cap, D.sv_bins(bin_size, overlap))
        res["n_flat_raw"] = torch.stack(
            [x[3][lo:hi].to(dev) for x in flats]).amax(0)
        res["n_capped"] = flats[j][5][lo:hi]
        owned.append(res)
    return {key: torch.cat([r[key].to(home) for r in owned])
            for key in owned[0]}
