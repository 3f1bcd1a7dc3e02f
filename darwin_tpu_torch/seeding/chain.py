"""Host-side anchor chaining (SeedPosTable::DSOFT tail,
software/seed_pos_table.cpp:391-552).

The port's own copy of ``darwin_tpu/seeding/chain.py``'s ``Anchor`` and
``chain_anchors``: the same native call (``native.chain_anchors_native``)
with the port's ``sv_bins``.  The native library is required; darwin_tpu's
pure-Python fallback is not copied.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from darwin_tpu_torch import native
from darwin_tpu_torch.seeding.dsoft import sv_bins


@dataclasses.dataclass
class Anchor:
    hit: int                 # absolute reference position
    offset: int              # query position
    num_chained_hits: int
    anchor_score: int
    left_chained: np.ndarray   # uint64 (hit<<32)|offset, ascending
    right_chained: np.ndarray  # uint64, DESCENDING (reference reverses :488)

    @property
    def hit_offset(self) -> int:
        return (self.hit << 32) | self.offset


def chain_anchors(hits_bin, hits_off, hits_pos, n_hits,
                  anc_pos, anc_off, anc_bin, n_anchors,
                  bin_size: int, overlap: bool) -> List[Anchor]:
    """hits_*: host int arrays (valid prefix of length n_hits, sorted by
    (bin, offset)); anc_*: anchors in bin-ascending order.  Returns the
    chained anchors ordered by (chain length desc, hit_offset asc)."""
    if n_anchors == 0:
        return []
    res = native.chain_anchors_native(
        hits_bin, hits_off, hits_pos, n_hits, anc_pos, anc_off, anc_bin,
        n_anchors, sv_bins(bin_size, overlap))
    if res is None:
        raise RuntimeError("chaining: " + native.unavailable_reason())
    left, loff, right, roff, nch, sc = res
    out = [Anchor(hit=int(anc_pos[a]), offset=int(anc_off[a]),
                  num_chained_hits=int(nch[a]), anchor_score=int(sc[a]),
                  left_chained=left[loff[a]:loff[a + 1]].copy(),
                  right_chained=right[roff[a]:roff[a + 1]].copy())
           for a in range(n_anchors)]
    out.sort(key=lambda x: (-x.num_chained_hits, x.hit_offset))
    return out
