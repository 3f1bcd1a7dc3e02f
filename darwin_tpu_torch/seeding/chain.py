"""Host-side anchor chaining (SeedPosTable::DSOFT tail,
software/seed_pos_table.cpp:391-552).

A jax-free copy of ``darwin_tpu/seeding/chain.py:chain_anchors`` (which
reaches jax through ``darwin_tpu.seeding.dsoft``): the same native call
(``darwin_tpu.native.chain_anchors_native``) with the port's ``sv_bins``.
The native library is required; darwin_tpu's pure-Python fallback is not
copied.
"""

from __future__ import annotations

from typing import List

from darwin_tpu import native
from darwin_tpu.seeding.chain import Anchor
from darwin_tpu_torch.seeding.dsoft import sv_bins


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
        raise RuntimeError("the native host library (native/darwin_native"
                           ".cpp, built with g++ at first use) is "
                           "unavailable; chaining needs it")
    left, loff, right, roff, nch, sc = res
    out = [Anchor(hit=int(anc_pos[a]), offset=int(anc_off[a]),
                  num_chained_hits=int(nch[a]), anchor_score=int(sc[a]),
                  left_chained=left[loff[a]:loff[a + 1]].copy(),
                  right_chained=right[roff[a]:roff[a + 1]].copy())
           for a in range(n_anchors)]
    out.sort(key=lambda x: (-x.num_chained_hits, x.hit_offset))
    return out
