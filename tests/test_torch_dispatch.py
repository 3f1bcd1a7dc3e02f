"""darwin_tpu_torch's dispatchers against darwin_tpu.ops.dispatch on the
CPU: tile gathers, the filter's first-tile scores and the extension
rounds (standard and large tiles, both orientations).  Exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from darwin_tpu.config import Config
from darwin_tpu.genome import GenomeStore, encode5
from darwin_tpu.ops import dispatch as jdisp, gact as jgact
from darwin_tpu.utils.simulate import mutate_read
from darwin_tpu_torch.ops import dispatch, gact

torch.set_num_threads(2)

CFG = Config()


@pytest.fixture(scope="module")
def bufs():
    """Genome codes (+ the large-tile N margin) and a query buffer of
    mutated genome slices with N margins, as both packages upload them."""
    rng = np.random.default_rng(8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    store = GenomeStore()
    store.add_chromosome("c0", acgt[rng.integers(0, 4, 30_000)])
    store.finalize()
    ref = encode5(store.bases_with_margin(4 * CFG.large_tile_long))
    starts = rng.integers(200, 24_000, 6)
    parts, q_at = [], []
    pos = 0
    for s in starts:
        seq = mutate_read(rng, store.bases[128 + s:128 + s + 3000])
        q_at.append((pos, int(s) + 128, len(seq)))
        parts += [seq, np.full(4 * CFG.tile_size, ord("N"), np.uint8)]
        pos += len(seq) + 4 * CFG.tile_size
    q = encode5(np.concatenate(parts))
    chrom = store.chromosomes[0]
    return ref, q, q_at, (chrom.start, chrom.length)


def _requests(rng, q_at, n, qt, rt):
    r_start, r_size, q_start, q_size = [], [], [], []
    for i in range(n):
        qoff, rpos, qlen = q_at[i % len(q_at)]
        o = int(rng.integers(0, qlen - qt))
        r_start.append(rpos + o + int(rng.integers(-20, 20)))
        r_size.append(int(rng.integers(rt // 2, rt + 1)) if i % 3 else rt)
        q_start.append(qoff + o)
        q_size.append(int(rng.integers(qt // 2, qt + 1)) if i % 4 else qt)
    return [np.array(x, np.int64) for x in (r_start, r_size, q_start,
                                            q_size)]


def test_gather_tiles_matches(bufs):
    ref, q, q_at, _ = bufs
    rng = np.random.default_rng(1)
    rs, rsz, qs, qsz = _requests(rng, q_at, 10, 64, 80)
    rev = np.arange(10) % 2 == 1
    jq, jr = jdisp.gather_tiles(jnp.asarray(ref), jnp.asarray(q),
                                jnp.asarray(rs.astype(np.uint32)),
                                jnp.asarray(rsz.astype(np.int32)),
                                jnp.asarray(qs.astype(np.uint32)),
                                jnp.asarray(qsz.astype(np.int32)),
                                jnp.asarray(rev), 64, 80)
    t = lambda a: torch.from_numpy(a)
    tq, tr = dispatch.gather_tiles(t(ref), t(q), t(rs), t(rsz), t(qs),
                                   t(qsz), t(rev), 64, 80)
    for b in range(10):       # lanes past a tile's size are don't-care
        np.testing.assert_array_equal(tq[b, :qsz[b]].numpy(),
                                      np.asarray(jq)[b, :qsz[b]])
        np.testing.assert_array_equal(tr[b, :rsz[b]].numpy(),
                                      np.asarray(jr)[b, :rsz[b]])


def test_first_tile_scores_matches(bufs):
    ref, q, q_at, _ = bufs
    rng = np.random.default_rng(2)
    T = CFG.first_tile_size
    rs, rsz, qs, qsz = _requests(rng, q_at, 16, T, T)
    want = jdisp.first_tile_scores(jnp.asarray(ref), jnp.asarray(q), rs, rsz,
                                   qs, qsz, jgact.make_params(CFG), qt=T,
                                   rt=T)
    got = dispatch.first_tile_scores(
        torch.from_numpy(ref), torch.from_numpy(q), rs, rsz, qs, qsz,
        gact.make_params(CFG), qt=T, rt=T)
    for k in ("score", "query_max_pos", "ref_max_pos"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(
        got["packed"].numpy(),
        np.stack([np.asarray(want[k]) for k in ("score", "query_max_pos",
                                                "ref_max_pos")]))
    assert (got["score"].numpy() >= CFG.first_tile_score_threshold).any()


@pytest.mark.parametrize("rt,qt", [(384, 384), (1984, 960)])
def test_extend_tiles_async_matches(bufs, rt, qt):
    """A chain of one tile is darwin_tpu's one-tile extension dispatch."""
    ref, q, q_at, (c_start, c_len) = bufs
    rng = np.random.default_rng(rt)
    n = 8 if rt == qt else 4
    rs, rsz, qs, qsz = _requests(rng, q_at, n, qt, rt)
    rev = np.arange(n) % 2 == 0
    chain = [np.full(n, c_start), np.full(n, c_len),
             np.array([q_at[i % len(q_at)][0] for i in range(n)]),
             np.array([q_at[i % len(q_at)][2] for i in range(n)])]
    max_tb = 2 * CFG.tile_size
    want = jdisp.extend_tiles_async(
        jnp.asarray(ref), jnp.asarray(q), rs, rsz, qs, qsz, rev,
        jgact.make_params(CFG), qt=qt, rt=rt, max_tb=max_tb)()
    got = dispatch.extend_tiles_async(
        torch.from_numpy(ref), torch.from_numpy(q), rs, rsz, qs, qsz,
        rev.astype(np.int64), *chain, gact.make_params(CFG), qt=qt, rt=rt,
        max_tb=max_tb, stop_thr=min(qt, rt) - CFG.tile_overlap, K=1)()
    assert set(got) == {"ops", "n_ops", "q_steps", "r_steps", "score",
                        "query_max_pos", "ref_max_pos", "spec_req",
                        "ops_spec"}
    assert got["spec_req"] == []
    for k in ("n_ops", "q_steps", "r_steps", "score", "query_max_pos",
              "ref_max_pos"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    ops_j = np.asarray(want["ops"])
    L = got["ops"].shape[1]
    assert L == min(qt + rt, 2 * max_tb)
    np.testing.assert_array_equal(got["ops"], ops_j[:, :L])
    assert not ops_j[:, L:].any()
    assert (got["n_ops"] > 0).all()
