"""darwin_tpu_torch's D-SOFT and seeder against darwin_tpu's on a
repeat-structured genome (utils.synthgenome) where the occupancy cap
fires: per-row hits, anchors, queried and capped bucket counts, and the
chained anchors.  Both packages run on the same seed table.  Exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from darwin_tpu import genome as G
from darwin_tpu.config import Config
from darwin_tpu.genome import GenomeStore, make_read
from darwin_tpu.index import seed_table as jst
from darwin_tpu.seeding import dsoft as jds
from darwin_tpu.seeding.seeder import Seeder as JSeeder
from darwin_tpu.utils.simulate import mutate_read
from darwin_tpu.utils.synthgenome import repeat_genome
from darwin_tpu_torch.index.seed_table import SeedTable
from darwin_tpu_torch.seeding import dsoft
from darwin_tpu_torch.seeding.seeder import Seeder

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(21)
    bases, stats = repeat_genome(rng, 300_000)
    assert stats["repeat_frac"] > 0.2
    store = GenomeStore()
    store.add_chromosome("rep", bases)
    store.finalize()
    cfg = Config()
    cfg.seed_size = 12
    jt = jst.build_seed_table(store, cfg, method="host").ensure_lut()
    meta = [jt.kmer_size, jt.minimizer_window, jt.ref_size,
            jt.kmer_max_occurence]
    table = SeedTable.from_numpy(np.asarray(jt.sorted_hashes),
                                 np.asarray(jt.positions), meta)
    reads = []
    for i, p in enumerate(range(1000, len(bases) - 3000,
                                len(bases) // 12)):
        seq = mutate_read(rng, bases[p:p + 2500])
        reads.append(make_read(f"r{i}", seq))
    return store, cfg, jt, table, reads


def _rows(reads):
    lcap = (max(r.length for r in reads) + 15) // 16 * 16
    B = 2 * len(reads)
    codes2 = np.zeros((B, lcap), np.uint8)
    lengths = np.zeros(B, np.int32)
    for i, r in enumerate(reads):
        codes2[2 * i, :r.length] = G.encode2(r.seq)
        codes2[2 * i + 1, :r.length] = G.encode2(r.rc_seq)
        lengths[2 * i] = lengths[2 * i + 1] = r.length
    return codes2, lengths


@pytest.mark.parametrize("overlap", [False, True])
def test_dsoft_device_matches_darwin_tpu(world, overlap):
    store, cfg, jt, table, reads = world
    codes2, lengths = _rows(reads)
    lcap = codes2.shape[1]
    mq_cap = jds.mq_cap_for(lcap - cfg.seed_size + 1, cfg.num_seeds,
                            cfg.max_stride, overlap)
    max_occ = jt.kmer_max_occurence
    kw = dict(k=cfg.seed_size, w=cfg.minimizer_window,
              num_seeds=cfg.num_seeds, max_stride=cfg.max_stride,
              overlap=overlap, max_occ=max_occ, mq_cap=mq_cap)
    need = jds.dsoft_count(jnp.asarray(codes2), jnp.asarray(lengths),
                           jt.sorted_hashes, lut=jt.prefix_lut,
                           lut_shift=jt.lut_shift, lut_steps=jt.lut_steps,
                           **kw)
    c2, ln = torch.from_numpy(codes2), torch.from_numpy(lengths)
    got_need = dsoft.dsoft_count(c2, ln, table.sorted_hashes, **kw)
    np.testing.assert_array_equal(got_need.numpy(), np.asarray(need))
    hit_cap = int(np.asarray(need).max())
    a_cap = mq_cap * max_occ
    kw.update(threshold=cfg.dsoft_threshold, bin_size=cfg.bin_size,
              a_cap=a_cap, hit_cap=hit_cap)
    want = jds.dsoft_device(jnp.asarray(codes2), jnp.asarray(lengths),
                            jt.sorted_hashes, jt.positions,
                            lut=jt.prefix_lut, lut_shift=jt.lut_shift,
                            lut_steps=jt.lut_steps, **kw)
    got = dsoft.dsoft_device(c2, ln, table.sorted_hashes, table.positions,
                             **kw)
    want = {k: np.asarray(v).astype(np.int64) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    for k in ("n_hits", "n_anchors", "n_anchors_raw", "n_queried_buckets",
              "n_flat_raw", "n_capped"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["n_capped"].sum() > 0          # the occupancy cap is live
    assert got["n_anchors"].sum() > 0
    for row in range(codes2.shape[0]):
        nh, na = int(got["n_hits"][row]), int(got["n_anchors"][row])
        for k in ("hits_bin", "hits_off", "hits_pos"):
            np.testing.assert_array_equal(got[k][row, :nh],
                                          want[k][row, :nh], err_msg=k)
        for k in ("anc_pos", "anc_off", "anc_bin"):
            np.testing.assert_array_equal(got[k][row, :na],
                                          want[k][row, :na], err_msg=k)


def test_seeder_matches_darwin_tpu(world):
    """Seeder.seed_batch end to end: chained anchors per read and strand,
    and the bucket counters."""
    store, cfg, jt, table, reads = world
    want = JSeeder(jt, cfg).seed_batch(reads)
    got = Seeder(table, cfg).seed_batch(reads)
    assert got.n_queried_buckets == want.n_queried_buckets
    assert got.n_capped_buckets == want.n_capped_buckets > 0
    n = 0
    for g_strand, w_strand in ((got.fw_anchors, want.fw_anchors),
                               (got.rc_anchors, want.rc_anchors)):
        for g, w in zip(g_strand, w_strand):
            assert len(g) == len(w)
            for x, y in zip(g, w):
                n += 1
                assert (x.hit, x.offset, x.num_chained_hits,
                        x.anchor_score) == (y.hit, y.offset,
                                            y.num_chained_hits,
                                            y.anchor_score)
                assert x.left_chained.tolist() == y.left_chained.tolist()
                assert x.right_chained.tolist() == y.right_chained.tolist()
    assert n > 0


def test_failed_host_build_names_its_cause(monkeypatch, tmp_path):
    """When the host library does not build, chaining raises with the
    compiler's own message, not a bare "unavailable"."""
    from darwin_tpu_torch import native
    from darwin_tpu_torch.seeding.chain import chain_anchors
    bad = tmp_path / "darwin_native.cpp"
    bad.write_text("this is not C++\n")
    for name, value in (("_SRC", str(bad)), ("_PKG", str(tmp_path)),
                        ("_tried", False), ("_lib", None), ("_error", "")):
        monkeypatch.setattr(native, name, value)
    assert not native.available()
    one = np.zeros(1, np.int64)
    with pytest.raises(RuntimeError, match=r"(?s)chaining.*g\+\+.*error"):
        chain_anchors(one, one.astype(np.int32), one.astype(np.int32), 1,
                      one.astype(np.int32), one.astype(np.int32), one, 1,
                      64, False)
