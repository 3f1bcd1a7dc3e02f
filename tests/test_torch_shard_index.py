"""darwin_tpu_torch's hash-sharded seed index (parallel/shard_index.py)
against the replicated D-SOFT and against darwin_tpu's sharded one on its
8-device CPU mesh: every valid hit, every anchor and every count, in
order; a bucket split over a shard boundary (ties in (bin, offset)
across it), a bucket over the occupancy cap only by its global count, a
table past 2^31, the refusals, and the pipeline with shard_index=True
against darwin_tpu's.  Tolerance: none."""

import numpy as np
import pytest
import torch

from darwin_tpu import genome as JG
from darwin_tpu.config import Config as JConfig
from darwin_tpu.index import seed_table as jst
from darwin_tpu.parallel.shard import make_mesh as jmake_mesh
from darwin_tpu.parallel.shard_index import dsoft_sharded as jdsoft_sharded
from darwin_tpu.parallel.shard_index import \
    shard_seed_table as jshard_seed_table
from darwin_tpu.pipeline.align import Aligner as JAligner
from darwin_tpu.utils.simulate import mutate_read
from darwin_tpu.utils.simulate import simulate_reads as jsimulate
from darwin_tpu_torch.config import Config
from darwin_tpu_torch.genome import GenomeStore, make_read
from darwin_tpu_torch.index.seed_table import SeedTable, build_seed_table
from darwin_tpu_torch.parallel.shard import Mesh
from darwin_tpu_torch.parallel.shard_index import PAD_HASH, dsoft_sharded, \
    shard_seed_table
from darwin_tpu_torch.pipeline.align import Aligner
from darwin_tpu_torch.seeding import dsoft
from darwin_tpu_torch.seeding.seeder import Seeder
from tests.conftest import random_codes

torch.set_num_threads(2)
ACGT = np.frombuffer(b"ACGT", np.uint8)
KEYS = ("hits_bin", "hits_off", "hits_pos", "anc_pos", "anc_off", "anc_bin")
COUNTS = ("n_hits", "n_anchors", "n_anchors_raw", "n_queried_buckets",
          "n_capped")


def cpu_mesh(n):
    return Mesh(("cpu",) * n)


def _np(res):
    return {k: np.asarray(v).astype(np.int64) for k, v in res.items()}


def assert_same_dsoft(got, want, counts=COUNTS):
    """Counts equal; hits and anchors equal over each row's valid prefix
    (positions compared as uint32 bits)."""
    got, want = _np(got), _np(want)
    for k in counts:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for row in range(len(got["n_hits"])):
        for k in KEYS:
            n = int(want["n_hits" if k.startswith("hits") else
                         "n_anchors"][row])
            np.testing.assert_array_equal(
                got[k][row, :n] & 0xFFFFFFFF, want[k][row, :n] & 0xFFFFFFFF,
                err_msg=f"{k} row {row}")


def _rows(rng, genome, B=8, L=2048):
    codes2 = np.zeros((B, L), np.uint8)
    lengths = np.zeros(B, np.int32)
    for b in range(B):
        ln = int(rng.integers(900, L))
        start = int(rng.integers(0, len(genome) - ln))
        codes2[b, :ln] = genome[start:start + ln]
        lengths[b] = ln
    return codes2, lengths


def _kw(cfg, L, max_occ, overlap=False):
    return dict(k=cfg.seed_size, w=cfg.minimizer_window,
                num_seeds=cfg.num_seeds, max_stride=cfg.max_stride,
                overlap=overlap, threshold=cfg.dsoft_threshold,
                bin_size=cfg.bin_size, max_occ=max_occ,
                mq_cap=dsoft.mq_cap_for(L - cfg.seed_size + 1, cfg.num_seeds,
                                        cfg.max_stride, overlap))


def _replicated(codes2, lengths, table, kw):
    c2, ln = torch.from_numpy(codes2), torch.from_numpy(lengths)
    ckw = {k: v for k, v in kw.items() if k not in ("threshold",
                                                     "bin_size")}
    hit_cap = max(int(dsoft.dsoft_count(c2, ln, table.sorted_hashes,
                                        **ckw).max()), 1)
    return dsoft.dsoft_device(c2, ln, table.sorted_hashes, table.positions,
                              a_cap=hit_cap, hit_cap=hit_cap, **kw)


def _sharded(codes2, lengths, table, n, kw):
    return dsoft_sharded(torch.from_numpy(codes2), torch.from_numpy(lengths),
                         shard_seed_table(table, cpu_mesh(n)), **kw)


@pytest.fixture(scope="module")
def repeats():
    """tests/test_shard_index.py's genome: two chromosomes over a 40 kbp
    core with 8 kbp of it repeated; its pairs table in both packages."""
    rng = np.random.default_rng(0)
    cfg = JConfig()
    cfg.num_seeds = 64
    core = random_codes(rng, 40000, n_prob=0)
    genome = np.concatenate([core, core[:8000],
                             random_codes(rng, 12000, n_prob=0)])
    bases = ACGT[genome]
    store = JG.GenomeStore()
    store.add_chromosome("c1", bases[:35000])
    store.add_chromosome("c2", bases[35000:])
    store.finalize()
    jt = jst.build_seed_table(store, cfg)
    meta = [jt.kmer_size, jt.minimizer_window, jt.ref_size,
            jt.kmer_max_occurence]
    table = SeedTable.from_numpy(np.asarray(jt.sorted_hashes),
                                 np.asarray(jt.positions), meta, "cpu")
    return rng, genome, cfg, jt, table


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dsoft_sharded_matches_replicated(repeats, n):
    rng, genome, cfg, jt, table = repeats
    codes2, lengths = _rows(np.random.default_rng(n), genome)
    kw = _kw(cfg, codes2.shape[1], table.kmer_max_occurence)
    want = _replicated(codes2, lengths, table, kw)
    got = _sharded(codes2, lengths, table, n, kw)
    assert_same_dsoft(got, want)
    assert int(want["n_anchors"].sum()) > 0
    # one row's flat need per shard is at most its need on one device
    assert (got["n_flat_raw"] <= want["n_flat_raw"]).all()
    if n == 1:
        np.testing.assert_array_equal(got["n_flat_raw"], want["n_flat_raw"])


def test_dsoft_sharded_matches_darwin_tpu(repeats):
    """darwin_tpu's dsoft_sharded on its 8-device CPU mesh (its test's
    inputs and a_cap) and the port's on a mesh of 8: the same valid hits,
    anchors and counts."""
    rng, genome, cfg, jt, table = repeats
    codes2, lengths = _rows(rng, genome)
    kw = _kw(cfg, codes2.shape[1], jt.kmer_max_occurence)
    mesh = jmake_mesh(8)
    want = jdsoft_sharded(mesh, codes2, lengths, jshard_seed_table(jt, mesh),
                          a_cap=2048, hit_cap=kw["mq_cap"] * kw["max_occ"],
                          **kw)
    got = _sharded(codes2, lengths, table, 8, kw)
    assert int(np.asarray(want["n_anchors_raw"]).max()) <= 2048
    assert_same_dsoft(got, want, COUNTS[:-1])
    assert int(np.asarray(want["n_hits"]).sum()) > 0


def test_shards_are_views_padded_last(repeats):
    """Rows in Npad / n blocks: views of the table where the shard's device
    is the table's, the last block padded with PAD_HASH, which sorts last
    in the table's int32."""
    *_, table = repeats
    N = table.num_seeds
    for n in (1, 2, 8):
        st = shard_seed_table(table, cpu_mesh(n))
        per = -(-N // n)
        assert [len(h) for h in st.hashes] == [per] * n
        assert torch.equal(torch.cat(st.hashes)[:N], table.sorted_hashes)
        assert torch.equal(torch.cat(st.positions)[:N], table.positions)
        assert (torch.cat(st.hashes)[N:] == PAD_HASH).all()
        assert int(table.sorted_hashes.max()) < PAD_HASH
        full = N // per
        assert st.resident_bytes()[:full] == [0] * full
        assert all(b == 8 * per for b in st.resident_bytes()[full:])


def _tandem_world():
    """A genome whose middle holds 30 copies of a 20 bp unit: the unit's
    minimizers have buckets of 30 positions, 20 apart, so a read over the
    repeat has hits with equal (bin, offset) in one bucket."""
    rng = np.random.default_rng(5)
    unit = rng.integers(0, 4, 20)
    genome = np.concatenate([rng.integers(0, 4, 10_000), np.tile(unit, 30),
                             rng.integers(0, 4, 10_000)]).astype(np.uint8)
    store = GenomeStore.from_numpy(["c"], [ACGT[genome]])
    cfg = Config()
    cfg.seed_size = 10
    table = build_seed_table(store, cfg, "cpu", method="host")
    codes2 = np.zeros((2, 2048), np.uint8)
    lengths = np.array([1600, 1500], np.int32)
    codes2[0, :1600] = genome[9_800:11_400]
    codes2[1, :1500] = genome[2_000:3_500]
    return genome, cfg, table, codes2, lengths


def _split_inside(table, s, m):
    """The table with filler rows that no query can hit (hash -1 first or
    4^k last), so that a mesh of 2 splits it m rows into the bucket that
    starts at row s."""
    N = table.num_seeds
    h, p = table.sorted_hashes, table.positions
    lead = N - 2 * (s + m)
    if lead > 0:
        h = torch.cat([h.new_full((lead,), -1), h])
        p = torch.cat([p.new_zeros(lead), p])
    else:
        h = torch.cat([h, h.new_full((-lead,), 1 << 2 * table.kmer_size)])
        p = torch.cat([p, p.new_zeros(-lead)])
    meta = [table.kmer_size, table.minimizer_window, table.ref_size,
            table.kmer_max_occurence]
    out = SeedTable.from_numpy(h.numpy(), p.numpy(), meta, "cpu")
    assert -(-out.num_seeds // 2) == s + max(lead, 0) + m
    return out


def test_bucket_across_a_shard_boundary():
    """A bucket of the tandem repeat split between two shards where two of
    its hits tie in (bin, offset) across the split: the sharded hits, ties in
    insertion order, equal the replicated ones."""
    genome, cfg, table, codes2, lengths = _tandem_world()
    kw = _kw(cfg, codes2.shape[1], 50)
    want = _np(_replicated(codes2, lengths, table, kw))
    nh = int(want["n_hits"][0])
    hb, ho, hp = (want[k][0, :nh] for k in ("hits_bin", "hits_off",
                                            "hits_pos"))
    hashes = table.sorted_hashes.numpy()
    pos = table.positions.numpy().astype(np.int64)
    found = None
    for i in range(nh - 1):
        if (hb[i], ho[i]) != (hb[i + 1], ho[i + 1]):
            continue
        # two hits of one bucket in one bin: split the bucket between them
        a = int(np.flatnonzero(pos == hp[i])[0])
        b = int(np.flatnonzero(pos == hp[i + 1])[0])
        s = int(np.searchsorted(hashes, hashes[a]))
        if b == a + 1 and hashes[a] == hashes[b] and b - s >= 1:
            found = (s, b - s)
            break
    assert found is not None, "no tie across neighbouring bucket rows"
    split = _split_inside(table, *found)
    got = _sharded(codes2, lengths, split, 2, kw)
    assert_same_dsoft(got, want)
    assert_same_dsoft(_replicated(codes2, lengths, split, kw), want)


def test_bucket_capped_by_its_global_count_only():
    """max_occ 20 and a bucket of 21-40 positions split in halves: each
    shard's slice is under the cap, the bucket is not, so the sharded
    D-SOFT skips it as the replicated one does."""
    genome, cfg, table, codes2, lengths = _tandem_world()
    hashes = table.sorted_hashes.numpy()
    uniq, first, cnt = np.unique(hashes, return_index=True,
                                 return_counts=True)
    offs, qhash, ok = dsoft._queried_minimizers(
        torch.from_numpy(codes2), torch.from_numpy(lengths), cfg.seed_size,
        cfg.minimizer_window, cfg.num_seeds, cfg.max_stride, False, 1600)
    queried = set(qhash[0][ok[0]].tolist())
    big = [(int(f), int(c)) for u, f, c in zip(uniq, first, cnt)
           if 20 < c <= 40 and int(u) in queried]
    assert big
    s, c = big[0]
    split = _split_inside(table, s, c // 2)
    kw = _kw(cfg, codes2.shape[1], 20)
    want = _replicated(codes2, lengths, table, kw)
    assert int(want["n_capped"][0]) > 0
    got = _sharded(codes2, lengths, split, 2, kw)
    assert_same_dsoft(got, want)
    # the cap is what skips it: at 50 the same rows keep more hits
    loose = _replicated(codes2, lengths, table, _kw(cfg, 2048, 50))
    assert int(loose["n_hits"][0]) > int(want["n_hits"][0])


def test_dsoft_sharded_past_2_31(repeats):
    """A table whose positions lie past 2^31 (SeedTable.from_numpy, as
    tests/test_torch_index_scale.py builds it): sharded and replicated
    hits agree and keep the high positions."""
    rng, genome, cfg, jt, _ = repeats
    shift = (1 << 31) + 123_457
    pos = (np.asarray(jt.positions).astype(np.int64) + shift).astype(
        np.uint32)
    meta = [jt.kmer_size, jt.minimizer_window, (1 << 32) - 256,
            jt.kmer_max_occurence]
    table = SeedTable.from_numpy(np.asarray(jt.sorted_hashes), pos, meta,
                                 "cpu")
    codes2, lengths = _rows(rng, genome)
    kw = _kw(cfg, codes2.shape[1], jt.kmer_max_occurence)
    want = _replicated(codes2, lengths, table, kw)
    got = _sharded(codes2, lengths, table, 4, kw)
    assert_same_dsoft(got, want)
    nh = int(got["n_hits"][0])
    assert nh > 0 and int(got["hits_pos"][0, :nh].min()) >= 1 << 31


def test_refusals(repeats):
    *_, cfg, jt, table = repeats
    csr = SeedTable.from_numpy(None, np.zeros(4, np.uint32),
                               [10, 3, 100, 50], "cpu",
                               np.zeros(4 ** 10 + 1, np.int32))
    with pytest.raises(ValueError, match="pairs"):
        Seeder(csr, Config(), mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="power of two"):
        shard_seed_table(table, cpu_mesh(3))
    # no silent CPU: a mesh of cards on a host without one raises
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Mesh(("cuda:0", "cuda:0"))


def test_seeder_on_a_sharded_repeat_table_matches_darwin_tpu():
    """Seeder(mesh=) on a genome with a 1.5 kbp segment in 6 copies, whose
    buckets pass a cap of 4, against darwin_tpu's Seeder(mesh=
    make_mesh(8)): the same chained anchors and bucket counts."""
    from darwin_tpu.seeding.seeder import Seeder as JSeeder
    rng = np.random.default_rng(21)
    seg = rng.integers(0, 4, 1500)
    parts = [rng.integers(0, 4, 4000)]
    for _ in range(6):
        parts += [seg, rng.integers(0, 4, 4000)]
    bases = ACGT[np.concatenate(parts)]
    store = JG.GenomeStore()
    store.add_chromosome("rep", bases)
    store.finalize()
    jcfg, cfg = JConfig(), Config()
    jcfg.seed_size = cfg.seed_size = 12
    jcfg.max_bucket_occupancy = cfg.max_bucket_occupancy = 4
    jt = jst.build_seed_table(store, jcfg, method="host")
    meta = [jt.kmer_size, jt.minimizer_window, jt.ref_size,
            jt.kmer_max_occurence]
    table = SeedTable.from_numpy(np.asarray(jt.sorted_hashes),
                                 np.asarray(jt.positions), meta, "cpu")
    reads = []
    for i in range(6):
        st = int(rng.integers(0, len(bases) - 3000))
        reads.append((f"r{i}", mutate_read(rng, bases[st:st + 2500])))
    want = JSeeder(jt, jcfg, mesh=jmake_mesh(8)).seed_batch(
        [JG.make_read(n, s) for n, s in reads])
    got = Seeder(table, cfg, mesh=cpu_mesh(8)).seed_batch(
        [make_read(n, s) for n, s in reads])
    assert got.n_capped_buckets == want.n_capped_buckets > 0
    assert got.n_queried_buckets == want.n_queried_buckets
    for gs, ws in ((got.fw_anchors, want.fw_anchors),
                   (got.rc_anchors, want.rc_anchors)):
        for g, w in zip(gs, ws):
            assert [(a.hit, a.offset, a.num_chained_hits, a.anchor_score)
                    for a in g] == [(a.hit, a.offset, a.num_chained_hits,
                                     a.anchor_score) for a in w]
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a.left_chained,
                                              b.left_chained)
                np.testing.assert_array_equal(a.right_chained,
                                              b.right_chained)


def test_pipeline_with_shard_index_matches_darwin_tpu():
    """tests/test_shard_index.py's pipeline case: Aligner(mesh of 8,
    shard_index=True).align_batch prints darwin_tpu's sharded-index lines
    (one tile a round: the chains are test_torch_mesh.py's)."""
    rng = np.random.default_rng(0)
    cfg, jcfg = Config(), JConfig()
    for c in (cfg, jcfg):
        c.seed_size = 10
        c.dsoft_threshold = 20
        c.min_overlap = 400
    bases = ACGT[random_codes(rng, 15000, n_prob=0)]
    jstore = JG.GenomeStore()
    jstore.add_chromosome("chrA", bases)
    jstore.finalize()
    sim = jsimulate(jstore, 6, 1500, seed=4)
    want = JAligner(jcfg, jstore, mesh=jmake_mesh(8),
                    shard_index=True).align_batch(
        [JG.make_read(n, s) for n, s, _ in sim])
    store = GenomeStore.from_numpy(["chrA"], [bases])
    got = Aligner(cfg, store, device="cpu", mesh=cpu_mesh(8),
                  shard_index=True, spec_k=1).align_batch(
        [make_read(n, s) for n, s, _ in sim])
    assert got == want
    assert len(got) >= 4
