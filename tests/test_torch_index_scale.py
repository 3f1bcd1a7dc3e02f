"""The index at genome scale in darwin_tpu_torch, against darwin_tpu on the
CPU: the seeder on tables whose positions lie past 2^31 in both layouts,
csr caches crossing between the packages both ways, ``run()`` and the
CLI with ``--index-layout``, and overlap mode's read index from one
work-list scan.  Tolerance: none — integer arrays are equal, SAM bytes
and the counter block identical."""

import io

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from darwin_tpu import genome as JG
from darwin_tpu.config import Config as JConfig
from darwin_tpu.genome import make_read as jmake_read
from darwin_tpu.index import seed_table as jst
from darwin_tpu.pipeline.align import run as jax_run
from darwin_tpu.seeding import dsoft as jds
from darwin_tpu.utils.simulate import mutate_read
from darwin_tpu_torch import cli
from darwin_tpu_torch.config import Config
from darwin_tpu_torch.genome import GenomeStore, reads_from_numpy
from darwin_tpu_torch.index import minimizers, seed_table
from darwin_tpu_torch.pipeline.align import run
from darwin_tpu_torch.seeding import dsoft

torch.set_num_threads(2)
ACGT = np.frombuffer(b"ACGT", np.uint8)


# ------------------------------------------- the seeding seam past 2^31

@pytest.mark.parametrize("layout", ["pairs", "csr"])
def test_dsoft_on_positions_past_2_31(layout):
    """A table whose positions lie between 2^31 and 2^32 (a genome's far
    chromosomes) from from_numpy: the port's hits and anchors are
    darwin_tpu's, bit for bit."""
    rng = np.random.default_rng(31)
    genome = ACGT[rng.integers(0, 4, 60_000)]
    store = JG.GenomeStore()
    store.add_chromosome("c", genome)
    store.finalize()
    cfg = JConfig()
    cfg.seed_size = 10
    jt = jst.build_seed_table(store, cfg, layout=layout)
    shift = (1 << 31) + 123_457
    pos = (np.asarray(jt.positions).astype(np.int64) + shift).astype(
        np.uint32)
    assert pos.min() >= 1 << 31
    offsets = None if jt.bucket_offsets is None else np.asarray(
        jt.bucket_offsets)
    hashes = None if jt.sorted_hashes is None else np.asarray(
        jt.sorted_hashes)
    meta = [jt.kmer_size, jt.minimizer_window, (1 << 32) - 256,
            jt.kmer_max_occurence]
    table = seed_table.SeedTable.from_numpy(hashes, pos, meta, "cpu",
                                            offsets)
    assert int(minimizers.widen(table.positions).min()) >= 1 << 31
    B, L = 8, 2048
    codes2 = np.zeros((B, L), np.uint8)
    lengths = np.zeros(B, np.int32)
    for b in range(B):
        st = int(rng.integers(0, len(genome) - 2000))
        read = mutate_read(rng, genome[st:st + 1800])
        codes2[b, :len(read)] = JG.encode2(read)
        lengths[b] = len(read)
    mq_cap = jds.mq_cap_for(L - cfg.seed_size + 1, cfg.num_seeds,
                            cfg.max_stride, False)
    kw = dict(k=cfg.seed_size, w=cfg.minimizer_window,
              num_seeds=cfg.num_seeds, max_stride=cfg.max_stride,
              overlap=False, max_occ=jt.kmer_max_occurence, mq_cap=mq_cap)
    jin = (jnp.asarray(codes2), jnp.asarray(lengths))
    jtab = dict(bucket_offsets=jt.bucket_offsets)
    need = jds.dsoft_count(*jin, jt.sorted_hashes, **kw, **jtab)
    c2, ln = torch.from_numpy(codes2), torch.from_numpy(lengths)
    ptab = dict(bucket_offsets=table.bucket_offsets)
    got_need = dsoft.dsoft_count(c2, ln, table.sorted_hashes, **kw, **ptab)
    np.testing.assert_array_equal(got_need.numpy(), np.asarray(need))
    hit_cap = int(np.asarray(need).max())
    kw.update(threshold=cfg.dsoft_threshold, bin_size=cfg.bin_size,
              a_cap=hit_cap, hit_cap=hit_cap)
    want = jds.dsoft_device(*jin, jt.sorted_hashes, jnp.asarray(pos), **kw,
                            **jtab)
    got = dsoft.dsoft_device(c2, ln, table.sorted_hashes, table.positions,
                             **kw, **ptab)
    want = {k: np.asarray(v).astype(np.int64) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    for k in ("n_hits", "n_anchors", "n_queried_buckets", "n_flat_raw"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["n_anchors"].min() > 0
    for row in range(B):
        nh, na = int(got["n_hits"][row]), int(got["n_anchors"][row])
        for k in ("hits_bin", "hits_off", "hits_pos", "anc_pos", "anc_off",
                  "anc_bin"):
            n = nh if k.startswith("hits") else na
            # darwin_tpu's int32 anchor positions hold the uint32 bits
            np.testing.assert_array_equal(
                got[k][row, :n] & 0xFFFFFFFF, want[k][row, :n] & 0xFFFFFFFF,
                err_msg=k)
        assert got["hits_pos"][row, :nh].min() >= 1 << 31


# ------------------------------------------ caches, run() and the CLI

def _tiny(cls):
    """tests/test_torch_spec.py's small tiles and a 10-mer index (csr's
    offsets at k = 10 are 4 MB)."""
    cfg = cls()
    cfg.seed_size = 10
    cfg.tile_size = 64
    cfg.tile_overlap = 16
    cfg.first_tile_size = 32
    cfg.first_tile_score_threshold = 20
    return cfg


PARAMS_CFG = ("[DSOFT_params]\nseed_size = 10\n"
              "[GACT_extend]\ntile_size = 64\ntile_overlap = 16\n"
              "[GACT_first_tile]\nfirst_tile_size = 32\n"
              "first_tile_score_threshold = 20\n")


def _block(err):
    return [ln for ln in err.splitlines() if ln.startswith("#")]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A 20 kb two-chromosome genome and 3 mutated 800 bp reads as files;
    darwin_tpu's run with a csr index it writes to ``jcsr.npz``: its SAM
    and counter block."""
    tmp = tmp_path_factory.mktemp("torch_index_scale")
    rng = np.random.default_rng(4)
    genome = ACGT[rng.integers(0, 4, 20_000)]
    with open(tmp / "ref.fa", "w") as f:
        f.write(">chr1\n" + genome[:12_000].tobytes().decode() + "\n")
        f.write(">chr2\n" + genome[12_000:].tobytes().decode() + "\n")
    with open(tmp / "reads.fa", "w") as f:
        for i, start in enumerate((1000, 9000, 14_000)):
            seq = mutate_read(rng, genome[start:start + 800], 0.03, 0.01,
                              0.01)
            if i == 1:
                seq = JG.revcomp_bytes(seq)
            f.write(f">read{i}\n{seq.tobytes().decode()}\n")
    out, err = io.StringIO(), io.StringIO()
    jax_run(str(tmp / "ref.fa"), str(tmp / "reads.fa"), False,
            cfg=_tiny(JConfig), out=out, err=err,
            index_cache=str(tmp / "jcsr.npz"), index_layout="csr")
    assert "Seed table saved" in err.getvalue()
    return tmp, out.getvalue(), _block(err.getvalue())


def _run(tmp, **kw):
    out, err = io.StringIO(), io.StringIO()
    run(str(tmp / "ref.fa"), str(tmp / "reads.fa"), False, cfg=_tiny(Config),
        out=out, err=err, device="cpu", spec_k=1, pipeline_depth=1, **kw)
    return out.getvalue(), err.getvalue()


def test_csr_caches_cross_between_the_packages(tiny):
    """darwin_tpu's csr cache loads into the port and gives darwin_tpu's
    SAM and counters; the port's csr cache loads into darwin_tpu with
    equal arrays; a cache of the other layout is rebuilt when a layout is
    asked for, and taken as it is when none is."""
    tmp, sam, block = tiny
    jcsr = jst.SeedTable.load(str(tmp / "jcsr.npz"))
    assert jcsr.bucket_offsets is not None
    loaded = seed_table.SeedTable.load(str(tmp / "jcsr.npz"), "cpu")
    assert loaded.layout == "csr" and loaded.sorted_hashes is None
    np.testing.assert_array_equal(loaded.bucket_offsets.numpy(),
                                  np.asarray(jcsr.bucket_offsets))
    for layout in (None, "csr"):
        out, err = _run(tmp, index_cache=str(tmp / "jcsr.npz"),
                        index_layout=layout)
        assert out == sam and _block(err) == block
        assert "rebuilding" not in err and "saved" not in err

    # a forced pairs layout rebuilds the csr cache, and says so
    pairs_path = tmp / "pairs.npz"
    pairs_path.write_bytes((tmp / "jcsr.npz").read_bytes())
    out, err = _run(tmp, index_cache=str(pairs_path), index_layout="pairs")
    assert out == sam and _block(err) == block
    assert "does not match the reference/config; rebuilding" in err
    assert f"Seed table saved to {pairs_path}" in err
    jpairs = jst.SeedTable.load(str(pairs_path))
    assert jpairs.bucket_offsets is None
    store = JG.GenomeStore()
    for i, seq in enumerate(_fasta(tmp / "ref.fa")):
        store.add_chromosome(f"chr{i + 1}", seq)
    store.finalize()
    want = jst.build_seed_table(store, _tiny(JConfig), method="host")
    for name in ("sorted_hashes", "positions"):
        np.testing.assert_array_equal(np.asarray(getattr(jpairs, name)),
                                      np.asarray(getattr(want, name)))
    # ... and a forced csr layout rebuilds the pairs cache: the port's csr
    # .npz then loads into darwin_tpu with darwin_tpu's arrays
    out, err = _run(tmp, index_cache=str(pairs_path), index_layout="csr")
    assert out == sam and "rebuilding" in err
    back = jst.SeedTable.load(str(pairs_path))
    np.testing.assert_array_equal(np.asarray(back.bucket_offsets),
                                  np.asarray(jcsr.bucket_offsets))
    np.testing.assert_array_equal(np.asarray(back.positions),
                                  np.asarray(jcsr.positions))
    assert (back.kmer_size, back.ref_size, back.kmer_max_occurence) == (
        jcsr.kmer_size, jcsr.ref_size, jcsr.kmer_max_occurence)


def _fasta(path):
    return [np.frombuffer(ln.encode(), np.uint8) for ln in
            path.read_text().splitlines() if not ln.startswith(">")]


def test_cli_index_layouts_give_the_same_sam(tiny, capsys, monkeypatch):
    tmp, sam, block = tiny
    monkeypatch.chdir(tmp)
    (tmp / "params.cfg").write_text(PARAMS_CFG)
    try:
        outs = {}
        for layout in ("pairs", "csr"):
            stats = {}
            assert cli.main(["ref.fa", "reads.fa", "0", "--device=cpu",
                             f"--index-layout={layout}"], spec_k=1,
                            pipeline_depth=1, stats_out=stats) == 0
            got = capsys.readouterr()
            outs[layout] = (got.out, _block(got.err))
            assert stats["index_build"]["layout"] == layout
        assert cli.main(["ref.fa", "reads.fa", "0", "--device=cpu",
                         "--index-layout=flat"]) == 1
        assert "unknown index layout 'flat'" in capsys.readouterr().err
    finally:
        (tmp / "params.cfg").unlink()
    assert outs["pairs"] == outs["csr"] == (sam, block)
    assert "--index-layout=pairs|csr" in cli.USAGE


# --------------------------------------- overlap mode's read index

@pytest.mark.parametrize("layout", ["pairs", "csr"])
def test_read_index_is_one_work_list(layout, monkeypatch):
    """40 reads (some shorter than k + w) become one device batch: one
    scan call, no per-read device call or host sync, and darwin_tpu's
    table."""
    rng = np.random.default_rng(40)
    lens = [int(x) for x in rng.integers(1000, 3500, 37)] + [5, 12, 300]
    names = [f"r{i}" for i in range(len(lens))]
    seqs = [ACGT[rng.integers(0, 4, n)] for n in lens]
    jcfg, cfg = JConfig(), Config()
    jcfg.seed_size = cfg.seed_size = 10
    jcfg.do_overlap = cfg.do_overlap = True
    want, _ = jst.build_read_seed_table(
        [jmake_read(n, s) for n, s in zip(names, seqs)], jcfg, layout=layout)
    calls = []
    real = minimizers._scan_rows

    def counted(rows, *a, **kw):
        calls.append(rows.shape[0])
        return real(rows, *a, **kw)

    monkeypatch.setattr(minimizers, "_scan_rows", counted)
    got, store = seed_table.build_read_seed_table(
        reads_from_numpy(names, seqs), cfg, "cpu", layout=layout)
    assert isinstance(store, GenomeStore)
    passes = 2 if layout == "csr" else 1         # csr: count, then fill
    assert calls == [len(lens)] * passes
    stats = got.build_stats
    assert (stats["batches"], stats["rows"]) == (1, len(lens))
    assert stats["sequences_per_batch"] == len(lens)
    if layout == "csr":
        np.testing.assert_array_equal(got.bucket_offsets.numpy(),
                                      np.asarray(want.bucket_offsets))
    else:
        np.testing.assert_array_equal(
            got.sorted_hashes.numpy().view(np.uint32),
            np.asarray(want.sorted_hashes))
    np.testing.assert_array_equal(got.positions.numpy().view(np.uint32),
                                  np.asarray(want.positions))


def test_gate_counts_scanned_positions_of_short_reads(monkeypatch):
    """Many short reads: every read scans a whole row, so the gate between
    the all-candidates and the streaming build must price rows, not bases.
    With the free memory between the two reckonings the automatic method
    streams; with room for the rows it takes the all-candidates build; both
    give darwin_tpu's table."""
    monkeypatch.setattr(minimizers, "CHUNK", 1024)
    monkeypatch.setattr(minimizers, "ROWS", 64)
    rng = np.random.default_rng(41)
    lens = [int(x) for x in rng.integers(100, 160, 300)]
    names = [f"r{i}" for i in range(len(lens))]
    seqs = [ACGT[rng.integers(0, 4, n)] for n in lens]
    jcfg, cfg = JConfig(), Config()
    jcfg.seed_size = cfg.seed_size = 10
    want, _ = jst.build_read_seed_table(
        [jmake_read(n, s) for n, s in zip(names, seqs)], jcfg)
    k, w = cfg.seed_size, cfg.minimizer_window
    need = minimizers.device_build_bytes(lens, k, w)
    bases = sum((n + 15) // 16 * 16 for n in lens)
    # a row per read: the rows scan over six times the bases
    assert need > 6 * minimizers.DEVICE_BYTES_PER_POSITION * bases
    for free, method in ((need / 0.9 - 1, "stream"),
                         (need / 0.9 + 1, "device")):
        monkeypatch.setattr(seed_table, "_free_bytes", lambda dev: free)
        got, _ = seed_table.build_read_seed_table(
            reads_from_numpy(names, seqs), cfg, "cpu")
        assert got.build_stats["method"] == method
        np.testing.assert_array_equal(
            got.sorted_hashes.numpy().view(np.uint32),
            np.asarray(want.sorted_hashes))
        np.testing.assert_array_equal(got.positions.numpy().view(np.uint32),
                                      np.asarray(want.positions))
