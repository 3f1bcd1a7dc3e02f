"""darwin_tpu_torch's meshes (parallel/shard.py) on the CPU, where a mesh
names the one CPU device n times (darwin_tpu's tests run on 8 virtual CPU
devices): the MeshDispatcher's dispatches against the one-device ones at
n = 1, 2, 3 and 8 (uneven and empty shards) and on large tiles of both
orientations, the Aligner on a mesh of 8 against darwin_tpu's Aligner on
its mesh of 8 at the default and a generic scoring, run() on a mesh
against mesh='off' in both modes at depth 1 and 2 and spec_k 1 and 12,
and the rules of _resolve_mesh.  Tolerance: none — arrays equal, SAM /
MHAP bytes and the counter block identical."""

import io

import numpy as np
import pytest
import torch

from darwin_tpu import genome as JG
from darwin_tpu.config import Config as JConfig
from darwin_tpu.parallel.shard import make_mesh as jmake_mesh
from darwin_tpu.pipeline.align import Aligner as JAligner
from darwin_tpu.utils.simulate import simulate_reads as jsimulate
from darwin_tpu_torch import cli
from darwin_tpu_torch.config import Config
from darwin_tpu_torch.genome import GenomeStore, encode5, make_read
from darwin_tpu_torch.ops import dispatch, gact
from darwin_tpu_torch.parallel import shard
from darwin_tpu_torch.parallel.shard import Mesh, MeshDispatcher, make_mesh
from darwin_tpu_torch.pipeline import align
from darwin_tpu_torch.pipeline.align import Aligner, run
from darwin_tpu_torch.utils.simulate import simulate_reads, write_fasta

torch.set_num_threads(2)
ACGT = np.frombuffer(b"ACGT", np.uint8)
T = 64                  # tile side of the dispatcher cases


def cpu_mesh(n):
    return Mesh(("cpu",) * n)


def _requests(B, seed, rt=T, qt=T):
    """Genome and read-batch codes and B extension requests of rt x qt
    tiles (left and right, some clamped at a sequence end), as the
    extension manager builds them: columns r_start, r_size, q_start,
    q_size, rev, chrom_start, chrom_len, q_buf_start, q_len."""
    rng = np.random.default_rng(seed)
    store = GenomeStore.from_numpy(["c"], [ACGT[rng.integers(0, 4, 6000)]])
    chrom = store.chromosomes[0]
    ref = encode5(store.bases_with_margin(4 * Config().large_tile_long))
    margin = np.full(4 * T, ord("N"), np.uint8)
    parts, spans, pos = [], [], 0
    for s, n in ((0, 1500), (2000, 2500), (4200, 1800)):
        seq = store.bases[chrom.start + s:chrom.start + s + n].copy()
        sub = rng.random(n) < 0.04
        seq[sub] = ACGT[rng.integers(0, 4, sub.sum())]
        parts += [seq, margin]
        spans.append((s, pos, n))
        pos += n + len(margin)
    rows = []
    for b in range(B):
        s, qbuf, n = spans[b % 3]
        cq = int(rng.integers(0, n)) if b > 2 else (0, n - 1, n // 2)[b]
        cr = s + cq
        if b % 2:
            rows.append((chrom.start + cr, min(chrom.length - cr, rt),
                         qbuf + cq, min(n - cq, qt), 1))
        else:
            rows.append((chrom.start + max(cr - rt + 1, 0), min(cr + 1, rt),
                         qbuf + max(cq - qt + 1, 0), min(cq + 1, qt), 0))
        rows[-1] += (chrom.start, chrom.length, qbuf, n)
    cols = [np.array(c, np.int64) for c in zip(*rows)]
    return (torch.from_numpy(ref), torch.from_numpy(encode5(
        np.concatenate(parts))), cols)


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_mesh_dispatcher_matches_one_device(n):
    """first_tile_scores and extend_tiles_async at K = 1 and K = 3 split
    over n shards (13 lanes: uneven blocks; 3 lanes: empty shards at n =
    8) return what the one-device dispatches return, lane for lane; the
    speculative levels map lanes back to their shards in any order; an
    empty shard dispatches nothing."""
    params = gact.make_params(Config())
    K = 3
    for B in (13, 3):
        ref, query, cols = _requests(B, seed=B + n)
        md = MeshDispatcher(cpu_mesh(n))
        refr = md.replicate(ref)          # the query goes as a tensor
        assert md.cross_copies == 0 and refr.on(torch.device("cpu")) is ref

        want = dispatch.first_tile_scores(ref, query, *cols[:4], params,
                                          qt=T, rt=T)
        got = md.first_tile_scores(refr, query, *cols[:4], params, qt=T,
                                   rt=T)
        assert torch.equal(got["packed"], want["packed"])

        args = (*cols, params)
        kw = dict(qt=T, rt=T, max_tb=2 * T, stop_thr=T - 16)
        got = md.extend_tiles_async(refr, query, *args, K=1, **kw)()
        want = dispatch.extend_tiles_async(ref, query, *args, K=1, **kw)()
        assert got.pop("spec_req") == want.pop("spec_req") == []
        del got["ops_spec"], want["ops_spec"]
        _same(got, want)

        want = dispatch.extend_tiles_async(ref, query, *args, K=K, **kw)()
        got = md.extend_tiles_async(refr, query, *args, K=K, **kw)()
        spec = ("spec_req", "ops_spec")
        _same({k: v for k, v in got.items() if k not in spec},
              {k: v for k, v in want.items() if k not in spec})
        for j in range(K - 1):
            for f in range(4):
                np.testing.assert_array_equal(got["spec_req"][j][f],
                                              want["spec_req"][j][f])
            lanes = np.random.default_rng(j).permutation(B)[:max(B - 2, 1)]
            for sel in (np.arange(B), lanes):
                for a, b in zip(got["ops_spec"].take(j, sel),
                                want["ops_spec"].take(j, sel)):
                    np.testing.assert_array_equal(a, b)
        assert (want["n_ops"] > 0).all()
        # 3 dispatches' lanes, blocks of tensor_split
        sizes = [len(x) for x in np.array_split(np.arange(B), n)]
        assert md.lanes == [3 * s for s in sizes]


@pytest.mark.parametrize("rt,qt", [(1984, 960), (960, 1984)])
def test_mesh_large_tiles_match_one_device(rt, qt):
    """A chain of one large tile, either orientation, split over 3 uneven
    shards (5 lanes) returns what the one-device dispatch returns."""
    params = gact.make_params(Config())
    ref, query, cols = _requests(5, seed=rt, rt=rt, qt=qt)
    md = MeshDispatcher(cpu_mesh(3))
    kw = dict(qt=qt, rt=rt, max_tb=2 * Config().tile_size,
              stop_thr=min(rt, qt) - 128, K=1)
    got = md.extend_tiles_async(md.replicate(ref), query, *cols, params,
                                **kw)()
    want = dispatch.extend_tiles_async(ref, query, *cols, params, **kw)()
    assert got.pop("spec_req") == want.pop("spec_req") == []
    del got["ops_spec"], want["ops_spec"]
    _same(got, want)
    assert got["ops"].shape == (5, min(rt + qt, 4 * Config().tile_size))
    assert (want["n_ops"] > 0).all() and md.lanes == [2, 2, 1]


def _jstore(bases):
    st = JG.GenomeStore()
    st.add_chromosome("chrA", bases)
    st.finalize()
    return st


@pytest.mark.parametrize("scoring", ["default", "generic"])
def test_aligner_on_a_mesh_matches_darwin_tpu(scoring):
    """tests/test_mesh_pipeline.py's two cases: Aligner(mesh of 8)
    .align_batch prints darwin_tpu's Aligner(mesh=make_mesh(8)) lines, at
    the default scoring (15 kbp, 6 reads) and at gap opens cheaper than
    extends (12 kbp, 4 reads); chains of 4 (the CPU's twins pay for every
    level)."""
    rng = np.random.default_rng(0)
    cfg, jcfg = Config(), JConfig()
    for c in (cfg, jcfg):
        c.seed_size = 10
        c.dsoft_threshold = 20
        c.min_overlap = 400
        if scoring == "generic":
            c.gap_open, c.gap_extend = -1, -5
            c.long_gap_open, c.long_gap_extend = -3, -9
    size, n, ln, seed = ((15000, 6, 1500, 2) if scoring == "default"
                         else (12000, 4, 1200, 12))
    bases = rng.choice(list(b"ACGT"), size=size).astype(np.uint8)
    jstore = _jstore(bases)
    sim = jsimulate(jstore, n, ln, seed=seed)
    want = JAligner(jcfg, jstore, mesh=jmake_mesh(8)).align_batch(
        [JG.make_read(name, s) for name, s, _ in sim])
    store = GenomeStore.from_numpy(["chrA"], [bases])
    aligner = Aligner(cfg, store, device="cpu", mesh=cpu_mesh(8),
                      spec_k=4)
    got = aligner.align_batch([make_read(name, s) for name, s, _ in sim])
    assert got == want
    assert len(got) >= n // 2
    assert sum(aligner.mesh_dispatch.lanes) > 0


def _block(err):
    return [ln for ln in err.splitlines() if ln.startswith("#")]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_mesh_pipeline.py's run() case (a 12 kbp genome, 5 reads
    of 1.2 kb) and an overlap case (5 reads of 1 kb over 3 kbp), each run
    once with mesh='off'."""
    tmp = tmp_path_factory.mktemp("torch_mesh")
    rng = np.random.default_rng(0)
    bases = rng.choice(list(b"ACGT"), size=12000).astype(np.uint8)
    store = GenomeStore.from_numpy(["c1"], [bases])
    with open(tmp / "ref.fa", "w") as f:
        f.write(">c1\n" + bases.tobytes().decode() + "\n")
    write_fasta(str(tmp / "reads.fa"), simulate_reads(store, 5, 1200,
                                                      seed=3))
    small = GenomeStore.from_numpy(["o"], [bases[:3000]])
    write_fasta(str(tmp / "ovl.fa"), simulate_reads(small, 5, 1000, seed=4))
    cases = {False: (str(tmp / "ref.fa"), str(tmp / "reads.fa")),
             True: (str(tmp / "ovl.fa"), str(tmp / "ovl.fa"))}
    off = {ovl: _run(*paths, ovl, mesh="off", spec_k=1, pipeline_depth=1)
           for ovl, paths in cases.items()}
    return cases, off


def _cfg():
    """tests/test_torch_spec.py's small tiles: the CPU's twins pay per
    tile side squared for every level of every shard."""
    cfg = Config()
    cfg.seed_size = 10
    cfg.dsoft_threshold = 20
    cfg.min_overlap = 400
    cfg.tile_size = 64
    cfg.tile_overlap = 16
    cfg.first_tile_size = 32
    cfg.first_tile_score_threshold = 20
    return cfg


PARAMS_CFG = ("[DSOFT_params]\nseed_size = 10\nthreshold = 20\n"
              "[GACT_extend]\ntile_size = 64\ntile_overlap = 16\n"
              "[GACT_first_tile]\nmin_overlap = 400\nfirst_tile_size = 32\n"
              "first_tile_score_threshold = 20\n")


def _run(ref, reads, overlap, **kw):
    out, err = io.StringIO(), io.StringIO()
    stats = {}
    run(ref, reads, overlap, cfg=_cfg(), out=out, err=err, device="cpu",
        reads_per_batch=2, stats_out=stats, **kw)
    return out.getvalue(), _block(err.getvalue()), err.getvalue(), stats


@pytest.mark.parametrize("overlap,depth,spec_k,n", [
    (False, 1, 1, 8), (False, 2, 12, 8), (True, 2, 1, 3), (True, 1, 12, 2)])
def test_run_on_a_mesh_matches_mesh_off(world, overlap, depth, spec_k, n):
    """run(mesh=n) against mesh='off' (three read batches, two in flight
    at depth 2; 64-base tiles, large tiles in overlap mode), in both
    modes, at depth 1 and 2 and chains of 1 and 12: the same output and
    counter block; the mesh line sits under the package's prefix, outside
    the counter block."""
    cases, off = world
    out, blk, err, stats = _run(*cases[overlap], overlap, mesh=n,
                                spec_k=spec_k, pipeline_depth=depth)
    want_out, want_blk, *_ = off[overlap]
    assert out == want_out
    assert blk == want_blk and len(blk) == 7
    if overlap:
        assert int(blk[-1].split(":")[1]) > 0          # #large tiles
    assert f"[darwin_tpu_torch] mesh: {n} devices\n" in err
    assert "mesh" not in "".join(blk)
    records = [ln for ln in out.splitlines() if not ln.startswith("@")]
    assert len(records) >= 4
    m = stats["mesh"]
    assert m["devices"] == ["cpu"] * n and m["cross_copies"] == 0
    assert sum(m["lanes"]) > 0


def test_resolve_mesh_rules(monkeypatch):
    """None / 'auto' mesh the cards when there is more than one (the
    power-of-two floor of their count) and never the CPU; 'off', 0 and 1
    give one device; N builds N devices of the run's type; a Mesh is used
    as given; a mesh of cards that are not there raises."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    for m in (None, "auto", "off", 0, 1, "1"):
        assert align._resolve_mesh(m, cpu) is None
    assert align._resolve_mesh(8, cpu) == cpu_mesh(8)
    assert align._resolve_mesh("3", cpu) == cpu_mesh(3)
    given = cpu_mesh(2)
    assert align._resolve_mesh(given, cuda) is given
    built = []
    monkeypatch.setattr(align, "make_mesh",
                        lambda n, *a: built.append((n, *a)) or n)
    for count, want in ((0, None), (1, None), (2, 2), (3, 2), (6, 4),
                        (8, 8)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        assert align._resolve_mesh("auto", cuda) == want
        assert align._resolve_mesh(None, cuda) == want
        assert align._resolve_mesh("auto", cpu) is None
    assert align._resolve_mesh(4, cuda) == 4 and built[-1] == (4, "cuda")
    monkeypatch.undo()
    with pytest.raises(ValueError, match="needs 2 local CUDA"):
        make_mesh(2) if torch.cuda.device_count() < 2 else make_mesh(
            torch.cuda.device_count() + 1)
    assert make_mesh(3, "cpu") == cpu_mesh(3)
    with pytest.raises(ValueError):
        Mesh(())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            shard.Mesh(("cuda:0", "cuda:0"))


def test_cli_mesh_flags(world, capsys, monkeypatch, tmp_path):
    """--mesh=N and --shard-index on the CPU print mesh='off''s SAM and
    counter block; a mesh that is not auto, off or a count is refused."""
    cases, off = world
    ref, reads = cases[False]
    monkeypatch.chdir(tmp_path)
    (tmp_path / "params.cfg").write_text(PARAMS_CFG)
    assert cli.main([ref, reads, "0", "--device=cpu", "--mesh=2",
                     "--shard-index"], spec_k=1, pipeline_depth=1) == 0
    got = capsys.readouterr()
    assert got.out == off[False][0]
    assert _block(got.err) == off[False][1]
    assert "[darwin_tpu_torch] mesh: 2 devices (sharded index)" in got.err
    assert cli.main([ref, reads, "0", "--device=cpu", "--mesh=two"]) == 1
