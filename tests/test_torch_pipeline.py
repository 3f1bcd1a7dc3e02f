"""End to end: darwin_tpu_torch.pipeline.align.run on the CPU writes the
same SAM bytes and the same 7-line counter block as
darwin_tpu.pipeline.align.run, on a 200 kb two-chromosome genome with an
N run, reads on both strands from 800 bp to 5 kb, and one read across a
1.2 kb deletion (large-tile escalation), at run()'s defaults (speculative
chains of 12 tiles) and with three read batches, two in flight; plus the
CLI, and the same run with a generic-scoring params.cfg (gap opens cheaper
than gap extends).  The CLI cases run the non-speculative path, one batch
at a time (``spec_k=1, pipeline_depth=1``): the plain twins on the CPU pay
for every speculative level, and test_torch_spec.py covers the defaults'
combinations."""

import io

import numpy as np
import pytest
import torch

from darwin_tpu.config import Config as JConfig, load_config as jload_config
from darwin_tpu_torch import cli
from darwin_tpu_torch.config import Config
from darwin_tpu_torch.genome import GenomeStore
from darwin_tpu_torch.pipeline.align import run
from darwin_tpu_torch.utils.simulate import simulate_reads, write_fasta

torch.set_num_threads(2)


def _cfg(cls=Config):
    cfg = cls()
    cfg.seed_size = 10              # small-genome-friendly k (README)
    return cfg


GENERIC_CFG = ("[GACT_scoring]\ngap_open = -1\ngap_extend = -3\n"
               "long_gap_open = -2\nlong_gap_extend = -6\n"
               "[DSOFT_params]\nseed_size = 10\n")


# the non-speculative path, one batch at a time
K1 = {"spec_k": 1, "pipeline_depth": 1}


def _block(err: str):
    return [ln for ln in err.splitlines() if ln.startswith("#")]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_pipeline")
    rng = np.random.default_rng(7)
    g = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 200_000)]
    g[50_000:50_300] = ord("N")
    chroms = [("chr1", g[:120_000]), ("chr2", g[120_000:])]
    store = GenomeStore()
    for name, seq in chroms:
        store.add_chromosome(name, seq)
    store.finalize()
    with open(tmp / "ref.fa", "w") as f:
        for name, seq in chroms:
            f.write(f">{name}\n{seq.tobytes().decode()}\n")
    sim = simulate_reads(store, 12, 0, seed=3,
                         read_lens=rng.integers(800, 5001, 12))
    assert {t[2] for _, _, t in sim} == {"+", "-"}
    s0 = store.chromosomes[0].start + 20_000
    sv = np.concatenate([store.bases[s0:s0 + 2000],
                         store.bases[s0 + 3200:s0 + 5200]])
    sim.append(("sv_read", sv, ("chr1", 20_000, "+")))
    write_fasta(str(tmp / "reads.fa"), sim)

    from darwin_tpu.pipeline.align import run as jax_run
    out, err = io.StringIO(), io.StringIO()
    jax_run(str(tmp / "ref.fa"), str(tmp / "reads.fa"), False,
            cfg=_cfg(JConfig), out=out, err=err)
    return tmp, out.getvalue(), _block(err.getvalue())


def test_sam_and_counters_match_darwin_tpu(world):
    tmp, sam, block = world
    out, err = io.StringIO(), io.StringIO()
    run(str(tmp / "ref.fa"), str(tmp / "reads.fa"), False, cfg=_cfg(),
        out=out, err=err, device="cpu")
    assert sum(1 for ln in sam.splitlines() if not ln.startswith("@")) >= 10
    assert len(block) == 7
    assert int(block[-1].split(":")[1]) > 0        # #large tiles
    assert out.getvalue() == sam
    assert _block(err.getvalue()) == block


def test_cli_matches_darwin_tpu(world, capsys, monkeypatch):
    tmp, sam, block = world
    monkeypatch.chdir(tmp)
    (tmp / "params.cfg").write_text("[DSOFT_params]\nseed_size = 10\n")
    try:
        assert cli.main(["ref.fa", "reads.fa", "0", "--device=cpu"],
                        **K1) == 0
    finally:
        (tmp / "params.cfg").unlink()
    got = capsys.readouterr()
    assert got.out == sam
    assert _block(got.err) == block


def test_generic_scoring_cli_matches_darwin_tpu(world, capsys, monkeypatch):
    """A legal params.cfg whose gap opens are cheaper than its gap extends
    on both lanes: the DP takes the coupled recurrence, and SAM and the
    counter block still equal darwin_tpu's."""
    from darwin_tpu.pipeline.align import run as jax_run
    tmp, sam_default, _ = world
    monkeypatch.chdir(tmp)
    (tmp / "params.cfg").write_text(GENERIC_CFG)
    try:
        jcfg = jload_config("params.cfg")
        assert jcfg.gap_open > jcfg.gap_extend
        out, err = io.StringIO(), io.StringIO()
        jax_run("ref.fa", "reads.fa", False, cfg=jcfg, out=out, err=err)
        assert cli.main(["ref.fa", "reads.fa", "0", "--device=cpu"],
                        **K1) == 0
    finally:
        (tmp / "params.cfg").unlink()
    got = capsys.readouterr()
    assert sum(1 for ln in got.out.splitlines()
               if not ln.startswith("@")) >= 10
    assert got.out == out.getvalue()
    assert got.out != sam_default            # the scoring changes CIGARs
    assert _block(got.err) == _block(err.getvalue())


def test_cli_refuses_what_it_cannot_do(world, capsys):
    tmp, _, _ = world
    ref, reads = str(tmp / "ref.fa"), str(tmp / "reads.fa")
    assert cli.main([ref, reads, "2", "--device=cpu"]) == 1   # 0 or 1 only
    assert cli.main([ref, reads]) == 1                        # usage
    assert cli.main([ref, reads, "0", "--bogus"]) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main([ref, reads, "0"])                # cuda is the default


def test_profile_stage_timers_cover_the_path(world):
    """run()'s stage telemetry sees every stage of the main path with three
    read batches, two of them in flight on speculative chains of 4, and
    changes no output; the first batch's stages and the rest's add up to
    the totals; under the profiler (as in the benchmark's traced run) the
    collector's time comes from run()'s spans, and gc.callbacks is put
    back."""
    from torch.profiler import ProfilerActivity, profile
    tmp, sam, block = world
    import gc
    callbacks = list(gc.callbacks)
    out, err = io.StringIO(), io.StringIO()
    stats = {}
    with profile(activities=[ProfilerActivity.CPU]):
        run(str(tmp / "ref.fa"), str(tmp / "reads.fa"), False, cfg=_cfg(),
            out=out, err=err, device="cpu", reads_per_batch=5,
            pipeline_depth=2, spec_k=4, stats_out=stats)
    assert out.getvalue() == sam
    assert _block(err.getvalue()) == block
    assert gc.callbacks == callbacks
    total = stats["stage_seconds"]
    assert set(total) == {
        "read_upload", "ru_qbuild", "ru_enqueue", "seed", "seed_dispatch",
        "seed_fetch", "seed_chain", "filter", "filter_build",
        "filter_fetch", "filter_collect", "extend", "extend_req",
        "extend_pack", "extend_enqueue", "extend_dispatch", "extend_fetch",
        "extend_decode", "print", "print_select", "print_format"}
    assert all(v > 0 for v in total.values()), total
    for k, v in total.items():
        assert stats["stage_seconds_cold"][k] + \
            stats["stage_seconds_warm"][k] == pytest.approx(v, abs=1e-9)
    c = stats["counters"]
    assert c["num_reads"] == 13 and c["num_spec_hits"] > 0
    # the collector need not run; its passes are ``gc`` spans
    assert all(e >= s for k, _, _, s, e in stats["spans"]["spans"]
               if k == "gc")
