"""End to end: darwin_tpu_torch.pipeline.align.run on the CPU writes the
same SAM bytes and the same 7-line counter block as
darwin_tpu.pipeline.align.run, on a 200 kb two-chromosome genome with an
N run, reads on both strands from 800 bp to 5 kb, and one read across a
1.2 kb deletion (large-tile escalation); plus the CLI, and the same run
with a generic-scoring params.cfg (gap opens cheaper than gap extends)."""

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
        assert cli.main(["ref.fa", "reads.fa", "0", "--device=cpu"]) == 0
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
        assert cli.main(["ref.fa", "reads.fa", "0", "--device=cpu"]) == 0
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
    """tools/profile_align's stage timers see every stage of the main path,
    change no output, and put every wrapped function back."""
    from darwin_tpu_torch.tools import profile_align as pa
    tmp, sam, block = world
    import gc
    originals = [getattr(owner, attr) for _, owner, attr in pa.STAGES]
    callbacks = list(gc.callbacks)
    out, err = io.StringIO(), io.StringIO()
    with pa.stage_timers() as acc:
        run(str(tmp / "ref.fa"), str(tmp / "reads.fa"), False, cfg=_cfg(),
            out=out, err=err, device="cpu")
    assert out.getvalue() == sam
    assert _block(err.getvalue()) == block
    stages = {s for s, _, _ in pa.STAGES} | {pa.RESOLVE_STAGE}
    assert set(acc) == stages | {pa.GC_STAGE}
    assert all(acc[s] > 0 for s in stages), acc
    # the cyclic collector need not run at this size
    assert acc[pa.GC_STAGE] >= 0
    assert gc.callbacks == callbacks
    assert (acc["ext_native_decode"] <= acc["ext_decode_wave"]
            <= acc["extend_total"])
    assert [getattr(o, a) for _, o, a in pa.STAGES] == originals
    assert pa._align_s(err.getvalue()) >= 0


def test_profile_busy_time_is_the_union_of_device_intervals():
    from types import SimpleNamespace as NS
    from darwin_tpu_torch.tools.profile_align import _busy_ms
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    spans = [(cuda, 30, 40), (cuda, 0, 10), (cuda, 5, 20), (cuda, 8, 12),
             (cpu, 0, 1000)]
    events = [NS(device_type=d, time_range=NS(start=s, end=e))
              for d, s, e in spans]
    assert _busy_ms(events) == (20 + 10) / 1000
    assert _busy_ms([]) == 0.0
