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
    """run()'s stage telemetry (what tools/profile_align reads) sees every
    stage of the main path with three read batches, two of them in flight
    on speculative chains of 4, and changes no output; the first batch's
    stages and the rest's add up to the totals; under the profiler (the
    run tools/profile_align profiles) the collector's time comes from
    run()'s spans, and gc.callbacks is put back."""
    from torch.profiler import ProfilerActivity, profile
    from darwin_tpu_torch.tools import profile_align as pa
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
    row = pa.run_row(stats, 13)
    assert row["stages_s"][pa.GC_STAGE] >= 0  # the collector need not run
    assert (row["spec_hits"], row["spec_misses"], row["extend_rounds"]) == (
        c["num_spec_hits"], c["num_spec_misses"], c["num_extend_rounds"])
    assert list(row["stages_s"].values()) == sorted(
        row["stages_s"].values(), reverse=True)


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


def test_profile_groups_itemize_the_device_time():
    """tools/profile_align's groups: each kernel of the package by its
    name, copies and memsets by the profiler's names, the rest "other",
    largest first."""
    from types import SimpleNamespace as NS
    from darwin_tpu_torch.tools.profile_align import by_group, group_of
    assert group_of("void (anonymous namespace)::gact_next_kernel(int)") \
        == "gact_next"
    assert group_of("Memcpy DtoH (Device -> Pageable)") == "copies"
    assert group_of("Memset (Device)") == "memsets"
    assert group_of("void at::native::index_elementwise_kernel<128>") \
        == "other"
    rows = [NS(key="gact_dp_kernel<6, true>", count=3,
               self_device_time_total=3000),
            NS(key="gact_dp_kernel<3, true>", count=1,
               self_device_time_total=500),
            NS(key="at::native::where_kernel", count=7,
               self_device_time_total=700),
            NS(key="at::native::clamp_kernel", count=2,
               self_device_time_total=200)]
    got = by_group(rows)
    assert got["gact_dp"] == {"self_ms": 3.5, "count": 4}
    assert got["other"] == {"self_ms": pytest.approx(0.9), "count": 9}
    assert got["gact_next"] == {"self_ms": 0.0, "count": 0}
    assert [o["name"] for o in got["other_top"]] == [
        "at::native::where_kernel", "at::native::clamp_kernel"]
