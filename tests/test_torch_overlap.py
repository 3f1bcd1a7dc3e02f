"""Overlap (de-novo) mode of darwin_tpu_torch against darwin_tpu on the
same reads: the read seed table's arrays, the overlap anchors, the MHAP
printer, and ``run(reads, reads, True)`` end to end.  Tolerance: none —
arrays are equal and MHAP bytes and the counter block are identical.

The reads cross to the port as numpy arrays (names + ASCII sequences),
never as darwin_tpu objects.  The port runs its non-speculative path, one
batch at a time (``spec_k=1, pipeline_depth=1``): the plain twins on the
CPU pay for every speculative level, and test_torch_spec.py holds the
defaults to darwin_tpu."""

import io

import numpy as np
import pytest
import torch

from darwin_tpu.config import Config as JConfig
from darwin_tpu.genome import make_read as jmake_read
from darwin_tpu.index import seed_table as jst
from darwin_tpu.pipeline import printer as jprinter
from darwin_tpu.pipeline.align import run as jax_run
from darwin_tpu.pipeline.extend import ExtendAlignment as JExtendAlignment
from darwin_tpu.seeding.seeder import Seeder as JSeeder
from darwin_tpu_torch import cli
from darwin_tpu_torch.config import Config
from darwin_tpu_torch.genome import GenomeStore, reads_from_numpy
from darwin_tpu_torch.index import seed_table
from darwin_tpu_torch.pipeline import printer
from darwin_tpu_torch.pipeline.align import new_counters, run
from darwin_tpu_torch.pipeline.extend import ExtendAlignment
from darwin_tpu_torch.seeding.seeder import Seeder
from darwin_tpu_torch.utils.simulate import mutate_read

torch.set_num_threads(2)


def _cfgs(**kw):
    out = []
    for cls in (JConfig, Config):
        cfg = cls()
        cfg.seed_size = 11             # small-read-set-friendly k
        cfg.do_overlap = True
        cfg.min_overlap = 500
        for k, v in kw.items():
            setattr(cfg, k, v)
        out.append(cfg)
    return out


# the non-speculative path, one batch at a time
K1 = {"spec_k": 1, "pipeline_depth": 1}


def _block(err: str):
    return [ln for ln in err.splitlines() if ln.startswith("#")]


@pytest.fixture(scope="module")
def read_set():
    """(names, sequences): 14 noisy reads of 1.5-3 kb tiling a 12 kb
    template on both strands, one unrelated read, one read that contains
    another."""
    rng = np.random.default_rng(17)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    comp = {65: 84, 67: 71, 71: 67, 84: 65}
    tmpl = acgt[rng.integers(0, 4, 12_000)]
    names, seqs = [], []
    for i in range(14):
        ln = int(rng.integers(1500, 3001))
        st = int(rng.integers(0, len(tmpl) - ln))
        seq = mutate_read(rng, tmpl[st:st + ln], 0.02, 0.01, 0.01)
        if i % 3 == 1:
            seq = np.array([comp[c] for c in seq[::-1]], np.uint8)
        names.append(f"r{i}_{st}_{ln}")
        seqs.append(seq)
    names.append("lonely")
    seqs.append(acgt[rng.integers(0, 4, 2000)])
    names.append("inner")
    seqs.append(seqs[0][300:1300].copy())
    return names, seqs


@pytest.fixture(scope="module")
def world(read_set, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_overlap")
    names, seqs = read_set
    with open(tmp / "reads.fa", "w") as f:
        for n, s in zip(names, seqs):
            f.write(f">{n}\n{s.tobytes().decode()}\n")
    jcfg, _ = _cfgs()
    out, err = io.StringIO(), io.StringIO()
    jax_run(str(tmp / "reads.fa"), str(tmp / "reads.fa"), True, cfg=jcfg,
            out=out, err=err)
    return tmp, out.getvalue(), _block(err.getvalue())


def test_read_seed_table_matches_darwin_tpu(read_set):
    names, seqs = read_set
    jcfg, cfg = _cfgs()
    jreads = [jmake_read(n, s) for n, s in zip(names, seqs)]
    want, jstore = jst.build_read_seed_table(jreads, jcfg)
    got, store = seed_table.build_read_seed_table(
        reads_from_numpy(names, seqs), cfg, "cpu")
    np.testing.assert_array_equal(store.bases, jstore.bases)
    assert [(c.name, c.start, c.length, c.length_unpadded)
            for c in store.chromosomes] == [
        (c.name, c.start, c.length, c.length_unpadded)
        for c in jstore.chromosomes]
    np.testing.assert_array_equal(got.sorted_hashes.numpy(),
                                  np.asarray(want.sorted_hashes))
    np.testing.assert_array_equal(got.positions.numpy(),
                                  np.asarray(want.positions))
    assert (got.kmer_size, got.minimizer_window, got.ref_size,
            got.kmer_max_occurence) == (
        want.kmer_size, want.minimizer_window, want.ref_size,
        want.kmer_max_occurence)


def test_overlap_anchors_match_darwin_tpu(read_set):
    """The seeder's overlap branch (stride schedule, one-bin chaining
    window): anchors and chained hits per read and strand."""
    names, seqs = read_set
    jcfg, cfg = _cfgs()
    jreads = [jmake_read(n, s) for n, s in zip(names, seqs)]
    jtable, _ = jst.build_read_seed_table(jreads, jcfg)
    want = JSeeder(jtable, jcfg).seed_batch(jreads)
    reads = reads_from_numpy(names, seqs)
    table, _ = seed_table.build_read_seed_table(reads, cfg, "cpu")
    got = Seeder(table, cfg).seed_batch(reads)
    assert got.n_queried_buckets == want.n_queried_buckets
    assert got.n_capped_buckets == want.n_capped_buckets
    n_anchors = 0
    for g_strand, w_strand in ((got.fw_anchors, want.fw_anchors),
                               (got.rc_anchors, want.rc_anchors)):
        for g_read, w_read in zip(g_strand, w_strand):
            assert len(g_read) == len(w_read)
            for g, w in zip(g_read, w_read):
                n_anchors += 1
                assert (g.hit, g.offset, g.num_chained_hits,
                        g.anchor_score) == (w.hit, w.offset,
                                            w.num_chained_hits,
                                            w.anchor_score)
                np.testing.assert_array_equal(g.left_chained,
                                              w.left_chained)
                np.testing.assert_array_equal(g.right_chained,
                                              w.right_chained)
    assert n_anchors > 20


def _alignment(cls, **kw):
    base = dict(read_num=0, chr_id=0, strand="+", reference_start_offset=0,
                query_start_offset=0, reference_end_offset=1199,
                query_end_offset=1199, reference_length=1200,
                query_length=1200, aligned_reference=b"A" * 1200,
                aligned_query=b"A" * 1053 + b"C" * 147, score=100)
    base.update(kw)
    return cls(**base)


@pytest.mark.parametrize("case", ["narrowing", "self", "short", "inner",
                                  "best_per_target"])
def test_mhap_lines_match_darwin_tpu(case):
    """The printer alone on hand-made alignments: the float32 narrowing of
    the error rate (147/1200 prints 0.123, not 0.122), the self-overlap
    skip, the min_overlap test, the last-tenth rule and one record per
    read and target."""
    jcfg, cfg = _cfgs(min_overlap=400)
    names = ["t0", "t1", "q"]
    seqs = [np.full(1200, 65, np.uint8), np.full(3000, 67, np.uint8),
            np.full(1200, 71, np.uint8)]
    if case == "self":
        names[2] = "t0"
    store = GenomeStore.from_numpy(names[:2], seqs[:2])
    reads = reads_from_numpy(names[2:], seqs[2:])
    kws = {
        "narrowing": [{}],
        "self": [{}],
        "short": [dict(reference_end_offset=300, query_end_offset=300,
                       reference_length=310, query_length=310,
                       aligned_reference=b"A" * 301,
                       aligned_query=b"A" * 301)],
        "inner": [dict(chr_id=1, reference_length=3000,
                       reference_end_offset=1500, query_length=3000,
                       query_end_offset=1199)],
        "best_per_target": [dict(score=50, strand="-"), dict(score=90),
                            dict(chr_id=1, score=10,
                                 reference_length=3000,
                                 reference_end_offset=2999,
                                 reference_start_offset=1800)],
    }[case]
    got = printer.mhap_lines([_alignment(ExtendAlignment, **kw)
                              for kw in kws], reads, store, cfg,
                             new_counters())
    want = jprinter.mhap_lines([_alignment(JExtendAlignment, **kw)
                                for kw in kws], reads, store, jcfg)
    assert got == want
    n_rec = len(got) // 6
    assert n_rec == {"narrowing": 1, "self": 0, "short": 0, "inner": 0,
                     "best_per_target": 2}[case]
    if case == "narrowing":
        assert got[0].split()[2] == "0.123"
    if case == "best_per_target":
        assert got[0].split()[8] == "0"          # the score-90 one, fw


def test_overlap_run_matches_darwin_tpu(world):
    tmp, mhap, block = world
    _, cfg = _cfgs()
    out, err = io.StringIO(), io.StringIO()
    run(str(tmp / "reads.fa"), str(tmp / "reads.fa"), True, cfg=cfg,
        out=out, err=err, device="cpu", **K1)
    recs = [ln.split() for ln in mhap.splitlines() if " " in ln]
    assert len(recs) >= 20 and not mhap.startswith("@")
    assert all(r[0] != r[1] for r in recs)
    assert not any("lonely" in r[:2] for r in recs)
    assert any("1" in (r[4], r[8]) for r in recs)      # a reverse overlap
    assert len(block) == 7
    assert out.getvalue() == mhap
    assert _block(err.getvalue()) == block


def test_overlap_cli_matches_darwin_tpu(world, capsys, monkeypatch):
    tmp, mhap, block = world
    monkeypatch.chdir(tmp)
    (tmp / "params.cfg").write_text(
        "[DSOFT_params]\nseed_size = 11\n"
        "[GACT_first_tile]\nmin_overlap = 500\n")
    try:
        assert cli.main(["reads.fa", "reads.fa", "1", "--device=cpu"],
                        **K1) == 0
    finally:
        (tmp / "params.cfg").unlink()
    got = capsys.readouterr()
    assert got.out == mhap
    assert _block(got.err) == block


def test_strand_dependent_recall_is_darwin_tpu_s_too(tmp_path):
    """Overlap mode queries only a read's first num_seeds + 2 minimizers
    per strand.  When the earlier read of an overlapping pair lies on '-'
    and the later on '+', that head is outside the overlap on the matching
    strand whichever read is the query, and the pair is found only when
    the overlap is most of the read.  darwin_tpu loses the same pairs on
    the same reads: 28 x 2 kb reads over 10 kbp, num_seeds = 200 (the
    share of a read that the default 1000 covers at 10 kb)."""
    from darwin_tpu_torch.utils import synth
    truth = synth.overlap_case(3, str(tmp_path), genome_len=10_000,
                               n_reads=28, read_len=2000)
    reads = str(tmp_path / "reads.fa")
    res = []
    for runner, cfg, kw in zip((jax_run, run), _cfgs(num_seeds=200),
                               ({}, {"device": "cpu", **K1})):
        out, err = io.StringIO(), io.StringIO()
        runner(reads, reads, True, cfg=cfg, out=out, err=err, **kw)
        res.append((out.getvalue(), _block(err.getvalue())))
    assert res[0] == res[1]
    pairs = {frozenset(ln.split()[:2]) for ln in res[0][0].splitlines()
             if " " in ln}
    found = {}
    names = sorted(truth, key=lambda n: truth[n][0])
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            if min(truth[a][1], truth[b][1]) - truth[b][0] > 1000:
                key = truth[a][2] + truth[b][2]     # (earlier, later) read
                hit, n = found.get(key, (0, 0))
                found[key] = (hit + (frozenset((a, b)) in pairs), n + 1)
    assert all(n >= 15 for _, n in found.values()), found
    for key in ("++", "+-", "--"):
        assert found[key][0] >= 0.95 * found[key][1], found
    assert found["-+"][0] <= 0.5 * found["-+"][1], found


def _printer_inputs(query="q"):
    """(store, reads) of test_mhap_lines_match_darwin_tpu: targets t0
    (1,200 A) and t1 (3,000 C), one query read named ``query``."""
    store = GenomeStore.from_numpy(["t0", "t1"], [
        np.full(1200, 65, np.uint8), np.full(3000, 67, np.uint8)])
    return store, reads_from_numpy([query], [np.full(1200, 71, np.uint8)])


FATES = ("num_mhap_printed", "num_mhap_self", "num_mhap_short",
         "num_mhap_unselected")
SHORT = dict(reference_end_offset=300, query_end_offset=300,
             reference_length=310, query_length=310,
             aligned_reference=b"A" * 301, aligned_query=b"A" * 301)
INNER = dict(chr_id=1, reference_length=3000, reference_end_offset=1500,
             query_length=3000, query_end_offset=1199)


@pytest.mark.parametrize("query,kws,fates", [
    ("q", [{}], (1, 0, 0, 0)),
    ("t0", [{}], (0, 1, 0, 0)),
    ("q", [SHORT], (0, 0, 1, 0)),
    ("q", [INNER], (0, 0, 0, 1)),
    # the score-90 alignment to t0 wins over the score-50 one
    ("q", [dict(score=50, strand="-"), dict(score=90),
           dict(chr_id=1, score=10, reference_length=3000,
                reference_end_offset=2999, reference_start_offset=1800)],
     (2, 0, 0, 1)),
    # one reason each: a short self-alignment is a self-alignment, an
    # unselected one is unselected
    ("t0", [SHORT], (0, 1, 0, 0)),
    ("t0", [dict(score=200), dict(score=100)], (0, 1, 0, 1)),
], ids=["printed", "self", "short", "unselected", "best_per_target",
        "short_self", "unselected_self"])
def test_mhap_counters_count_each_alignment_once(query, kws, fates):
    """Every alignment the printer is given is counted once, as printed or
    by the first reason it was dropped; its aligned columns go to printed
    or dropped; the lines are those of a second call with counters of
    its own."""
    _, cfg = _cfgs(min_overlap=400)
    store, reads = _printer_inputs(query)
    counters = new_counters()
    got = printer.mhap_lines([_alignment(ExtendAlignment, **kw)
                              for kw in kws], reads, store, cfg, counters)
    assert got == printer.mhap_lines([_alignment(ExtendAlignment, **kw)
                                      for kw in kws], reads, store, cfg,
                                     new_counters())
    assert tuple(counters[k] for k in FATES) == fates
    assert counters["num_mhap_printed"] * 6 == len(got)
    cols = [len(_alignment(ExtendAlignment, **kw).aligned_reference)
            for kw in kws]
    assert counters["mhap_columns_printed"] + \
        counters["mhap_columns_dropped"] == sum(cols)
    assert counters["mhap_columns_printed"] == sum(
        len(ln) - 1 for ln in got[1::6])


@pytest.fixture(scope="module")
def counted(world):
    """The port's run() on the read set under torch.profiler with a
    stats_out (so it records spans), the aligned columns and the number
    of the alignments handed to the printer recorded:
    (MHAP, stderr, stats_out, [(alignments, columns)] per batch)."""
    from torch.profiler import ProfilerActivity, profile
    tmp, _, _ = world
    _, cfg = _cfgs()
    given = []
    mhap_lines = printer.mhap_lines

    def recording(alignments, *a, **kw):
        given.append((len(alignments),
                      sum(len(e.aligned_reference) for e in alignments)))
        return mhap_lines(alignments, *a, **kw)
    mp = pytest.MonkeyPatch()
    mp.setattr(printer, "mhap_lines", recording)
    out, err, stats = io.StringIO(), io.StringIO(), {}
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            run(str(tmp / "reads.fa"), str(tmp / "reads.fa"), True, cfg=cfg,
                out=out, err=err, device="cpu", stats_out=stats,
                reads_per_batch=6, **K1)
    finally:
        mp.undo()
    return out.getvalue(), err.getvalue(), stats, given


def test_mhap_counters_add_up_over_a_run(counted):
    """Over a run: six lines a printed overlap, every alignment handed to
    the printer counted once, its columns printed or dropped, and the
    counters on one telemetry line after the counter block."""
    mhap, err, stats, given = counted
    c = stats["counters"]
    assert c["num_mhap_printed"] * 6 == mhap.count("\n") > 0
    assert sum(c[k] for k in FATES) == sum(n for n, _ in given)
    assert c["mhap_columns_printed"] + c["mhap_columns_dropped"] == sum(
        cols for _, cols in given)
    # every read of the set but the lonely one finds itself at least
    assert c["num_mhap_self"] >= 15 and c["mhap_columns_dropped"] > 0
    lines = err.splitlines()
    tele = [i for i, ln in enumerate(lines) if "#mhap printed" in ln]
    assert len(tele) == 1 and tele[0] > max(
        i for i, ln in enumerate(lines) if ln.startswith("#"))
    assert lines[tele[0]] == (
        f"[darwin_tpu_torch] #mhap printed: {c['num_mhap_printed']}  "
        f"#self: {c['num_mhap_self']}  #short: {c['num_mhap_short']}  "
        f"#unselected: {c['num_mhap_unselected']}  columns printed: "
        f"{c['mhap_columns_printed']}  columns dropped: "
        f"{c['mhap_columns_dropped']}")


def test_mhap_and_block_unchanged_by_spans(world, counted):
    """A run that records spans (three batches) prints darwin_tpu's MHAP
    bytes and 7-line counter block, as the untraced run does."""
    _, want, block = world
    mhap, err, stats, _ = counted
    assert "spans" in stats
    assert mhap == want
    assert _block(err) == block


def test_print_sub_spans_lie_inside_print(counted):
    """Each batch's print holds one print_select and then one
    print_format, on its thread."""
    _, _, stats, given = counted
    spans = stats["spans"]["spans"]
    prints = {(th, b): (s, e) for n, th, b, s, e in spans if n == "print"}
    assert len(prints) == len(given) == 3
    for name in ("print_select", "print_format"):
        subs = [(th, b, s, e) for n, th, b, s, e in spans if n == name]
        assert len(subs) == len(prints)
        for th, b, s, e in subs:
            ps, pe = prints[th, b]
            assert ps <= s <= e <= pe, (name, th, b)
    sel = {(th, b): e for n, th, b, _, e in spans if n == "print_select"}
    assert all(sel[th, b] <= s for n, th, b, s, _ in spans
               if n == "print_format")


def test_overlap_run_equals_the_benchmark_reference(tmp_path):
    """run(overlap=True) against the benchmark's plain reference
    (benchmark/reference/darwin.py), record for record, on a read set
    drawn at ecoli_k12_pacbio's error profile from benchmark/tests/tiny.py's
    uniform genome."""
    import json
    import os
    from benchmark import harness
    from benchmark.gen import reads as greads
    from benchmark.reference.darwin import Reference
    from benchmark.tests import tiny
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs",
                           "ecoli_k12_pacbio.json")) as f:
        profile = json.load(f)["reads"]
    _, traffic, config = tiny.cell("overlap")
    config = dict(config, reads=dict(config["reads"],
                                     error=profile["error"]))
    read_set, reads = harness.make_inputs(config, traffic, 2**31 + 17, 8)
    (tmp_path / "set.fa").write_bytes(greads.fasta_bytes(read_set))
    (tmp_path / "reads.fa").write_bytes(greads.fasta_bytes(reads))
    out = io.StringIO()
    run(str(tmp_path / "set.fa"), str(tmp_path / "reads.fa"), True, out=out,
        err=io.StringIO(), device="cpu", **tiny.RUN)
    lines = [ln + "\n" for ln in out.getvalue().split("\n") if ln]
    got = harness.records_by_read([(0, lines)], [n for n, _ in reads], True)
    want = Reference(read_set, True, "cpu").align(reads)
    assert got == want
    assert sum(1 for v in want.values() if v) >= len(reads) // 2
