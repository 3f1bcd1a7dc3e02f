"""N blocks, as GRCh38 lays them out, through darwin_tpu_torch's index and
CLI against darwin_tpu on the CPU.

Inside an N block every k-mer is the poly-A k-mer (N folds to code 0), so
the window minimum never changes and the minimizer scan emits every w-th
position from an anchor set where the block began: rows and row batches
before.  Here rows and batches are patched small in both packages, so
that blocks start, end and lie whole inside batches, and the port's
pairs and csr builds are held to darwin_tpu's host build, and its csr
table's digest to darwin_tpu's csr table's.  Then the ``human_gaps``
layout (``utils.synth.HUMAN_GAPS``) is checked without drawing its
genome, and a small gapped genome goes through both CLIs.  Tolerance:
none — integer arrays equal, SAM bytes and counter block identical."""

import contextlib
import io
import math

import numpy as np
import pytest
import torch

from darwin_tpu import cli as jcli
from darwin_tpu.config import Config as JConfig
from darwin_tpu.genome import GenomeStore as JStore
from darwin_tpu.index import minimizers as jmin
from darwin_tpu.index import seed_table as jst
from darwin_tpu_torch import cli
from darwin_tpu_torch.config import Config
from darwin_tpu_torch.genome import WORD_SIZE, GenomeStore
from darwin_tpu_torch.index import minimizers, seed_table
from darwin_tpu_torch.utils import goldens, synth

torch.set_num_threads(2)
N = ord("N")
# rows of 1024 new positions, 4 rows a batch, in both packages
CHUNK, ROWS = 1024, 4
BATCH = CHUNK * ROWS


@pytest.fixture
def small_rows(monkeypatch):
    monkeypatch.setattr(jmin, "CHUNK", CHUNK)
    monkeypatch.setattr(jmin, "CROWS", ROWS)
    monkeypatch.setattr(minimizers, "CHUNK", CHUNK)
    monkeypatch.setattr(minimizers, "ROWS", ROWS)


def _gapped():
    """[(name, ASCII bases)], 2.1 Mbp: a sequence that starts with an N
    block longer than a batch and holds 100-N runs, one that ends in such
    a block, one all N, and one whose blocks lie across batch
    boundaries."""
    rng = np.random.default_rng(13)
    lead = synth.uniform_bases(rng, 600_000)
    lead[:3 * BATCH + 500] = N
    for p in range(40_000, 600_000, 37_000):
        lead[p:p + 100] = N
    tail = synth.uniform_bases(rng, 500_003)
    tail[-(2 * BATCH + 300):] = N
    inner = synth.uniform_bases(rng, 990_001)
    for s, ln in ((100_000, 3 * BATCH + 100), (400_007, 51_234),
                  (700_000, BATCH - 1)):
        inner[s:s + ln] = N
    return [("lead", lead), ("tail", tail),
            ("alln", np.full(2 * BATCH + 777, N, np.uint8)),
            ("inner", inner)]


def _stores(seqs):
    j, p = JStore(), GenomeStore()
    for name, bases in seqs:
        j.add_chromosome(name, bases)
        p.add_chromosome(name, bases)
    return j.finalize(), p.finalize()


def _configs(k, w):
    jcfg, cfg = JConfig(), Config()
    jcfg.seed_size = cfg.seed_size = k
    jcfg.minimizer_window = cfg.minimizer_window = w
    return jcfg, cfg


def test_blocks_cross_rows_and_batches(small_rows):
    """The store puts N at every place the anchor is carried: from a
    batch-leading row that resumes its sequence, in rows whose interior
    is all N, and across sequence starts inside a batch."""
    seqs = _gapped()
    jstore, store = _stores(seqs)
    lengths = [c.length_unpadded for c in store.chromosomes]
    seq, start, _ = minimizers.work_list(lengths, 14)
    assert minimizers.CHUNK == jmin.CHUNK == CHUNK
    is_n = store.bases == N
    # every batch boundary (row b * ROWS) that resumes a sequence inside N
    at = [(seq[r], start[r]) for r in range(0, len(seq), ROWS)
          if start[r] > 0 and is_n[store.chromosomes[seq[r]].start
                                   + start[r]]]
    names = {seqs[s][0] for s, _ in at}
    assert names == {"lead", "tail", "alln", "inner"}
    assert len(at) > 10


@pytest.mark.parametrize("k,w", [(14, 3), (10, 5)])
def test_gapped_builds_match_darwin_tpu(k, w, small_rows):
    """Every pairs build and the csr build of the port against
    darwin_tpu's host build, which carries its own anchor across rows and
    batches of the same size; the poly-A bucket holds the N blocks'
    emissions, every w-th position of each block."""
    jstore, store = _stores(_gapped())
    jcfg, cfg = _configs(k, w)
    want = jst.build_seed_table(jstore, jcfg, method="host")
    wh = np.asarray(want.sorted_hashes)
    wp = np.asarray(want.positions)
    for method in ("device", "stream"):
        got = seed_table.build_seed_table(store, cfg, "cpu", method=method)
        assert got.build_stats["method"] == method
        np.testing.assert_array_equal(
            got.sorted_hashes.numpy().view(np.uint32), wh, err_msg=method)
        np.testing.assert_array_equal(
            got.positions.numpy().view(np.uint32), wp, err_msg=method)
    csr = seed_table.build_seed_table(store, cfg, "cpu", layout="csr")
    np.testing.assert_array_equal(csr.positions.numpy().view(np.uint32), wp)
    sizes = np.bincount(wh, minlength=1 << 2 * k)
    np.testing.assert_array_equal(np.diff(csr.bucket_offsets.numpy()),
                                  sizes)
    assert csr.bucket_offsets[0] == 0
    # the poly-A k-mer's bucket: about a w-th of the N positions
    poly_a = int(minimizers.hash32(torch.zeros(1, dtype=torch.int64), k))
    assert int(np.argmax(sizes)) == poly_a
    n_bases = int((store.bases[WORD_SIZE:] == N).sum())
    assert sizes[poly_a] > 0.9 * n_bases / w


def test_scan_follows_darwins_automaton_across_n(small_rows):
    """Darwin's emission automaton (software/seed_pos_table.h:342-348),
    step by step in Python: last_m = last_p = 0, emit p when m[p] !=
    last_m or p - last_p >= w, then take m[p] and p.  The port's
    work-list scan (which equals darwin_tpu's) emits the same positions
    of every sequence, through N blocks many rows and batches long."""
    seqs = _gapped()
    _, store = _stores(seqs)
    k, w = 10, 3
    codes = minimizers.encode2_on(store.bases, "cpu")
    starts = [c.start for c in store.chromosomes]
    lengths = [c.length_unpadded for c in store.chromosomes]
    _, pos = minimizers.host_pairs(codes, starts, lengths, k, w)
    pos = np.sort(pos.astype(np.int64))
    for c in store.chromosomes:
        r16 = (c.length_unpadded + 15) // 16 * 16
        h = minimizers.kmer_hashes(codes[None, c.start:c.start + r16 + k],
                                   k)[0].numpy()
        m = np.lib.stride_tricks.sliding_window_view(h, w).min(1)
        want, last_m, last_p = [], 0, 0
        for p in range(w - 1, r16 - k):
            mp = int(m[p - w + 1])
            if mp != last_m or p - last_p >= w:
                want.append(c.start + p)
                last_m, last_p = mp, p
        got = pos[(pos >= c.start) & (pos < c.start + c.length)]
        np.testing.assert_array_equal(got, want, err_msg=c.name)


def test_index_digest_of_both_packages(small_rows):
    """index_digest of the port's csr table is that of darwin_tpu's csr
    table of the same store (darwin_tpu's streaming csr build, its own
    rows patched small too); a one-position change alters it."""
    jstore, store = _stores(_gapped())
    jcfg, cfg = _configs(10, 3)
    jt = jst.build_seed_table(jstore, jcfg, layout="csr")
    pt = seed_table.build_seed_table(store, cfg, "cpu", layout="csr")

    def meta(t):
        return np.array([t.kmer_size, t.minimizer_window, t.ref_size,
                         t.kmer_max_occurence], np.int64)
    want = goldens.index_entry(meta(jt), np.asarray(jt.bucket_offsets),
                               np.asarray(jt.positions))
    got = goldens.index_entry(meta(pt), pt.bucket_offsets.numpy(),
                              pt.positions.numpy())
    assert got == want
    poly_a = int(minimizers.hash32(torch.zeros(1, dtype=torch.int64), 10))
    assert want["largest_bucket"][0] == poly_a
    assert want["seeds"] == pt.num_seeds
    pos = pt.positions.numpy().copy()
    pos[len(pos) // 2] += 1
    assert goldens.index_digest(meta(pt), pt.bucket_offsets.numpy(),
                                pos) != want["sha256"]


def test_n_bucket_lifts_a_sort_piece(monkeypatch, small_rows):
    """The streaming pairs build sorts in hash-range pieces and never
    splits a bucket: the poly-A bucket lifts its piece past SORT_PIECE,
    and build_stats records the largest piece's key count."""
    monkeypatch.setattr(minimizers, "SORT_PIECE", 1 << 13)
    _, store = _stores(_gapped())
    _, cfg = _configs(10, 3)
    got = seed_table.build_seed_table(store, cfg, "cpu", method="stream")
    bits = math.ceil(math.log2(got.num_seeds / minimizers.SORT_PIECE))
    shift = 2 * 10 - bits
    pieces = np.bincount(got.sorted_hashes.numpy() >> shift,
                         minlength=1 << bits)
    poly_a = int(minimizers.hash32(torch.zeros(1, dtype=torch.int64), 10))
    assert got.build_stats["sort_pieces"] == 1 << bits
    assert got.build_stats["largest_piece"] == pieces.max() \
        == pieces[poly_a >> shift] > 3 * minimizers.SORT_PIECE


# ------------------------------------------- the human_gaps layout

def _chrom_starts():
    """Global start of each GRCh38 chromosome in the store's coordinate
    space: the guard block, then each padded to WORD_SIZE."""
    starts, at = {}, WORD_SIZE
    for name, n in synth.GRCH38:
        starts[name] = at
        at += -(-n // WORD_SIZE) * WORD_SIZE
    return starts


def test_human_gaps_layout():
    lengths = dict(synth.GRCH38)
    order = {name: i for i, (name, _) in enumerate(synth.GRCH38)}
    gaps = synth.HUMAN_GAPS
    keys = [(order[c], s) for c, s, _, _ in gaps]
    assert keys == sorted(keys)
    for (c, s, ln, _), (c2, s2, _, _) in zip(gaps, gaps[1:]):
        assert c != c2 or s + ln <= s2           # disjoint
    assert all(0 <= s and s + ln <= lengths[c] for c, s, ln, _ in gaps)
    assert sum(ln for _, _, ln, _ in gaps) == 132_958_700
    by_class = {}
    for _, _, ln, cls in gaps:
        by_class.setdefault(cls, []).append(ln)
    assert {k: len(v) for k, v in by_class.items()} == {
        "telomere": 48, "short_arm": 5, "heterochromatin": 3,
        "scaffold": 287}
    assert set(by_class["scaffold"]) == {100}
    for name, n in synth.GRCH38:
        mine = [(s, ln) for c, s, ln, _ in gaps if c == name]
        assert mine[0] == (0, 10_000) and mine[-1] == (n - 10_000, 10_000)
    het_y = next((c, s) for c, s, _, cls in gaps
                 if cls == "heterochromatin" and c == "chrY")
    assert _chrom_starts()["chrY"] + het_y[1] >= 1 << 31


def test_chr1_block_holds_a_scan_batch_boundary():
    """A batch of the port's scan (ROWS rows) starts inside chr1's
    heterochromatin: the anchor of the N block is carried into a new
    batch there."""
    lengths = [n for _, n in synth.GRCH38]
    seq, start, _ = minimizers.work_list(lengths, Config().seed_size)
    first = np.arange(0, len(seq), minimizers.ROWS)
    s, ln = next((s, ln) for c, s, ln, cls in synth.HUMAN_GAPS
                 if c == "chr1" and cls == "heterochromatin")
    inside = [int(start[r]) for r in first
              if seq[r] == 0 and s < start[r] < s + ln]
    assert inside == [16_384 * minimizers.CHUNK]


# ------------------------------------------- the CLIs on a gapped genome

SMALL = [("g1", 1_200_000), ("g2", 800_000)]
SMALL_GAPS = synth.gap_layout(SMALL, {"g2": 160_000},
                              [("g1", 450_000, 300_000)], 200_000)
SMALL_READS = {"edge": 4, "flank": 4, "scaffold": 2, "far": 2}


@pytest.fixture(scope="module")
def small_case(tmp_path_factory):
    """A 2 Mbp genome of two chromosomes with HUMAN_GAPS's classes (a 300
    kb and a 150 kb block, telomeres, 100-N runs every 200 kb) and 12
    reads of its four groups, written as the real-size case is."""
    rng = np.random.default_rng(5)
    store = synth.gapped_genome(rng, SMALL, SMALL_GAPS)
    reads = synth.gapped_reads(rng, store, SMALL_GAPS, SMALL_READS)
    d = tmp_path_factory.mktemp("gaps")
    truth = synth.write_case(str(d), store, reads)
    return d, store, truth


def _cli(main, d, argv, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.chdir(d), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        assert main(argv, **kw) == 0, err.getvalue()[-2000:]
    return out.getvalue(), [ln for ln in err.getvalue().splitlines()
                            if ln.startswith("#")]


def test_small_gapped_genome_through_both_clis(small_case):
    """darwin_tpu's CLI and the port's on the CPU, csr index as the
    ``human_gaps`` golden's argv: the same SAM bytes and counter block.
    The reads cover every group: N inside their spans (edge, scaffold)
    or beside them (flank)."""
    d, store, truth = small_case
    chroms = {c.name: c for c in store.chromosomes}
    n_in = [int((store.bases[chroms[c].start + s:chroms[c].start + s
                             + synth.HUMAN_READ_LEN] == N).sum())
            for c, s, _ in truth.values()]
    groups = [g for g, n in SMALL_READS.items() for _ in range(n)]
    for g, n in zip(groups, n_in):
        assert {"edge": 1000 <= n <= 9000, "flank": n == 0,
                "scaffold": n == 100, "far": n == 0}[g], (g, n)
    argv = ["ref.fa", "reads.fa", "0", "--index-layout=csr"]
    want = _cli(jcli.main, d, argv)
    got = _cli(cli.main, d, argv + ["--device=cpu"])
    assert got == want
    assert want[1][0] == f"#reads: {len(truth)}"
    assert len(goldens.records(want[0], False)) >= len(truth)
