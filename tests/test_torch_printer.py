"""The SAM printer of darwin_tpu_torch against darwin_tpu's: the CIGARs the
host library builds for a batch in one call (``native.sam_cigars_native``)
against darwin_tpu's ``_cigar`` record by record, and ``sam_lines`` on a
batch of alignments byte for byte.  Tolerance: none."""

import numpy as np
import pytest

from darwin_tpu.pipeline import printer as jprinter
from darwin_tpu.pipeline.extend import ExtendAlignment as JExtendAlignment
from darwin_tpu_torch import native
from darwin_tpu_torch.genome import GenomeStore, reads_from_numpy
from darwin_tpu_torch.pipeline import printer
from darwin_tpu_torch.pipeline.extend import ExtendAlignment

# the Darwin paper's PBSIM profiles: substitution / insertion / deletion
PACBIO = (0.0150, 0.0902, 0.0449)
ONT_2D = (0.1650, 0.0510, 0.0840)
BASES = np.frombuffer(b"ACGTacgtN", np.uint8)


def _aligned_pair(rng, n, profile):
    """Two aligned strings of n columns at an error profile: a column is an
    insertion ('-' in the reference), a deletion ('-' in the query), a
    substitution (the query's base drawn anew) or a match."""
    sub, ins, dele = profile
    u = rng.random(n)
    ref = BASES[rng.integers(0, len(BASES), n)]
    q = ref.copy()
    is_sub = (u >= ins + dele) & (u < ins + dele + sub)
    q[is_sub] = BASES[rng.integers(0, len(BASES), int(is_sub.sum()))]
    ref[u < ins] = ord("-")
    q[(u >= ins) & (u < ins + dele)] = ord("-")
    return ref.tobytes(), q.tobytes()


def _records(case, rng):
    """(aligned reference, aligned query, head clip, tail clip) records."""
    if case in ("pacbio", "ont_2d"):
        profile = PACBIO if case == "pacbio" else ONT_2D
        recs = []
        for n in (10_000, 9_000, 11_000, 300, 1, 2):
            ref, q = _aligned_pair(rng, n, profile)
            head, tail = rng.integers(0, 3, 2) * rng.integers(1, 400, 2)
            recs.append((ref, q, int(head), int(tail)))
        return recs
    return {
        "empty": [(b"", b"", 0, 0)],
        "empty_clipped": [(b"", b"", 17, 0), (b"", b"", 0, 3),
                          (b"", b"", 5, 9), (b"", b"", -2, -1)],
        "all_I": [(b"-" * 7, b"ACGTACG", 0, 0), (b"-" * 12, b"A" * 12, 4, 2)],
        "all_D": [(b"ACGTACG", b"-" * 7, 0, 0), (b"A" * 12, b"-" * 12, 1, 10)],
        "edge_gaps": [(b"--ACGT--", b"ACAC-TAA", 0, 0),
                      (b"AC-GT", b"-CAG-", 3, 0),
                      (b"AACC", b"--CC", 0, 5), (b"AACC--", b"AAC-GG", 2, 2)],
        "single": [(b"A", b"C", 0, 0), (b"-", b"A", 0, 0), (b"A", b"-", 0, 0),
                   (b"A", b"A", 1, 1)],
        "long_run": [(b"A" * 1000, b"C" * 1000, 0, 0),
                     (b"G" * 123_456 + b"-" * 1000, b"G" * 124_456, 9, 0),
                     (b"-" * 2, b"A" * 2, 0, 0)],
        # clips past 32 bits
        "large_clips": [(b"ACGT", b"AC-T", 2**40 + 3, 2**33)],
    }[case]


def _jcigar(ref, q, head, tail):
    e = JExtendAlignment(
        read_num=0, chr_id=0, strand="+", reference_start_offset=0,
        query_start_offset=head, reference_end_offset=0,
        query_end_offset=0, reference_length=len(ref),
        query_length=tail + 1, aligned_reference=ref, aligned_query=q,
        score=0)
    return jprinter._cigar(e)


@pytest.mark.parametrize("case", [
    "pacbio", "ont_2d", "empty", "empty_clipped", "all_I", "all_D",
    "edge_gaps", "single", "long_run", "large_clips"])
def test_sam_cigars_match_darwin_tpu(case):
    """Every record's CIGAR from one call for the batch equals darwin_tpu's
    ``_cigar``, and the CIGAR of the record alone."""
    recs = _records(case, np.random.default_rng(20))
    refs, qs, heads, tails = zip(*recs)
    got = native.sam_cigars_native(refs, qs, heads, tails)
    want = [_jcigar(*r) for r in recs]
    assert got == want
    assert [native.sam_cigars_native([r], [q], [h], [t])[0]
            for r, q, h, t in recs] == want
    if case == "empty":
        assert got == ["*"]
    if case == "long_run":
        assert got[:2] == ["1000M", "9S123456M1000I"]


@pytest.mark.parametrize("where", [0, 2])
def test_sam_cigars_refuse_strings_of_different_lengths(where):
    recs = [(b"ACGT", b"ACGT", 0, 0), (b"AC-T", b"ACGT", 1, 1),
            (b"ACGT", b"ACGT", 0, 0)]
    recs[where] = (b"ACGT", b"ACG", 0, 0)
    with pytest.raises(ValueError, match="differ in length"):
        native.sam_cigars_native(*zip(*recs))
    refs, qs, heads, tails = zip(*recs)
    with pytest.raises(ValueError, match="clips"):
        native.sam_cigars_native(refs, qs, heads, tails[:where])


def _alignments(cls, rng):
    """A batch of alignments over three reads and two chromosomes: both
    strands, clips at either end, secondaries that overlap a better
    alignment of their read by less than half (printed) and by more
    (suppressed), a tie in score, and a read with no alignment."""
    out = []
    spans = [  # read, chromosome, strand, query start, query end, score
        (1, 0, "+", 0, 399, 100), (0, 0, "+", 0, 999, 900),
        (0, 0, "+", 400, 1100, 300), (0, 1, "-", 900, 1499, 700),
        (0, 1, "+", 1300, 1499, 200), (1, 1, "-", 120, 1380, 800),
        (1, 0, "+", 0, 1499, 800),
    ]
    for read, chrom, strand, qs, qe, score in spans:
        ref, q = _aligned_pair(rng, qe - qs + 60, PACBIO)
        out.append(cls(
            read_num=read, chr_id=chrom, strand=strand,
            reference_start_offset=int(rng.integers(0, 5000)),
            query_start_offset=qs, reference_end_offset=6000,
            query_end_offset=qe, reference_length=8000 + 1000 * chrom,
            query_length=1500, aligned_reference=ref, aligned_query=q,
            score=score))
    return out


def test_sam_lines_match_darwin_tpu():
    """``sam_lines`` on a batch equals darwin_tpu's byte for byte: the
    sort, the suppression of secondaries, flags, CIGARs, SEQ and tags."""
    rng = np.random.default_rng(21)
    store = GenomeStore.from_numpy(
        ["chr_a", "chr_b"], [BASES[:4][rng.integers(0, 4, n)]
                             for n in (8000, 9000)])
    reads = reads_from_numpy(
        ["r0", "r1", "r2"],
        [BASES[:4][rng.integers(0, 4, 1500)] for _ in range(3)])
    seed = int(rng.integers(1 << 30))
    got = printer.sam_lines(_alignments(ExtendAlignment,
                                        np.random.default_rng(seed)),
                            reads, store)
    want = jprinter.sam_lines(_alignments(JExtendAlignment,
                                          np.random.default_rng(seed)),
                              reads, store)
    assert "".join(got).encode() == "".join(want).encode()
    assert [ln.split("\t")[:2] for ln in got] == [
        ["r0", "64"], ["r0", "80"], ["r1", "80"]]


def test_sam_lines_raise_without_the_host_library(monkeypatch):
    store = GenomeStore.from_numpy(["chr_a"], [BASES[:4].repeat(2000)])
    reads = reads_from_numpy(["r0", "r1"], [BASES[:4].repeat(375)] * 2)
    monkeypatch.setattr(native, "sam_cigars_native", lambda *a: None)
    with pytest.raises(RuntimeError, match="native host library"):
        printer.sam_lines(_alignments(ExtendAlignment,
                                      np.random.default_rng(22))[:1],
                          reads, store)
