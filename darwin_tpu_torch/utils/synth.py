"""Synthetic inputs for runs on the card: random genomes, reads across a
planted deletion, the E. coli K-12-size reference-guided case, the
overlap case, the chr21-size repeat-genome case and the GRCh38-size
cases, without and with N gaps, that ``chip_smoke.py`` aligns, and the
generic-scoring ``params.cfg``.

Everything comes from a numpy seed; reads are simulated with
``utils.simulate`` and repeat genomes made by ``utils.synthgenome``
(numpy only)."""

from __future__ import annotations

import hashlib

import numpy as np

from darwin_tpu_torch.genome import GenomeStore, revcomp_bytes
from darwin_tpu_torch.utils.simulate import mutate_read, ont_lengths, \
    simulate_reads, write_fasta
from darwin_tpu_torch.utils.synthgenome import repeat_genome

ECOLI_LEN = 4_641_652          # E. coli K-12 MG1655 (NC_000913.3)
CHR21_LEN = 46_709_983         # GRCh38 chr21 (NC_000021.9)
# GRCh38's primary-assembly chromosomes in bp, in karyotype order: chr14
# and every later one start past 2^31 in this order; 3,088,269,832 bp
GRCH38 = [
    ("chr1", 248_956_422), ("chr2", 242_193_529), ("chr3", 198_295_559),
    ("chr4", 190_214_555), ("chr5", 181_538_259), ("chr6", 170_805_979),
    ("chr7", 159_345_973), ("chr8", 145_138_636), ("chr9", 138_394_717),
    ("chr10", 133_797_422), ("chr11", 135_086_622), ("chr12", 133_275_309),
    ("chr13", 114_364_328), ("chr14", 107_043_718), ("chr15", 101_991_189),
    ("chr16", 90_338_345), ("chr17", 83_257_441), ("chr18", 80_373_285),
    ("chr19", 58_617_616), ("chr20", 64_444_167), ("chr21", 46_709_983),
    ("chr22", 50_818_468), ("chrX", 156_040_895), ("chrY", 57_227_415)]

# A legal params.cfg whose gap opens are cheaper than its gap extends on
# both lanes, everything else default: darwin_tpu's tile DP takes its
# generic branch for it (the port's kernel is one form for every scoring).
GENERIC_PARAMS_CFG = ("[GACT_scoring]\ngap_open = -1\ngap_extend = -3\n"
                      "long_gap_open = -2\nlong_gap_extend = -6\n")


def random_genome(rng, chroms) -> GenomeStore:
    """Uniform random ACGT chromosomes, ``chroms`` = [(name, length)]."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    store = GenomeStore()
    for name, n in chroms:
        store.add_chromosome(name, acgt[rng.integers(0, 4, n)])
    return store.finalize()


def reference_pieces(store: GenomeStore):
    """The bytes of ``store``'s FASTA, one line per chromosome, in pieces
    (``>name\n``, the bases as a view of the store, ``\n``): what
    ``write_reference`` writes and ``reference_digest`` hashes."""
    for c in store.chromosomes:
        yield f">{c.name}\n".encode()
        yield store.bases[c.start:c.start + c.length_unpadded]
        yield b"\n"


def write_reference(path: str, store: GenomeStore) -> None:
    with open(path, "wb") as f:
        for piece in reference_pieces(store):
            f.write(piece)


def reference_digest(store: GenomeStore) -> dict:
    """{"sha256", "bytes"} of the file ``write_reference`` would write,
    without writing it."""
    h, n = hashlib.sha256(), 0
    for piece in reference_pieces(store):
        h.update(piece)
        n += len(piece)
    return {"sha256": h.hexdigest(), "bytes": n}


def planted_deletions(rng, store, n, left=5000, gap=1500, right=5000,
                      chrom=0):
    """Reads of chromosome ``chrom`` (an index into the store's, the first
    by default) spanning a ``gap`` bp deletion, on a random strand:
    large-tile escalation fires on them.  Returns [(name, seq, (chrom,
    start0, strand))] as simulate_reads does."""
    c = store.chromosomes[chrom]
    out = []
    for i in range(n):
        start = int(rng.integers(0, c.length_unpadded - left - gap - right))
        s0 = c.start + start
        seq = np.concatenate([store.bases[s0:s0 + left],
                              store.bases[s0 + left + gap:
                                          s0 + left + gap + right]])
        seq = mutate_read(rng, seq)
        strand = "+" if rng.random() < 0.5 else "-"
        if strand == "-":
            seq = revcomp_bytes(seq)
        out.append((f"del{i}_{c.name}_{start}_{strand}", seq,
                    (c.name, start, strand)))
    return out


def write_case(directory: str, store: GenomeStore, sim) -> dict:
    """Write ``store`` as ``ref.fa`` and the reads ``sim`` as ``reads.fa``
    into ``directory``.  Returns {read name: (chrom, start0, strand)}."""
    write_reference(f"{directory}/ref.fa", store)
    write_fasta(f"{directory}/reads.fa", sim)
    return {n: t for n, _, t in sim}


def ecoli_case(seed: int, directory: str) -> dict:
    """Write ``ref.fa`` and ``reads.fa`` of the E. coli K-12-size case into
    ``directory``: a synthetic genome of MG1655's length, 512 simulated
    10 kb reads (error 0.04 / 0.03 / 0.03, both strands) and 16 reads
    across a planted 1.5 kb deletion.  Returns {read name: (chrom, start0,
    strand)}."""
    rng = np.random.default_rng(seed)
    store = random_genome(rng, [("ecoli_k12_synthetic", ECOLI_LEN)])
    sim = simulate_reads(store, 512, 10_000, seed=seed + 3,
                         error=(0.04, 0.03, 0.03))
    sim += planted_deletions(rng, store, 16)
    return write_case(directory, store, sim)


def overlap_case(seed: int, directory: str, genome_len: int = 500_000,
                 n_reads: int = 512, read_len: int = 10_000) -> dict:
    """Write ``reads.fa`` of the overlap case into ``directory``:
    ``n_reads`` simulated reads of ``read_len`` (error 0.04 / 0.03 / 0.03,
    both strands) drawn uniformly from one synthetic chromosome — 512 x
    10 kb over 500 kbp is 10x coverage.  Returns {read name: (start0,
    end0, strand)}, the span each read was drawn from."""
    rng = np.random.default_rng(seed)
    store = random_genome(rng, [("overlap_synthetic", genome_len)])
    sim = simulate_reads(store, n_reads, read_len, seed=seed + 5,
                         error=(0.04, 0.03, 0.03))
    write_fasta(f"{directory}/reads.fa", sim)
    return {n: (start, start + read_len, strand)
            for n, _, (_, start, strand) in sim}


def chr21_case(seed: int, directory: str) -> dict:
    """Write ``ref.fa`` and ``reads.fa`` of the chr21-size case into
    ``directory``: a ``repeat_genome`` of GRCh38 chr21's length at its
    default repeat fractions, 512 simulated reads of ONT-like lengths
    (``ont_lengths``: mean 10 kb, log-normal sigma 0.55, 1-40 kb) with an
    ONT error profile (0.03 / 0.03 / 0.04), both strands, and 16 reads
    across a planted 1.5 kb deletion.  Returns {read name: (chrom, start0,
    strand)}."""
    rng = np.random.default_rng(seed)
    bases, _ = repeat_genome(rng, CHR21_LEN)
    store = GenomeStore.from_numpy(["chr21_repeat_synthetic"], [bases])
    sim = simulate_reads(store, 512, 10_000, seed=seed + 3,
                         error=(0.03, 0.03, 0.04),
                         read_lens=ont_lengths(rng, 512))
    sim += planted_deletions(rng, store, 16)
    return write_case(directory, store, sim)


def subset_reads(src: str, dst: str, select) -> int:
    """Copy the records of the FASTA ``src`` that ``select`` picks (a
    slice, or indices in file order) verbatim into ``dst``; returns the
    number copied."""
    with open(src) as f:
        recs = [">" + r for r in f.read().split(">")[1:]]
    keep = (recs[select] if isinstance(select, slice)
            else [recs[i] for i in select])
    with open(dst, "w") as f:
        f.writelines(keep)
    return len(keep)


def uniform_bases(rng, n: int) -> np.ndarray:
    """``n`` uniform random ACGT bytes, four from each random byte."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    quad = np.ascontiguousarray(
        acgt[(np.arange(256)[:, None] >> np.arange(0, 8, 2)) & 3])
    r = rng.integers(0, 256, (n + 3) // 4, dtype=np.uint8)
    return quad.view(np.uint32).ravel()[r].view(np.uint8)[:n]


HUMAN_READ_LEN = 10_000
# human_case's reads by kind, in file order: from chr14 on (past 2^31),
# ending at chrY's last base, from chr1, across global coordinate 2^31 in
# chr13, and across a planted deletion in DELETION_CHROM
HUMAN_READS = {"far": 408, "tail": 8, "chr1": 64, "straddle": 16,
               "deletion": 16}
DELETION_CHROM = "chrX"


def human_inputs(seed: int):
    """GRCh38's coordinate space: its 24 chromosomes at their lengths,
    uniform random bases, and HUMAN_READS's 512 reads of 10 kb (error 0.04
    / 0.03 / 0.03, random strand; the deletion reads 10 kb around a 1.5 kb
    gap).  Returns (store, [(name, seq, (chrom, start0, strand))])."""
    rng = np.random.default_rng(seed)
    store = GenomeStore()
    for name, n in GRCH38:
        store.add_chromosome(name, uniform_bases(rng, n))
    store.finalize()
    by_name = {c.name: i for i, c in enumerate(store.chromosomes)}
    chroms = store.chromosomes
    far = chroms[by_name["chr14"]:]
    chr13, chry = chroms[by_name["chr13"]], chroms[by_name["chrY"]]
    # (chromosome, start0) of each simulated read, in file order
    spans = [(far[int(i)], None) for i in
             rng.integers(0, len(far), HUMAN_READS["far"])]
    spans += [(chry, chry.length_unpadded - HUMAN_READ_LEN)] \
        * HUMAN_READS["tail"]
    spans += [(chroms[0], None)] * HUMAN_READS["chr1"]
    lo = (1 << 31) - chr13.start - (HUMAN_READ_LEN - 1)
    spans += [(chr13, int(s)) for s in rng.integers(
        lo, lo + HUMAN_READ_LEN - 1, HUMAN_READS["straddle"])]
    reads = []
    for i, (c, start) in enumerate(spans):
        if start is None:
            start = int(rng.integers(0, c.length_unpadded - HUMAN_READ_LEN))
        seq = mutate_read(rng, store.bases[c.start + start:
                                           c.start + start + HUMAN_READ_LEN])
        strand = "+" if rng.random() < 0.5 else "-"
        if strand == "-":
            seq = revcomp_bytes(seq)
        reads.append((f"read{i}_{c.name}_{start}_{strand}", seq,
                      (c.name, start, strand)))
    reads += planted_deletions(rng, store, HUMAN_READS["deletion"],
                               chrom=by_name[DELETION_CHROM])
    return store, reads


def human_case(seed: int, directory: str) -> dict:
    """Write ``ref.fa`` (3.09 GB) and ``reads.fa`` of ``human_inputs``
    into ``directory``.  Returns {read name: (chrom, start0, strand)}."""
    return write_case(directory, *human_inputs(seed))



# GRCh38's gap classes (the UCSC hg38 ``gap`` table's telomere, short_arm,
# heterochromatin and scaffold) in a layout of this module's own, not
# GRCh38's coordinates: 10 kb of telomere at both ends of every
# chromosome, the short arms of the acrocentric chromosomes (their first
# Mbp, the telomere included), three blocks of heterochromatin (chr1's
# holds chr1 position 2^27, a batch boundary of the index scan; chrY's
# lies past 2^31) and a 100-N scaffold gap every 10 Mbp outside them
TELOMERE_LEN = 10_000
SHORT_ARMS = {"chr13": 16_000_000, "chr14": 16_000_000,
              "chr15": 17_000_000, "chr21": 5_000_000, "chr22": 10_500_000}
HETEROCHROMATIN = [("chr1", 125_200_000, 18_000_000),
                   ("chr9", 41_000_000, 20_000_000),
                   ("chrY", 26_700_000, 30_000_000)]
SCAFFOLD_EVERY, SCAFFOLD_LEN = 10_000_000, 100


def gap_layout(chroms, short_arms, heterochromatin, scaffold_every):
    """N blocks over ``chroms`` = [(name, length)]: a telomere at both
    ends of each, ``short_arms`` {name: end} (the first telomere
    included), ``heterochromatin`` [(name, start0, length)] and a
    SCAFFOLD_LEN run every ``scaffold_every`` bp outside those.  Returns
    ((chrom, start0, length, class), ...) sorted by chromosome (in
    ``chroms``' order) and start, disjoint."""
    out = []
    for name, n in chroms:
        big = [(0, TELOMERE_LEN, "telomere"),
               (n - TELOMERE_LEN, TELOMERE_LEN, "telomere")]
        if name in short_arms:
            big.append((TELOMERE_LEN, short_arms[name] - TELOMERE_LEN,
                        "short_arm"))
        big += [(s, ln, "heterochromatin") for c, s, ln in heterochromatin
                if c == name]
        scaffold = [(p, SCAFFOLD_LEN, "scaffold")
                    for p in range(scaffold_every, n, scaffold_every)
                    if all(p + SCAFFOLD_LEN <= s or p >= s + ln
                           for s, ln, _ in big)]
        out += [(name, s, ln, cls) for s, ln, cls in sorted(big + scaffold)]
    return tuple(out)


# 132,958,700 bp of N in 343 blocks
HUMAN_GAPS = gap_layout(GRCH38, SHORT_ARMS, HETEROCHROMATIN, SCAFFOLD_EVERY)
# human_gaps_case's reads by group, in file order: holding 1-9 kb of a
# block of >= 10 kb at its left or right edge (half each), ending at the
# base before a block or starting at the base after one (half each),
# holding a scaffold gap 2-8 kb in, and from the N-free windows
HUMAN_GAPS_READS = {"edge": 128, "flank": 64, "scaffold": 32, "far": 288}


def _gap_runs(layout):
    """``layout``'s blocks with adjacent ones merged: [(chrom, start0,
    end0)], the genome's N runs."""
    runs = []
    for c, s, ln, _ in layout:
        if runs and runs[-1][0] == c and runs[-1][2] == s:
            runs[-1] = (c, runs[-1][1], s + ln)
        else:
            runs.append((c, s, s + ln))
    return runs


def gapped_genome(rng, chroms, layout) -> GenomeStore:
    """Uniform random bases over ``chroms`` = [(name, length)] (drawn as
    ``human_inputs`` draws them), N written over ``layout``'s blocks."""
    by_chrom = {}
    for c, s, ln, _ in layout:
        by_chrom.setdefault(c, []).append((s, ln))
    store = GenomeStore()
    for name, n in chroms:
        bases = uniform_bases(rng, n)
        for s, ln in by_chrom.get(name, []):
            bases[s:s + ln] = ord("N")
        store.add_chromosome(name, bases)
    return store.finalize()


def gapped_reads(rng, store, layout, groups):
    """Reads of HUMAN_READ_LEN over a genome with N at ``layout``, in the
    groups of ``groups`` (HUMAN_GAPS_READS's four, with their counts), in
    file order; error 0.04 / 0.03 / 0.03, random strand, a read's bases
    inside N uniform random bases (what a sequencer reads behind a gap).
    Returns [(name, seq, (chrom, start0, strand))]."""
    chrom_len = {c.name: c.length_unpadded for c in store.chromosomes}
    runs = _gap_runs(layout)
    span = HUMAN_READ_LEN
    big = [r for r in runs if r[2] - r[1] >= 10_000]
    lefts = [(c, s) for c, s, _ in big if s > 0]
    rights = [(c, e) for c, _, e in big if e < chrom_len[c]]
    half = groups["edge"] // 2
    # (chromosome, start0) of each read, in file order
    spans = [(c, s - span + int(o)) for (c, s), o in zip(
        (lefts[j % len(lefts)] for j in range(half)),
        rng.integers(1000, 9001, half))]
    spans += [(c, e - int(o)) for (c, e), o in zip(
        (rights[j % len(rights)] for j in range(half)),
        rng.integers(1000, 9001, half))]
    half = groups["flank"] // 2
    flank_l = [(c, s - span) for c, s, _ in runs if s >= span]
    flank_r = [(c, e) for c, _, e in runs if e + span <= chrom_len[c]]
    spans += [flank_l[int(i)] for i in rng.integers(0, len(flank_l), half)]
    spans += [flank_r[int(i)] for i in rng.integers(0, len(flank_r), half)]
    scaffold = [(c, s) for c, s, _, cls in layout if cls == "scaffold"]
    n = groups["scaffold"]
    spans += [(scaffold[int(i)][0], scaffold[int(i)][1] - int(d))
              for i, d in zip(rng.integers(0, len(scaffold), n),
                              rng.integers(2000, 8001, n))]
    # every N-free window: each chromosome begins and ends in a telomere,
    # so they lie between two runs of one chromosome; (chrom, first start,
    # count of starts)
    free = [(c, e, s2 - e - span + 1) for (c, _, e), (c2, s2, _)
            in zip(runs, runs[1:]) if c == c2 and s2 - e >= span]
    count = np.array([f[2] for f in free], np.int64)
    cum = np.cumsum(count)
    u = rng.integers(0, int(cum[-1]), groups["far"])
    idx = np.searchsorted(cum, u, side="right")
    spans += [(free[i][0], free[i][1] + int(x - cum[i] + count[i]))
              for i, x in zip(idx, u)]
    chroms = {c.name: c for c in store.chromosomes}
    reads = []
    for i, (name, start) in enumerate(spans):
        c = chroms[name]
        seq = store.bases[c.start + start:c.start + start + span].copy()
        gap = seq == ord("N")
        seq[gap] = uniform_bases(rng, int(gap.sum()))
        seq = mutate_read(rng, seq)
        strand = "+" if rng.random() < 0.5 else "-"
        if strand == "-":
            seq = revcomp_bytes(seq)
        reads.append((f"read{i}_{name}_{start}_{strand}", seq,
                      (name, start, strand)))
    return reads


def human_gaps_inputs(seed: int):
    """``human_inputs``' genome (the same bases) with N written over
    HUMAN_GAPS, and ``gapped_reads``' 512 reads in HUMAN_GAPS_READS's
    groups.  Returns (store, [(name, seq, (chrom, start0, strand))])."""
    rng = np.random.default_rng(seed)
    store = gapped_genome(rng, GRCH38, HUMAN_GAPS)
    return store, gapped_reads(rng, store, HUMAN_GAPS, HUMAN_GAPS_READS)


def human_gaps_case(seed: int, directory: str) -> dict:
    """Write ``ref.fa`` (3.09 GB) and ``reads.fa`` of ``human_gaps_inputs``
    into ``directory``.  Returns {read name: (chrom, start0, strand)}."""
    return write_case(directory, *human_gaps_inputs(seed))
