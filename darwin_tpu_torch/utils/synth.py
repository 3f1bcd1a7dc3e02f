"""Synthetic inputs for runs on the card: random genomes, reads across a
planted deletion, the E. coli K-12-size reference-guided case, the
overlap case, the chr21-size repeat-genome case and the GRCh38-size
case that ``chip_smoke.py`` and ``tools/profile_align.py`` align, and the
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
