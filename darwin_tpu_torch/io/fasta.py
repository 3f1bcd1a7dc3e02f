"""FASTA/FASTQ reading (kseq-equivalent, software/main.cpp:31,413-466).

Plain and gzip-compressed files.  Yields (name, sequence-bytes) pairs; the
name is the first whitespace-delimited token of the header, matching kseq's
``name`` field used for Read.description (software/main.cpp:434,666).

The port's own copy of ``darwin_tpu/io/fasta.py``.
"""

from __future__ import annotations

import gzip
import io
from typing import Iterator, Tuple

import numpy as np

from darwin_tpu_torch import native
from darwin_tpu_torch.genome import GenomeStore, make_read


def _open_maybe_gzip(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f, "rb")
    return f


def iter_fasta(path: str,
               chunk_bytes: int = 1 << 26) -> Iterator[Tuple[str, np.ndarray]]:
    """Iterate (name, seq_bytes).  Supports FASTA ('>') and FASTQ ('@').

    Plain FASTA files go through the native C++ scanner when available
    (csrc/darwin_native.cpp::fasta_scan), streamed in ``chunk_bytes``
    pieces cut at record boundaries so memory stays bounded (the
    reference's wrap-around read cursor analog, software/main.cpp:655-698);
    gzip/FASTQ use the line-streaming Python path.
    """
    with open(path, "rb") as probe:
        head = probe.read(2)
    if head[:1] == b">":
        if native.fasta_scan_native(b">x\nA\n") is not None:
            with open(path, "rb") as f:
                # accumulate chunks in a list and search only the NEW data
                # for a record boundary — one pass regardless of record
                # size (an 800 Mbp chromosome spans many chunks)
                parts: list[bytes] = []
                ends_nl = False
                while True:
                    data = f.read(chunk_bytes)
                    if not data:
                        break
                    cut = data.rfind(b"\n>")
                    if cut >= 0:
                        part = b"".join(parts) + data[:cut + 1]
                        parts = [data[cut + 1:]]
                    elif ends_nl and data[:1] == b">":
                        # boundary straddles the chunk edge
                        part = b"".join(parts)
                        parts = [data]
                    else:
                        parts.append(data)
                        ends_nl = data.endswith(b"\n")
                        continue
                    ends_nl = data.endswith(b"\n")
                    if part:
                        names, seqs = native.fasta_scan_native(part)
                        yield from zip(names, seqs)
                tail = b"".join(parts)
                if tail:
                    names, seqs = native.fasta_scan_native(tail)
                    yield from zip(names, seqs)
            return
    with _open_maybe_gzip(path) as fh:
        reader = io.BufferedReader(fh) if not isinstance(fh, io.BufferedReader) else fh
        name = None
        chunks: list[bytes] = []
        fastq_state = 0  # 0: not fastq; 1: in seq; 2: in quality
        qual_left = 0
        for raw in reader:
            line = raw.rstrip(b"\r\n")
            if not line:
                continue
            lead = line[:1]
            if fastq_state == 2:
                # quality lines are counted against the sequence length —
                # they may legally start with '@' or '+', so leading
                # characters mean nothing here (kseq does the same)
                qual_left -= len(line)
                if qual_left <= 0:
                    fastq_state = 0
                continue
            if lead == b">" or lead == b"@":
                if name is not None:
                    yield name, np.frombuffer(b"".join(chunks), dtype=np.uint8)
                name = line[1:].split()[0].decode() if len(line) > 1 else ""
                chunks = []
                fastq_state = 1 if lead == b"@" else 0
            elif lead == b"+" and fastq_state == 1:
                # FASTQ separator: emit record, then consume exactly
                # len(seq) quality bytes
                seq = b"".join(chunks)
                if name is not None:
                    yield name, np.frombuffer(seq, dtype=np.uint8)
                name = None
                chunks = []
                qual_left = len(seq)
                fastq_state = 2 if qual_left else 0
            else:
                chunks.append(line)
        if name is not None:
            yield name, np.frombuffer(b"".join(chunks), dtype=np.uint8)


def load_genome(path: str, min_len: int = 64):
    """Load a reference FASTA into a GenomeStore.

    Sequences of length <= min_len are skipped; note the reference *stops
    reading entirely* at the first such sequence (software/main.cpp:428-465
    returns false from the source node), which looks unintentional — we skip
    and continue, documenting the divergence.
    """
    store = GenomeStore()
    for name, seq in iter_fasta(path):
        if len(seq) > min_len:
            store.add_chromosome(name, seq)
    return store.finalize()


def load_reads(path: str, min_len: int = 64):
    """Load reads; reads of length <= min_len are skipped
    (software/main.cpp:655)."""
    return [make_read(name, seq) for name, seq in iter_fasta(path)
            if len(seq) > min_len]


def count_reads(path: str, min_len: int = 64) -> int:
    """Number of reads load_reads would yield — one cheap streaming pass
    (used to shard the stream across hosts without materializing it)."""
    return sum(1 for _, seq in iter_fasta(path) if len(seq) > min_len)


def iter_read_batches(path: str, batch_size: int, min_len: int = 64,
                      start: int | None = None, stop: int | None = None):
    """Stream reads as ready-to-align batches with bounded memory: only
    ``batch_size`` reads (plus their reverse complements) are materialized
    at a time.  [start, stop) selects a read-index slice (multi-host
    sharding); None means the whole stream."""
    batch = []
    idx = 0
    for name, seq in iter_fasta(path):
        if len(seq) <= min_len:
            continue
        keep = ((start is None or idx >= start)
                and (stop is None or idx < stop))
        idx += 1
        if not keep:
            if stop is not None and idx >= stop:
                break
            continue
        batch.append(make_read(name, seq))
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch:
        yield batch
