"""Sequence store + chromosome registry.

Replaces the reference's flat 4 GiB DRAM buffer + Index globals
(software/DRAM.{h,cpp}, software/Index.{h,cpp}) with a host byte buffer
mirrored by a device uint8 code array.  The *coordinate space is kept
bit-identical to the reference*: a WORD_SIZE(=128)-byte 'N' guard block at
offset 0 (software/Index.cpp:10-17) and every chromosome padded with 'N' to a
multiple of 128 (software/main.cpp:438-449).  D-SOFT bins are computed from
absolute reference coordinates ((hit - offset) / bin_size,
software/seed_pos_table.cpp:319), so coordinate identity is required for
output identity.

Base encoding (ntcoding.h:3-7): A=0 C=1 G=2 T=3 N=4 (anything else -> N).
2-bit hashing view (software/ntcoding.cpp:79-92 and the PSHUFB table at
software/seed_pos_table.h:68-74): A=0 C=1 G=2 T=3, everything else -> 0.

The port's own copy of ``darwin_tpu/genome.py``.  ``GenomeStore.from_numpy``
and ``reads_from_numpy`` carry a genome and a read set across from
``darwin_tpu`` as plain numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

WORD_SIZE = 128  # software/DRAM.h:4

# char -> code lookup tables (case-insensitive, like NtChar2Int with
# is_ignore_lower=false, software/ntcoding.cpp:11-23)
_CODE5 = np.full(256, 4, dtype=np.uint8)
_CODE2 = np.zeros(256, dtype=np.uint8)
for i, c in enumerate("ACGT"):
    _CODE5[ord(c)] = i
    _CODE5[ord(c.lower())] = i
    _CODE2[ord(c)] = i
    _CODE2[ord(c.lower())] = i

_COMP = dict(zip(b"acgtACGTnN", b"tgcaTGCAnN"))
_COMP_TABLE = np.arange(256, dtype=np.uint8)
for a, b in _COMP.items():
    _COMP_TABLE[a] = b

_VALID_NT = np.zeros(256, dtype=bool)
for c in b"acgtACGTnN":
    _VALID_NT[c] = True


def encode5(seq_bytes: np.ndarray) -> np.ndarray:
    """ASCII uint8 -> 5-letter codes (0..4)."""
    return _CODE5[seq_bytes]


def encode2(seq_bytes: np.ndarray) -> np.ndarray:
    """ASCII uint8 -> 2-bit codes (0..3, N folded to 0) for hashing."""
    return _CODE2[seq_bytes]


def revcomp_bytes(seq_bytes: np.ndarray) -> np.ndarray:
    """Reverse complement of an ASCII sequence (RevComp,
    software/main.cpp:59-121).  Raises on non-ACGTN characters exactly like
    the reference (software/main.cpp:75-82)."""
    if not _VALID_NT[seq_bytes].all():
        bad = seq_bytes[~_VALID_NT[seq_bytes]][0]
        raise ValueError(f"Bad Nt char: {chr(bad)}")
    return _COMP_TABLE[seq_bytes[::-1]]


def pad_to(seq_bytes: np.ndarray, multiple: int, fill: int = ord("N")) -> np.ndarray:
    extra = (-len(seq_bytes)) % multiple
    if extra == 0:
        return seq_bytes
    return np.concatenate([seq_bytes, np.full(extra, fill, dtype=np.uint8)])


@dataclasses.dataclass
class Chromosome:
    name: str
    start: int              # absolute coordinate of first base (after guard)
    length: int             # padded length (Index::chr_len, software/main.cpp:453)
    length_unpadded: int    # Index::chr_len_unpadded


class GenomeStore:
    """Concatenated reference with reference-identical coordinates.

    ``bases``  : ASCII uint8, guard + padded chromosomes (host).
    ``codes2`` : 2-bit hashing codes (N->0).
    """

    def __init__(self):
        self.chromosomes: List[Chromosome] = []
        self._parts: List[np.ndarray] = [np.full(WORD_SIZE, ord("N"), np.uint8)]
        self._size = WORD_SIZE
        self._bases: np.ndarray | None = None
        self._bases_margin: tuple | None = None   # (margin, array) memo

    @classmethod
    def from_numpy(cls, names, arrays) -> "GenomeStore":
        """A finalized store from chromosome names and their unpadded ASCII
        uint8 sequences (e.g. ``bases[c.start:c.start + c.length_unpadded]``
        of another package's store): the same coordinates follow."""
        store = cls()
        for name, seq in zip(names, arrays):
            store.add_chromosome(str(name), np.asarray(seq, np.uint8))
        return store.finalize()

    def add_chromosome(self, name: str, seq_bytes: np.ndarray) -> Chromosome:
        padded = pad_to(seq_bytes, WORD_SIZE)
        if len(padded) >= 1 << 31:
            # the genome SPACE is uint32/4 GiB, but per-chromosome lengths
            # travel as int32 — check the stated invariant once at load
            raise ValueError(
                f"chromosome {name!r} is {len(padded)} bases after "
                f"{WORD_SIZE}-padding ({len(seq_bytes)} raw); single "
                "chromosomes must be < 2^31 including padding (the "
                "multi-chromosome genome space is uint32/4 GiB)")
        chrom = Chromosome(
            name=name,
            start=self._size,
            length=len(padded),
            length_unpadded=len(seq_bytes),
        )
        self.chromosomes.append(chrom)
        self._parts.append(padded)
        self._size += len(padded)
        self._bases = None
        self._bases_margin = None      # memo of bases_with_margin
        return chrom

    def finalize(self):
        if self._bases is None:
            self._bases = np.concatenate(self._parts)
            # collapse the per-chromosome parts into the concatenated
            # buffer: keeping both doubles resident memory for the life
            # of the store
            self._parts = [self._bases]
        return self

    def bases_with_margin(self, margin: int) -> np.ndarray:
        """``bases`` extended by ``margin`` trailing 'N' bytes, memoized.

        The extension decode paths index up to ``4 * large_tile_long``
        past the genome end; rebuilding this concat per read batch would
        be a full-genome host copy each batch."""
        cached = self._bases_margin
        if cached is not None and cached[0] == margin:
            return cached[1]
        arr = np.concatenate(
            [self.bases, np.full(margin, ord("N"), np.uint8)])
        self._bases_margin = (margin, arr)
        return arr

    @property
    def bases(self) -> np.ndarray:
        self.finalize()
        return self._bases

    @property
    def size(self) -> int:
        """Total coordinate-space size (== g_DRAM->referenceSize)."""
        return self._size

    @property
    def codes2(self) -> np.ndarray:
        return encode2(self.bases)

    # chr_coord in the reference holds the *starts* prefixed by the guard end
    # and is searched with upper_bound (e.g. software/filter.cpp:47).
    @property
    def chr_starts(self) -> np.ndarray:
        return np.array([c.start for c in self.chromosomes], dtype=np.int64)


@dataclasses.dataclass
class Read:
    name: str
    seq: np.ndarray       # ASCII uint8, unpadded
    rc_seq: np.ndarray    # ASCII uint8 reverse complement, unpadded

    @property
    def length(self) -> int:
        return len(self.seq)


def make_read(name: str, seq_bytes: np.ndarray) -> Read:
    return Read(name=name, seq=seq_bytes, rc_seq=revcomp_bytes(seq_bytes))


def reads_from_numpy(names, arrays) -> List[Read]:
    """Reads from names and ASCII uint8 sequences (forward strand)."""
    return [make_read(str(n), np.asarray(a, np.uint8))
            for n, a in zip(names, arrays)]
