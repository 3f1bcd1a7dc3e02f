"""Reference outputs of the real-size cases, read from
``darwin_tpu_torch/goldens/real_size.json``, and the comparison that holds
a run to them.

The file is data: ``tests/test_torch_goldens.py --make`` writes it from
darwin_tpu's CLI run on the CPU over the same inputs, made by this
package's own generators (``utils/synth.py``) at ``SEED``.  For each case
it keeps the inputs' sha256, stdout's sha256 and record count, one digest
per record in output order and the 7-line counter block; no read
sequence and no whole SAM.  ``chip_smoke.py`` writes each case, checks
the inputs against the file (a mismatch is generator drift), runs the
CLI on the card and checks stdout and the counter block."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from darwin_tpu_torch.utils import synth

PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "goldens", "real_size.json")
SEED = 0          # chip_smoke.py's default --seed

# case -> the generator (a function of utils/synth.py), the CLI's argv and
# params.cfg, the input files hashed, and the reads subset: every
# ``subset``-th record of reads.fa, in file order, into reads_sub.fa; with
# ``index``, the entry also keeps ``index_entry`` of the csr table the run
# built
CASES = {
    "ecoli": {"generator": "ecoli_case", "argv": ["ref.fa", "reads.fa", "0"],
              "params_cfg": None, "inputs": ["ref.fa", "reads.fa"]},
    "ecoli_generic": {"generator": "ecoli_case",
                      "argv": ["ref.fa", "reads.fa", "0"],
                      "params_cfg": synth.GENERIC_PARAMS_CFG,
                      "inputs": ["ref.fa", "reads.fa"]},
    "overlap": {"generator": "overlap_case",
                "argv": ["reads.fa", "reads.fa", "1"], "params_cfg": None,
                "inputs": ["reads.fa"]},
    "chr21_sub": {"generator": "chr21_case",
                  "argv": ["ref.fa", "reads_sub.fa", "0"],
                  "params_cfg": None, "subset": 32,
                  "inputs": ["ref.fa", "reads.fa", "reads_sub.fa"]},
    "human": {"generator": "human_case",
              "argv": ["ref.fa", "reads.fa", "0", "--index-layout=csr"],
              "params_cfg": None, "inputs": ["ref.fa", "reads.fa"]},
    "human_gaps": {"generator": "human_gaps_case",
                   "argv": ["ref.fa", "reads.fa", "0", "--index-layout=csr"],
                   "params_cfg": None, "inputs": ["ref.fa", "reads.fa"],
                   "index": True},
}
MAX_SHOWN = 20    # differing records named on a mismatch


def index_digest(meta, offsets, positions) -> str:
    """sha256 of a csr table as darwin_tpu's .npz holds it: ``meta`` (k,
    w, ref_size, kmer_max_occurence) int64, the bucket ``offsets`` int32
    and ``positions`` uint32, each little-endian in C order, in that
    order."""
    h = hashlib.sha256()
    for a, dt in ((meta, "<i8"), (offsets, "<i4"), (positions, "<u4")):
        # a no-op for arrays already of that type; int32 bit patterns of
        # positions wrap to their uint32 values
        a = np.ascontiguousarray(np.asarray(a).astype(dt, copy=False))
        for i in range(0, a.size, 1 << 26):
            h.update(a[i:i + (1 << 26)])
    return h.hexdigest()


def index_entry(meta, offsets, positions) -> dict:
    """A goldens entry's ``index``: the digest, the seed count and the
    largest bucket as [hash, count] (the lowest hash of the largest)."""
    sizes = np.diff(np.asarray(offsets, np.int64))
    h = int(np.argmax(sizes))
    return {"sha256": index_digest(meta, offsets, positions),
            "seeds": int(np.asarray(positions).size),
            "largest_bucket": [h, int(sizes[h])]}


def load(path: str = PATH) -> dict:
    """{case: entry} of the goldens file."""
    with open(path) as f:
        return json.load(f)["cases"]


def sha256_file(path: str) -> dict:
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
            n += len(chunk)
    return {"sha256": h.hexdigest(), "bytes": n}


def input_digests(directory: str, names) -> dict:
    return {n: sha256_file(os.path.join(directory, n)) for n in names}


def records(stdout: str, overlap: bool) -> list[str]:
    """The output's records: a SAM line (the header's apart), or an MHAP
    line with the two aligned strings that follow it (they hold no
    space)."""
    lines = stdout.splitlines()
    if not overlap:
        return [ln for ln in lines if not ln.startswith("@")]
    recs = []
    for ln in lines:
        if " " in ln or not recs:
            recs.append(ln)
        else:
            recs[-1] += "\n" + ln
    return recs


def record_digest(record: str, overlap: bool) -> list:
    """SAM: [QNAME, FLAG, RNAME, POS, sha256(line)[:16]]; MHAP: [id1, id2,
    sha256(record)[:16]]."""
    d = hashlib.sha256(record.encode()).hexdigest()[:16]
    if overlap:
        f = record.split(" ")
        return [f[0], f[1], d]
    f = record.split("\t")
    return [f[0], int(f[1]), f[2], int(f[3]), d]


def stdout_digest(stdout: str, overlap: bool) -> dict:
    data = stdout.encode()
    recs = records(stdout, overlap)
    return {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data),
            "records": len(recs),
            "digests": [record_digest(r, overlap) for r in recs]}


def diff_inputs(entry: dict, got: dict) -> list[str]:
    """One line per input file whose sha256 or size differs."""
    out = []
    for name, want in entry["inputs"].items():
        have = got.get(name)
        if have != want:
            out.append(f"{name}: {have} here, {want} in the golden (numpy "
                       f"{np.__version__} here, {entry['numpy']} there): "
                       f"the generator drew differently")
    return out


def keyed(digests, overlap):
    """{key: digest}: MHAP by pair, SAM by (QNAME, n-th record of it)."""
    out, seen = {}, {}
    for d in digests:
        name = f"{d[0]} {d[1]}" if overlap else d[0]
        i = seen[name] = seen.get(name, -1) + 1
        out[(name, i)] = d
    return out


def diff_outputs(entry: dict, stdout: str, blk: list[str]) -> list[str]:
    """Empty when stdout and the counter block equal the golden's; else
    the first MAX_SHOWN differing records, by QNAME (SAM) or pair (MHAP),
    with the fields that differ, and every differing counter line."""
    overlap = entry["argv"][2] == "1"
    got = stdout_digest(stdout, overlap)
    out = []
    if got["sha256"] != entry["stdout"]["sha256"]:
        out.append(f"stdout: sha256 {got['sha256']}, {got['records']} "
                   f"records, {got['bytes']} bytes; the golden's "
                   f"{entry['stdout']['sha256']}, {entry['stdout']['records']}"
                   f" records, {entry['stdout']['bytes']} bytes")
        want_k = keyed(entry["digests"], overlap)
        got_k = keyed(got["digests"], overlap)
        fields = ["id1", "id2"] if overlap else ["QNAME", "FLAG", "RNAME",
                                                 "POS"]
        bad = []
        for k, w in want_k.items():
            g = got_k.get(k)
            if g is None:
                bad.append(f"{k[0]} #{k[1]}: missing here")
            elif g != w:
                what = [f"{f} {gv} (golden {wv})" for f, gv, wv in
                        zip(fields, g, w) if gv != wv] or ["rest of line"]
                bad.append(f"{k[0]} #{k[1]}: " + ", ".join(what))
        bad += [f"{k[0]} #{k[1]}: not in the golden" for k in got_k
                if k not in want_k]
        if not bad:
            bad = ["the same records in another order, or another header"]
        out += bad[:MAX_SHOWN]
        if len(bad) > MAX_SHOWN:
            out.append(f"... {len(bad) - MAX_SHOWN} more differing records")
    want_b = entry["counters"]
    if blk != want_b:
        out += [f"counter {g!r}, golden {w!r}" for g, w in
                zip(blk + [""] * len(want_b), want_b + [""] * len(blk))
                if g != w]
    return out
