"""darwin_tpu's own output at real size, carried to the card as data.

Maker (darwin_tpu on the CPU; each case in a process of its own, all in
parallel; an entry is written as soon as its case finishes):

    JAX_PLATFORMS=cpu python tests/test_torch_goldens.py --make [CASE ...]

For each case of ``darwin_tpu_torch.utils.goldens.CASES`` it writes the
inputs with the port's generators (utils/synth.py) at chip_smoke.py's
default seed, as chip_smoke.py writes them, runs ``darwin_tpu.cli.main``
in that directory with the argv and params.cfg of chip_smoke.py's CLI run
of the case, and writes the case's entry of
``darwin_tpu_torch/goldens/real_size.json``: the inputs' sha256, stdout's
sha256 and a digest per record, the counter block, darwin_tpu's backend
and source tree, and the seconds the run took on the maker's CPU; for a
case with ``index`` (``human_gaps``) also the digest, seed count and
largest bucket of the csr table darwin_tpu's run built.  Make them again
after a change to utils/synth.py or to darwin_tpu.

The tests (no card): the file's schema, and that it was made from the
darwin_tpu source that stands here; the generators reproduce every
input's sha256 at the goldens' seed (the ``human`` and ``human_gaps``
cases' 3.09 GB ref.fa hashed from the store in memory, not written); the
``human`` and ``human_gaps`` cases' reads are where their generator says;
darwin_tpu and the port on the CPU give the same SAM and counter block on
four reads of the ``ecoli`` case against its whole 4.64 Mbp genome, at
run()'s defaults and at ``spec_k=1, pipeline_depth=1``; each record of
both runs there equals its digest in the ``ecoli`` golden."""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from darwin_tpu_torch.utils import goldens  # noqa: E402

# reads of the ecoli case held here: two of the 512 simulated reads and
# two of the 16 across the planted deletion
PARITY_READS = (0, 1, 512, 513)
CASE_TIMEOUT_S = 7200   # the maker's limit on one case's darwin_tpu run


# ---------------------------------------------------------------- maker

def _write_inputs(case, seed, directory):
    """Write ``case``'s input files (and params.cfg, if it has one) into
    ``directory`` with utils/synth.py, as chip_smoke.py writes them."""
    from darwin_tpu_torch.utils import synth
    spec = goldens.CASES[case]
    getattr(synth, spec["generator"])(seed, directory)
    if "subset" in spec:
        synth.subset_reads(f"{directory}/reads.fa",
                           f"{directory}/reads_sub.fa",
                           slice(None, None, spec["subset"]))
    if spec["params_cfg"] is not None:
        with open(f"{directory}/params.cfg", "w") as f:
            f.write(spec["params_cfg"])


def _counters(err_text):
    return [ln for ln in err_text.splitlines() if ln.startswith("#")]

def _tree(path):
    """git's tree hash of ``path`` at HEAD, and whether the working tree
    differs from it there."""
    def git(*a):
        return subprocess.run(["git", "-C", ROOT, *a], check=True,
                              capture_output=True, text=True).stdout.strip()
    return {"tree": git("rev-parse", f"HEAD:{path}"),
            "modified": bool(git("status", "--porcelain", "--", path))}


def make_entry(case: str, directory: str) -> dict:
    """Write ``case``'s inputs into ``directory``, run darwin_tpu's CLI on
    them there, and return the case's goldens entry."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("DARWIN_TPU_COMPILE_CACHE", "off")
    from darwin_tpu import cli as jcli
    from darwin_tpu.ops import dispatch as jdispatch
    spec = goldens.CASES[case]
    _write_inputs(case, goldens.SEED, directory)
    inputs = goldens.input_digests(directory, spec["inputs"])
    tables = []
    if spec.get("index"):
        # the table darwin_tpu's own run builds, kept for its digest
        from darwin_tpu.pipeline import align as jalign
        build = jalign.build_seed_table

        def kept(*a, **kw):
            tables.append(build(*a, **kw))
            return tables[-1]
        jalign.build_seed_table = kept
    out, err = io.StringIO(), io.StringIO()
    cwd = os.getcwd()
    os.chdir(directory)
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = jcli.main(list(spec["argv"]))
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise RuntimeError(f"{case}: darwin_tpu.cli exited {rc}:\n"
                           f"{err.getvalue()[-2000:]}")
    overlap = spec["argv"][2] == "1"
    dig = goldens.stdout_digest(out.getvalue(), overlap)
    blk = _counters(err.getvalue())
    if len(blk) != 7:
        raise RuntimeError(f"{case}: counter block {blk}")
    entry = {
        "generator": f"darwin_tpu_torch.utils.synth.{spec['generator']}"
                     f"({goldens.SEED}, directory)",
        "seed": goldens.SEED,
        "params_cfg": spec["params_cfg"],
        "argv": spec["argv"],
        "inputs": inputs,
        "numpy": np.__version__,
        "stdout": {k: dig[k] for k in ("sha256", "bytes", "records")},
        "digests": dig["digests"],
        "counters": blk,
        "darwin_tpu": {"backend": "pallas" if jdispatch.use_pallas()
                       else "lax", **_tree("darwin_tpu")},
        "reduced": None,
        "seconds": round(seconds, 1),
    }
    if spec.get("index"):
        (tb,) = tables
        entry["index"] = goldens.index_entry(
            np.array([tb.kmer_size, tb.minimizer_window, tb.ref_size,
                      tb.kmer_max_occurence], np.int64),
            np.asarray(tb.bucket_offsets), np.asarray(tb.positions))
    if "subset" in spec:
        with open(f"{directory}/reads_sub.fa") as f:
            n = f.read().count(">")
        entry["subset"] = spec["subset"]
        entry["reduced"] = (
            f"reads: one record in {spec['subset']} of reads.fa, in file "
            f"order from the first ({n} reads), into reads_sub.fa, for the "
            f"CPU's time; the genome whole")
    return entry


def _dump(data: dict) -> str:
    """JSON with every list of scalars on one line (a record per line)."""
    text = json.dumps(data, indent=1, sort_keys=True)
    return re.sub(r"\[\n\s*([^\[\]{}]*?)\n\s*\]",
                  lambda m: "[" + ", ".join(
                      x.strip() for x in m.group(1).split(",\n")) + "]",
                  text) + "\n"


def make(cases, path):
    """Run each case in a child process, in parallel; merge each entry
    into ``path`` as it comes (other cases' entries are kept)."""
    def child(case):
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--entry", case,
                 "--dir", d], capture_output=True, text=True,
                timeout=CASE_TIMEOUT_S, env={**os.environ, "JAX_PLATFORMS": "cpu"})
            if p.returncode != 0:
                raise RuntimeError(f"{case}: exit {p.returncode}\n"
                                   f"{p.stderr[-3000:]}")
            return json.loads(p.stdout.splitlines()[-1]), \
                time.perf_counter() - t0
    with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
        futs = {pool.submit(child, c): c for c in cases}
        failed = []
        for fut in concurrent.futures.as_completed(futs):
            case = futs[fut]
            try:
                entry, wall = fut.result()
            except (RuntimeError, subprocess.TimeoutExpired) as e:
                print(f"{case}: FAILED: {e}", flush=True)
                failed.append(case)
                continue
            data = {"cases": {}}
            if os.path.exists(path):
                with open(path) as f:
                    data = json.load(f)
            data["seconds"] = ("each case's seconds: darwin_tpu.cli.main's "
                               "wall time on the maker's CPU (JAX on the "
                               "CPU), not a device time")
            data["cases"][case] = entry
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path + ".tmp", "w") as f:
                f.write(_dump(data))
            os.replace(path + ".tmp", path)
            print(f"{case}: {entry['stdout']['records']} records, "
                  f"{entry['seconds']} s in darwin_tpu ({wall:.0f} s in all)",
                  flush=True)
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--make", nargs="*", metavar="CASE",
                    help="cases to make (all when none is named)")
    ap.add_argument("--out", default=goldens.PATH)
    ap.add_argument("--entry", help=argparse.SUPPRESS)
    ap.add_argument("--dir", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.entry:
        print(json.dumps(make_entry(args.entry, args.dir)))
        return 0
    if args.make is None:
        ap.error("nothing to do: pass --make [CASE ...]")
    cases = args.make or list(goldens.CASES)
    unknown = set(cases) - set(goldens.CASES)
    if unknown:
        ap.error(f"unknown cases {sorted(unknown)}")
    return 1 if make(cases, args.out) else 0


if __name__ == "__main__":
    sys.exit(main())


# ---------------------------------------------------------------- tests

def _git_tree(path):
    """git's tree hash of the files under ``path`` as they stand, without
    the __pycache__ and *.pyc that .gitignore lists (no .git needed); None
    for a directory that holds no such file."""
    entries = []
    for name in os.listdir(path):
        p = os.path.join(path, name)
        if name == "__pycache__" or name.endswith(".pyc"):
            continue
        if os.path.isdir(p):
            sha = _git_tree(p)
            if sha is not None:
                entries.append((name + "/", b"40000 %s\0%s" % (
                    name.encode(), bytes.fromhex(sha))))
            continue
        with open(p, "rb") as f:
            data = f.read()
        blob = hashlib.sha1(b"blob %d\0%s" % (len(data), data)).digest()
        mode = b"100755" if os.stat(p).st_mode & 0o111 else b"100644"
        entries.append((name, b"%s %s\0%s" % (mode, name.encode(), blob)))
    if not entries:
        return None
    body = b"".join(e for _, e in sorted(entries))
    return hashlib.sha1(b"tree %d\0%s" % (len(body), body)).hexdigest()


def _golden_file():
    if not os.path.exists(goldens.PATH):
        pytest.fail(f"{goldens.PATH} is missing: make it with --make")
    return goldens.load()


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """case -> a directory holding its inputs, written at the goldens'
    seed (one for the cases of one generator)."""
    dirs = {}

    def get(case):
        key = goldens.CASES[case]["generator"]
        if key not in dirs:
            d = tmp_path_factory.mktemp(key)
            _write_inputs(case, goldens.SEED, str(d))
            dirs[key] = str(d)
        return dirs[key]
    return get


@pytest.mark.parametrize("case", list(goldens.CASES))
def test_goldens_schema(case):
    entry = _golden_file()[case]
    spec = goldens.CASES[case]
    assert entry["argv"] == spec["argv"]
    assert entry["seed"] == goldens.SEED
    assert entry["params_cfg"] == spec["params_cfg"]
    assert sorted(entry["inputs"]) == sorted(spec["inputs"])
    for d in entry["inputs"].values():
        assert re.fullmatch(r"[0-9a-f]{64}", d["sha256"]) and d["bytes"] > 0
    assert re.fullmatch(r"[0-9a-f]{64}", entry["stdout"]["sha256"])
    overlap = spec["argv"][2] == "1"
    digests = entry["digests"]
    assert len(digests) == entry["stdout"]["records"] > 0
    for d in digests:
        assert len(d) == (3 if overlap else 5)
        assert re.fullmatch(r"[0-9a-f]{16}", d[-1])
    names = ["#reads", "#filter tiles", "#extend requests",
             "#slope filtered", "#extend tiles", "#active tiles",
             "#large tiles"]
    assert [ln.split(":")[0] for ln in entry["counters"]] == names
    assert all(ln.split(": ")[1].isdigit() for ln in entry["counters"])
    assert entry["darwin_tpu"]["backend"] in ("lax", "pallas")
    assert not entry["darwin_tpu"]["modified"]
    # made from the darwin_tpu that stands here: a stale golden fails now
    assert entry["darwin_tpu"]["tree"] == _git_tree(
        os.path.join(ROOT, "darwin_tpu"))
    assert (entry["reduced"] is not None) == ("subset" in spec)
    assert entry.get("subset") == spec.get("subset")
    # the csr table darwin_tpu's run built: digest, seeds, largest bucket
    assert ("index" in entry) == bool(spec.get("index"))
    if spec.get("index"):
        ix = entry["index"]
        assert sorted(ix) == ["largest_bucket", "seeds", "sha256"]
        assert re.fullmatch(r"[0-9a-f]{64}", ix["sha256"])
        h, n = ix["largest_bucket"]
        assert 0 <= h < 4 ** 14 and 0 < n < ix["seeds"]


@pytest.fixture(scope="module")
def human(tmp_path_factory):
    """The ``human`` case drawn once at the goldens' seed (5.8 GiB, freed
    on return): the inputs' digests, ref.fa's taken from the store in
    memory as ``write_reference`` would write it (3.09 GB, never written),
    reads.fa's from the file; {chromosome: (start, length)}; the truth."""
    from darwin_tpu_torch.utils import synth
    from darwin_tpu_torch.utils.simulate import write_fasta
    store, sim = synth.human_inputs(goldens.SEED)
    d = tmp_path_factory.mktemp("human_case")
    write_fasta(f"{d}/reads.fa", sim)
    digests = {**goldens.input_digests(str(d), ["reads.fa"]),
               "ref.fa": synth.reference_digest(store)}
    chroms = {c.name: (c.start, c.length_unpadded)
              for c in store.chromosomes}
    return digests, chroms, {n: t for n, _, t in sim}


@pytest.fixture(scope="module")
def human_gaps(tmp_path_factory):
    """The ``human_gaps`` case drawn once at the goldens' seed, as the
    ``human`` fixture draws its case: the inputs' digests (ref.fa from the
    store in memory, never written), {chromosome: (start, length)}, the
    truth, and for each read in file order its span's N: (count, offset
    of the first, first base N, last base N, the base before the span N,
    the base after it N)."""
    from darwin_tpu_torch.utils import synth
    from darwin_tpu_torch.utils.simulate import write_fasta
    store, sim = synth.human_gaps_inputs(goldens.SEED)
    d = tmp_path_factory.mktemp("human_gaps_case")
    write_fasta(f"{d}/reads.fa", sim)
    digests = {**goldens.input_digests(str(d), ["reads.fa"]),
               "ref.fa": synth.reference_digest(store)}
    chroms = {c.name: (c.start, c.length_unpadded)
              for c in store.chromosomes}
    is_n = []
    for _, _, (c, s0, _) in sim:
        g = chroms[c][0] + s0
        x = store.bases[g - 1:g + synth.HUMAN_READ_LEN + 1] == ord("N")
        is_n.append((int(x[1:-1].sum()), int(np.argmax(x[1:-1])),
                     bool(x[1]), bool(x[-2]), bool(x[0]), bool(x[-1])))
    return digests, chroms, {n: t for n, _, t in sim}, is_n


@pytest.mark.parametrize("case", list(goldens.CASES))
def test_generators_reproduce_golden_inputs(case, written, request):
    """utils/synth.py at the goldens' seed writes the files darwin_tpu
    read: a drift in the generators (or in numpy's streams) shows here
    before the card runs against the goldens."""
    entry = _golden_file()[case]
    drawn = {"human_case": "human", "human_gaps_case": "human_gaps"}
    gen = goldens.CASES[case]["generator"]
    if gen in drawn:
        got = request.getfixturevalue(drawn[gen])[0]
    else:
        got = goldens.input_digests(written(case), entry["inputs"])
    assert goldens.diff_inputs(entry, got) == []


def test_reference_digest_is_write_reference_bytes(tmp_path):
    """``reference_digest`` hashes the bytes ``write_reference`` writes:
    the human case's ref.fa is hashed in memory by it."""
    from darwin_tpu_torch.utils import synth
    rng = np.random.default_rng(3)
    store = synth.random_genome(rng, [("a", 1000), ("bb", 129), ("c", 7)])
    synth.write_reference(f"{tmp_path}/ref.fa", store)
    with open(f"{tmp_path}/ref.fa", "rb") as f:
        data = f.read()
    assert data.startswith(b">a\n") and data.count(b"\n") == 6
    assert synth.reference_digest(store) == goldens.sha256_file(
        f"{tmp_path}/ref.fa")


def test_human_reads_cross_2_31_and_end_the_space(human):
    """The ``human`` case's reads, in file order: 408 starting past 2^31
    (chr14 on), 8 ending at chrY's last base, 64 from chr1, 16 from chr13
    whose span holds global coordinate 2^31, 16 across the planted
    deletion in a chromosome past 2^31; as many as the golden's #reads."""
    from darwin_tpu_torch.utils import synth
    _, chroms, truth = human
    span = synth.HUMAN_READ_LEN
    kinds = []
    for name, (c, s0, strand) in truth.items():
        g = chroms[c][0] + s0
        assert name.endswith(f"_{c}_{s0}_{strand}")
        if name.startswith("del"):
            kind = "deletion"
            assert c == synth.DELETION_CHROM and g >= 1 << 31
        elif c == "chr13":
            kind = "straddle"
            assert g < 1 << 31 <= g + span - 1
        elif c == "chr1":
            kind = "chr1"
        elif c == "chrY" and s0 + span == chroms[c][1]:
            kind = "tail"
        else:
            kind = "far"
            assert g >= 1 << 31
        kinds.append(kind)
    # each kind is one run in file order, the counts HUMAN_READS's
    runs = [k for i, k in enumerate(kinds) if i == 0 or kinds[i - 1] != k]
    assert runs == list(synth.HUMAN_READS)
    assert {k: kinds.count(k) for k in runs} == {
        "far": 408, "tail": 8, "chr1": 64, "straddle": 16, "deletion": 16}
    assert chroms["chr14"][0] >= 1 << 31 > chroms["chr13"][0]
    blk = _golden_file()["human"]["counters"]
    assert blk[0] == f"#reads: {len(truth)}"


def test_human_gaps_reads_sit_at_the_gaps(human_gaps):
    """The ``human_gaps`` reads, in file order: 64 holding 1-9 kb of a
    block's left edge (N ending the span) and 64 of a right edge (N
    starting it), 32 ending at the base before a block and 32 starting at
    the base after one, 32 holding one 100-N scaffold gap 2-8 kb in, 288
    holding no N; as many as the golden's #reads."""
    from darwin_tpu_torch.utils import synth
    _, chroms, truth, is_n = human_gaps
    groups = [g for g, n in synth.HUMAN_GAPS_READS.items()
              for _ in range(n)]
    assert len(groups) == len(truth) == len(is_n) == 512
    edge, flank = (synth.HUMAN_GAPS_READS[g] for g in ("edge", "flank"))
    for i, ((name, (c, s0, strand)), g, (n, at, first, last, before,
                                          after)) in enumerate(
            zip(truth.items(), groups, is_n)):
        assert name == f"read{i}_{c}_{s0}_{strand}"
        assert 0 <= s0 and s0 + synth.HUMAN_READ_LEN <= chroms[c][1]
        if g == "edge":
            assert 1000 <= n <= 9000, name
            left = i < edge // 2
            assert (first, last) == (not left, left), name
        elif g == "flank":
            left = i < edge + flank // 2
            assert n == 0 and (after, before) == (left, not left), name
        elif g == "scaffold":
            assert n == synth.SCAFFOLD_LEN and 2000 <= at <= 8000, name
        else:
            assert n == 0, name
    # the edge reads are spread over the blocks of >= 10 kb
    assert len({c for (c, _, _), g in zip(truth.values(), groups)
                if g == "edge"}) == len(synth.GRCH38)
    blk = _golden_file()["human_gaps"]["counters"]
    assert blk[0] == f"#reads: {len(truth)}"


@pytest.fixture(scope="module")
def ecoli4(written):
    """Reads 0, 1, 512 and 513 of the ecoli case (two across the planted
    deletion) against its whole 4.64 Mbp genome, and darwin_tpu's SAM and
    counter block on them."""
    from darwin_tpu.config import Config as JConfig
    from darwin_tpu.pipeline.align import run as jax_run
    d = written("ecoli")
    from darwin_tpu_torch.utils import synth
    reads = f"{d}/reads4.fa"
    synth.subset_reads(f"{d}/reads.fa", reads, PARITY_READS)
    out, err = io.StringIO(), io.StringIO()
    jax_run(f"{d}/ref.fa", reads, False, cfg=JConfig(), out=out, err=err)
    return d, reads, out.getvalue(), _counters(err.getvalue())


@pytest.fixture(scope="module")
def port_sam():
    """The port's (SAM, counter block) on ecoli4's reads, by run() keywords,
    run once each."""
    import torch
    from darwin_tpu_torch.pipeline.align import run
    torch.set_num_threads(4)
    done = {}

    def get(d, reads, **kw):
        key = tuple(sorted(kw.items()))
        if key not in done:
            out, err = io.StringIO(), io.StringIO()
            run(f"{d}/ref.fa", reads, False, out=out, err=err, device="cpu",
                **kw)
            done[key] = (out.getvalue(),
                         _counters(err.getvalue()))
        return done[key]
    return get


K1 = {"spec_k": 1, "pipeline_depth": 1}


@pytest.mark.parametrize("kw", [{}, K1], ids=["defaults", "k1"])
def test_ecoli_reads_match_darwin_tpu_at_genome_length(ecoli4, port_sam, kw):
    d, reads, sam, blk = ecoli4
    assert len(goldens.records(sam, False)) >= 4
    assert int(blk[-1].split(":")[1]) > 0       # large tiles fired
    assert port_sam(d, reads, **kw) == (sam, blk)


def test_ecoli_records_match_golden_digests(ecoli4, port_sam):
    """A read's records do not depend on its batch-mates: darwin_tpu's and
    the port's records on the four reads are the records of darwin_tpu's
    run over the whole read set."""
    d, reads, sam, _ = ecoli4
    want = goldens.keyed(_golden_file()["ecoli"]["digests"], False)

    def digests(text):
        return goldens.keyed(goldens.stdout_digest(text, False)["digests"],
                             False)
    got, jax = digests(port_sam(d, reads, **K1)[0]), digests(sam)
    with open(reads) as f:
        names = {ln[1:].split()[0] for ln in f if ln.startswith(">")}
    assert {k[0] for k in got} == names
    assert jax == {k: want.get(k) for k in jax}
    assert got == {k: want.get(k) for k in got}


@pytest.mark.parametrize("overlap", [False, True], ids=["sam", "mhap"])
def test_diff_names_differing_records_and_counters(overlap):
    """What chip_smoke.py prints on a mismatch: the differing records by
    QNAME (SAM) or pair (MHAP) with the fields that differ, records
    missing or extra, and every differing counter line."""
    if overlap:
        recs = [f"r{i} r{i + 1} 0.100 900 0 1 1000 5000 0 1 1000 5000\n"
                f"ACGT\nACGA" for i in range(4)]
        text = "".join(r + "\n" for r in recs)
        bad = text.replace("ACGA", "ACGG", 1).replace(
            recs[3] + "\n", "") + "r9 r1 0.1 9 0 1 9 9 0 1 9 9\nA\nA\n"
        want = ["r0 r1 #0: rest of line", "r3 r4 #0: missing here",
                "r9 r1 #0: not in the golden"]
    else:
        recs = [f"q{i}\t0\tchr\t{100 * i + 1}\t60\t5M\t*\t0\t0\tACGTA\t*"
                for i in range(4)]
        text = "@HD\tVN:1.6\n" + "".join(r + "\n" for r in recs)
        bad = text.replace("\t201\t", "\t205\t").replace(
            "q1\t0", "q1\t16").replace("ACGTA\t*\nq1", "ACGTT\t*\nq1")
        want = ["q2 #0: POS 205 (golden 201)",
                "q1 #0: FLAG 16 (golden 0)", "q0 #0: rest of line"]
    blk = [f"#reads: {4}", "#filter tiles: 9"]
    entry = {"argv": ["a", "b", "1" if overlap else "0"],
             "stdout": {k: v for k, v in goldens.stdout_digest(
                 text, overlap).items() if k != "digests"},
             "digests": goldens.stdout_digest(text, overlap)["digests"],
             "counters": blk}
    assert goldens.diff_outputs(entry, text, blk) == []
    msg = goldens.diff_outputs(entry, bad, ["#reads: 4", "#filter tiles: 8"])
    assert msg[0].startswith("stdout: sha256")
    for w in want:
        assert any(w in m for m in msg), (w, msg)
    assert msg[-1] == "counter '#filter tiles: 8', golden '#filter tiles: 9'"
    # the same records in another order still fail, and say so
    body = goldens.records(text, overlap)
    other = ("@HD\tVN:1.6\n" if not overlap else "") + "".join(
        r + "\n" for r in body[::-1])
    assert goldens.diff_outputs(entry, other, blk)[1:] == [
        "the same records in another order, or another header"]
