"""darwin_tpu_torch's multi-host pieces (parallel/multihost.py, io/fasta's
read slicing) against darwin_tpu's on the same files, and a two-process
run on the CPU over gloo: ``python -m darwin_tpu_torch.parallel.multihost``
once per rank, whose merged SAM is run()'s, byte for byte, and whose
summed counters are run()'s.  Tolerance: none."""

import io
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

from darwin_tpu.io import fasta as jfasta
from darwin_tpu.parallel import multihost as jmh
from darwin_tpu_torch import native
from darwin_tpu_torch.genome import GenomeStore
from darwin_tpu_torch.io import fasta
from darwin_tpu_torch.parallel import multihost as mh
from darwin_tpu_torch.pipeline.align import run
from darwin_tpu_torch.utils.simulate import simulate_reads, write_fasta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS_CFG = ("[DSOFT_params]\nseed_size = 10\nthreshold = 20\n"
              "[GACT_first_tile]\nmin_overlap = 400\n")


def test_shard_reads_is_darwin_tpus():
    for n in (0, 1, 7, 16, 100):
        for p in (1, 2, 3, 8):
            spans = [mh.shard_reads(n, i, p) for i in range(p)]
            assert spans == [jmh.shard_reads(n, i, p) for i in range(p)]
            assert spans[0][0] == 0 and spans[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("shards", [
    [b"@HD\tVN:1.4\n@SQ\tSN:c\tLN:9\nr0\t0\tc\n",
     b"@HD\tVN:1.4\n@SQ\tSN:c\tLN:9\nr1\t0\tc\n", b"r2\t0\tc\n"],
    [b"", b"@HD\tVN:1.4\nr1\t0\tc\n", b"@HD\tVN:1.4\nr2\t0\tc\n"]],
    ids=["header-in-every-shard", "header-from-a-later-shard"])
def test_merge_shards_is_darwin_tpus(tmp_path, shards):
    """The header kept once, from the first shard that has one; shards
    deleted."""
    outs = []
    for mod, name in ((mh, "port.sam"), (jmh, "jax.sam")):
        out = str(tmp_path / name)
        for p, data in enumerate(shards):
            with open(mod.shard_path(out, p), "wb") as f:
                f.write(data)
        mod.merge_shards(out, len(shards))
        assert not os.path.exists(mod.shard_path(out, 0))
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]
    assert outs[0].count(b"@HD") == 1


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 20 kbp genome, 6 reads of 1.2 kb plus two of 64 bp and less (which
    every reader skips), as FASTA and as FASTQ; params.cfg for the CLI."""
    tmp = tmp_path_factory.mktemp("torch_multihost")
    rng = np.random.default_rng(11)
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 20_000)]
    with open(tmp / "ref.fa", "w") as f:
        f.write(">chrT\n" + genome.tobytes().decode() + "\n")
    store = GenomeStore.from_numpy(["chrT"], [genome])
    sim = simulate_reads(store, 6, 1200, seed=3)
    sim.insert(2, ("short1", genome[:64], None))
    sim.insert(5, ("short2", genome[100:130], None))
    write_fasta(str(tmp / "reads.fa"), sim)
    with open(tmp / "reads.fq", "w") as f:
        for name, seq, _ in sim:
            s = seq.tobytes().decode()
            f.write(f"@{name}\n{s}\n+\n{'@' * len(s)}\n")
    (tmp / "params.cfg").write_text(PARAMS_CFG)
    return tmp


@pytest.mark.parametrize("ext", ["fa", "fq"])
def test_count_and_slice_reads_is_darwin_tpus(files, ext):
    path = str(files / f"reads.{ext}")
    assert fasta.count_reads(path) == jfasta.count_reads(path) == 6
    for start, stop in ((None, None), (0, 3), (3, 6), (2, 5), (5, 9),
                        (6, None), (None, 1)):
        for bs in (1, 2, 4):
            got = [[(r.name, r.seq.tobytes()) for r in b]
                   for b in fasta.iter_read_batches(path, bs, start=start,
                                                    stop=stop)]
            want = [[(r.name, bytes(r.seq)) for r in b]
                    for b in jfasta.iter_read_batches(path, bs, start=start,
                                                      stop=stop)]
            assert got == want, (start, stop, bs)


def test_reduce_counters_on_one_process():
    c = {"num_reads": 3, "num_extend_tiles": 1 << 40}
    assert mh.reduce_counters(c) == c
    assert mh.init() == (0, 1)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_run_matches_run(files, monkeypatch):
    """Two ranks of ``python -m darwin_tpu_torch.parallel.multihost`` on
    this host over gloo (the CLI's params.cfg, run()'s defaults on the
    CPU): each aligns its half of the reads, rank 0 merges the shards into
    run()'s SAM bytes and prints run()'s counters summed — all but the
    extension rounds and the table's decode calls, which count per read
    batch.  Neither rank rebuilds the host library the test process
    already built."""
    from darwin_tpu_torch.config import load_config
    monkeypatch.chdir(files)
    cfg = load_config("params.cfg")
    out, err = io.StringIO(), io.StringIO()
    want = run("ref.fa", "reads.fa", False, cfg=cfg, out=out, err=err,
               device="cpu")
    lib = native._so_path()
    before = os.stat(lib)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "darwin_tpu_torch.parallel.multihost",
         "ref.fa", "reads.fa", "0", "multi.sam", "--coordinator", coord,
         "--num-processes", "2", "--process-id", str(r), "--device=cpu"],
        cwd=files, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-3000:]}"
    assert (files / "multi.sam").read_text() == out.getvalue()
    assert out.getvalue().count("\n") > 6
    assert not list(files.glob("multi.sam.shard*"))
    assert "[host 0/2] reads [0, 3)" in logs[0]
    assert "[host 1/2] reads [3, 6)" in logs[1]
    line = next(ln for ln in logs[0].splitlines()
                if ln.startswith("global counters: "))
    total = {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)", line)}
    per_batch = ("num_extend_rounds", "num_decode_calls")
    for k in per_batch:
        assert total.pop(k) > 0
    assert total == {k: v for k, v in want.items() if k not in per_batch}
    assert "global counters" not in logs[1]
    after = os.stat(lib)
    assert (after.st_ino, after.st_mtime_ns) == (before.st_ino,
                                                 before.st_mtime_ns)
