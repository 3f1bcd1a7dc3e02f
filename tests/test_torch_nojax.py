"""The port must run where neither jax nor darwin_tpu is installed: a child
process with ``sys.modules["jax"] = None`` and ``sys.modules["darwin_tpu"]
= None`` (any import of either raises) imports every module of
darwin_tpu_torch and chip_smoke.py, and aligns a tiny genome through the
CLI on the CPU in both modes, and on a CPU mesh of 2 with the sharded
index; a source scan refuses an import of either in the package and in
chip_smoke.py."""

import os
import pkgutil
import re
import subprocess
import sys

import darwin_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import importlib, io, contextlib, os, sys
sys.modules["jax"] = None
sys.modules["darwin_tpu"] = None
import numpy as np
for name in MODULES:
    importlib.import_module(name)
import chip_smoke
from darwin_tpu_torch import cli
from darwin_tpu_torch.genome import GenomeStore
from darwin_tpu_torch.utils.simulate import simulate_reads, write_fasta
rng = np.random.default_rng(0)
g = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 30000)]
store = GenomeStore.from_numpy(["c"], [g])
os.chdir(sys.argv[1])
with open("ref.fa", "w") as f:
    f.write(">c\n" + g.tobytes().decode() + "\n")
write_fasta("reads.fa", simulate_reads(store, 3, 1500, seed=1))
open("params.cfg", "w").write("[DSOFT_params]\nseed_size = 10\n")
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert cli.main(["ref.fa", "reads.fa", "0", "--device=cpu"]) == 0
print("SAM_RECORDS", sum(1 for l in out.getvalue().splitlines()
                         if not l.startswith("@")))
sam = out.getvalue()
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert cli.main(["ref.fa", "reads.fa", "0", "--device=cpu", "--mesh=2",
                     "--shard-index"], spec_k=1) == 0
print("MESH_SAM_SAME", out.getvalue() == sam)
open("params.cfg", "w").write("[DSOFT_params]\nseed_size = 10\n"
                              "[GACT_first_tile]\nmin_overlap = 300\n")
with open("ovl.fa", "w") as f:
    for i, st in enumerate((0, 700, 1400)):
        f.write(f">o{i}\n" + g[st:st + 1500].tobytes().decode() + "\n")
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert cli.main(["ovl.fa", "ovl.fa", "1", "--device=cpu"]) == 0
print("MHAP_RECORDS", sum(1 for l in out.getvalue().splitlines()
                          if " " in l))
for name in ("jax", "darwin_tpu"):
    assert sys.modules[name] is None
assert not [m for m in sys.modules if m.startswith(("jax.", "darwin_tpu."))]
"""


def _modules():
    names = ["darwin_tpu_torch"]
    for m in pkgutil.walk_packages(darwin_tpu_torch.__path__,
                                   "darwin_tpu_torch."):
        names.append(m.name)
    return names


def test_port_imports_and_runs_without_jax(tmp_path):
    mods = _modules()
    assert "darwin_tpu_torch.ops.gact_cuda" in mods
    assert "darwin_tpu_torch.pipeline.align" in mods
    assert {"darwin_tpu_torch.index.minimizers",
            "darwin_tpu_torch.index.seed_table",
            "darwin_tpu_torch.seeding.dsoft",
            "darwin_tpu_torch.utils.synthgenome",
            "darwin_tpu_torch.parallel.shard",
            "darwin_tpu_torch.parallel.shard_index",
            "darwin_tpu_torch.parallel.multihost"} <= set(mods)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", f"MODULES = {mods!r}\n" + CHILD,
         str(tmp_path)], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n = int(re.search(r"SAM_RECORDS (\d+)", proc.stdout).group(1))
    assert n >= 2
    assert "MESH_SAM_SAME True" in proc.stdout
    n = int(re.search(r"MHAP_RECORDS (\d+)", proc.stdout).group(1))
    assert n >= 4                 # o0-o1 and o1-o2, each from both sides


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "darwin_tpu_torch")):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return paths


def test_no_jax_import_in_the_port():
    pat = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    for path in _port_sources():
        with open(path) as fh:
            assert not pat.search(fh.read()), path


def test_no_darwin_tpu_import_in_the_port():
    """``darwin_tpu_torch`` is fine, ``darwin_tpu`` (the JAX package, its
    jax-free modules included) is not: only the tests import it."""
    pat = re.compile(r"^\s*(import|from)\s+darwin_tpu\b(?!_)", re.M)
    assert pat.search("from darwin_tpu.genome import X")
    assert pat.search("    import darwin_tpu")
    assert not pat.search("from darwin_tpu_torch.genome import X")
    paths = _port_sources()
    assert len(paths) > 25
    for path in paths:
        with open(path) as fh:
            assert not pat.search(fh.read()), path
