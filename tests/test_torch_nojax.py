"""The port must run where jax is not installed: a child process with
``sys.modules["jax"] = None`` (any jax import raises) imports every
module of darwin_tpu_torch and chip_smoke.py, and aligns a tiny genome
through the CLI on the CPU."""

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
import numpy as np
for name in MODULES:
    importlib.import_module(name)
import chip_smoke
from darwin_tpu.genome import GenomeStore
from darwin_tpu.utils.simulate import simulate_reads, write_fasta
from darwin_tpu_torch import cli
rng = np.random.default_rng(0)
g = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 30000)]
store = GenomeStore(); store.add_chromosome("c", g); store.finalize()
os.chdir(sys.argv[1])
with open("ref.fa", "w") as f:
    f.write(">c\n" + g.tobytes().decode() + "\n")
write_fasta("reads.fa", simulate_reads(store, 3, 1500, seed=1))
open("params.cfg", "w").write("[DSOFT_params]\nseed_size = 10\n")
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert cli.main(["ref.fa", "reads.fa", "0", "--device=cpu"]) == 0
assert "jax" not in sys.modules or sys.modules["jax"] is None
print("SAM_RECORDS", sum(1 for l in out.getvalue().splitlines()
                         if not l.startswith("@")))
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
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", f"MODULES = {mods!r}\n" + CHILD,
         str(tmp_path)], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n = int(re.search(r"SAM_RECORDS (\d+)", proc.stdout).group(1))
    assert n >= 2


def test_no_jax_import_in_the_port():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    for base, _, files in os.walk(os.path.join(ROOT, "darwin_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(base, f)) as fh:
                    assert not pat.search(fh.read()), f
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        assert not pat.search(fh.read())
