"""The int32 op-rate probe's plain twin (darwin_tpu_torch/tools/vpu_probe.py:
probe_plain, the CPU stand-in of csrc/int_probe.cu) against two witnesses:
tools/vpu_probe.py:probe_kernel itself, run through Pallas in interpret
mode (it is nested inside that file's main(), so its text is cut out of the
source and executed), and its semantics restated in numpy int32 with
two's-complement wraparound.  All five modes, exact equality; the chains
overflow int32 within their 64 reps, so wraparound is exercised."""

import functools
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from darwin_tpu_torch.ops import gact_cuda
from darwin_tpu_torch.tools import vpu_probe

torch.set_num_threads(2)

REPS = 64


def _kernel_semantics(x, mode):
    """tools/vpu_probe.py:63-93 on a (384, 128) int32 array; int64
    arithmetic wrapped back to int32 after every op."""
    def w(v):
        return ((v + (1 << 31)) % (1 << 32)) - (1 << 31)
    x = x.astype(np.int64)
    y = w(x + 1)
    if mode == "max":
        for _ in range(REPS):
            x = np.maximum(x, y)
            y = w(y + x)
    elif mode == "add":
        for _ in range(REPS):
            x = w(x + y)
            y = y ^ x
    elif mode == "sel":
        for _ in range(REPS):
            x = w(np.where(x > y, y, x) + 1)
            y = w(y + 1)
    elif mode == "shift":
        pad = np.zeros((1, x.shape[1]), np.int64)
        for _ in range(REPS):
            x = np.maximum(np.concatenate([pad, x[:-1]], 0), y)
            y = w(y + x)
    elif mode == "max4":
        a, b, c, d = x, y, w(x + 3), y ^ 5
        for _ in range(REPS // 2):
            a = np.maximum(a, b)
            b = w(b + 1)
            c = np.maximum(c, d)
            d = w(d + 3)
        x, y = w(a + c), w(b + d)
    return w(x + y).astype(np.int32)


def _original_probe_kernel():
    """probe_kernel of tools/vpu_probe.py, cut from ``def probe_kernel`` to
    the next ``def`` at its depth and executed with the constants it closes
    over."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "vpu_probe.py")
    with open(path) as f:
        lines = f.read().splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.lstrip().startswith("def probe_kernel("))
    depth = len(lines[start]) - len(lines[start].lstrip())
    end = next(i for i in range(start + 1, len(lines))
               if lines[i].startswith(" " * depth + "def "))
    scope = {"jnp": jnp, "QT": vpu_probe.QT, "LANES": vpu_probe.LANES,
             "REPS": REPS}
    exec(textwrap.dedent("\n".join(lines[start:end])), scope)
    return scope["probe_kernel"]


def _run_original(x, mode):
    """One program of the original kernel on the CPU, as its own build()
    calls it (tools/vpu_probe.py:95-106) with interpret=True."""
    call = pl.pallas_call(
        functools.partial(_original_probe_kernel(), mode=mode),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32), interpret=True)
    return np.asarray(call(jnp.asarray(x)))


def _block(seed, hi=1 << 20):
    rng = np.random.default_rng(seed)
    return rng.integers(-hi, hi, (vpu_probe.QT, vpu_probe.LANES)).astype(
        np.int32)


@pytest.mark.parametrize("mode", vpu_probe.MODES)
def test_probe_plain_matches_the_kernel_semantics(mode):
    x = _block(31)
    got = vpu_probe.probe_plain(torch.from_numpy(x), mode).numpy()
    want = _kernel_semantics(x, mode)
    assert got.dtype == np.int32 and got.shape == (384, 128)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _run_original(x, mode))
    if mode in ("max", "add", "shift"):
        # these chains double every rep: they must have wrapped
        assert np.abs(want.astype(np.int64)).max() > 1 << 24


@pytest.mark.parametrize("mode", vpu_probe.MODES)
def test_probe_plain_near_the_int32_edge(mode):
    x = _block(32, hi=(1 << 31) - 1)
    x[0, 0], x[1, 0] = np.iinfo(np.int32).max, np.iinfo(np.int32).min
    got = vpu_probe.probe_plain(torch.from_numpy(x), mode).numpy()
    np.testing.assert_array_equal(got, _kernel_semantics(x, mode))
    np.testing.assert_array_equal(got, _run_original(x, mode))


def test_probe_block_takes_the_twin_on_cpu_and_checks_inputs():
    x = torch.from_numpy(_block(33))
    before = dict(gact_cuda.LAUNCHES)
    for mode in vpu_probe.MODES:
        assert torch.equal(vpu_probe.probe_block(x, mode, programs=4),
                           vpu_probe.probe_plain(x, mode))
    assert gact_cuda.LAUNCHES == before        # the twin launches nothing
    with pytest.raises(ValueError):
        vpu_probe.probe_block(x, "mul")
    with pytest.raises(ValueError):
        vpu_probe.probe_block(x[:128], "max")
    with pytest.raises(TypeError):
        vpu_probe.probe_block(x.long(), "max")
    with pytest.raises(RuntimeError, match="cuda"):
        vpu_probe.probe(device="cpu")          # rates come from the card
