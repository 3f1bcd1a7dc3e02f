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


def test_mode_bounds_take_the_pipe_each_mode_issues_on():
    """Each mode's bound is its own operations on the pipes that can issue
    them: the ALU-only ones (min / max, logic) over 64 lanes, all of them
    over the ALU and FMA pipes' 128.  The compiled chain's SASS goes
    through the same rule beside it (multiplies on the FMA pipe, adds in
    the shared term, shuffles on their 32 lanes), as a diagnostic that
    never sets the bound; memory and control opcodes count nowhere."""
    sass = {
        "_ZN12_GLOBAL__N_116int_probe_kernelILi0EEEvPKiPi": {
            "all": {"VIMNMX": 900, "IMAD": 789, "IADD3": 24, "LDG": 12,
                    "BRA": 3}},
        "_ZN12_GLOBAL__N_116int_probe_kernelILi2EEEvPKiPi": {
            "all": {"VIMNMX": 766, "IMAD": 30, "VIADD": 1181,
                    "IADD3": 382}},
        "_ZN12_GLOBAL__N_116int_probe_kernelILi3EEEvPKiPi": {
            "all": {"SHFL": 2000, "VIMNMX": 10}},
        "_ZN12_GLOBAL__N_114gact_dp_kernelILi6ELb1EEEvPKh": {
            "all": {"VIMNMX": 5}},
    }
    programs = 8192
    got = vpu_probe.mode_bounds(programs, sass)
    assert set(got) == set(vpu_probe.MODES)
    elements = programs * vpu_probe.QT * vpu_probe.LANES
    threads = programs * (vpu_probe.LANES // 8) * 256
    assert threads == programs * 16 * 256

    def ms(n, per, lanes):
        return n * per / (lanes * 132 * 1.98e9) * 1e3
    # max: 64 maxes and 64 adds per element, y = x + 1 and x + y: the
    # maxes are half, so all 130 over 128 lanes bind (1.5647 ms)
    assert got["max"]["ops"] == [64, 130]
    assert got["max"]["bound_pipe"] == "alu+fma"
    assert got["max"]["bound_ms"] == pytest.approx(ms(elements, 130, 128))
    assert got["max"]["bound_ms"] == pytest.approx(1.5647, abs=1e-4)
    assert got["add"]["ops"] == [64, 130]
    assert got["sel"]["ops"] == [64, 194]       # a min and two adds a rep
    assert got["shift"]["ops"] == [64, 130]     # the row shift is a move
    assert got["max4"]["ops"] == [65, 134]
    for b in got.values():
        assert b["bound_pipe"] == "alu+fma"
    # the compiled split: max's extra ALU instructions set its floor
    c = got["max"]["compiled"]
    assert c["pipes"] == {"alu": 900, "fma": 789, "add": 24, "shfl": 0}
    assert c["other"] == {"LDG": 12, "BRA": 3}
    assert c["floor_pipe"] == "alu"
    assert c["floor_ms"] == pytest.approx(ms(threads, 900, 64))
    c = got["sel"]["compiled"]
    assert c["floor_pipe"] == "alu+fma"
    assert c["floor_ms"] == pytest.approx(ms(threads, 766 + 30 + 1563, 128))
    c = got["shift"]["compiled"]
    assert c["floor_pipe"] == "shfl"
    assert c["floor_ms"] == pytest.approx(ms(threads, 2000, 32))
    assert "compiled" not in got["add"]
    assert vpu_probe.mode_bounds(programs)["sel"]["bound_ms"] == \
        got["sel"]["bound_ms"]
