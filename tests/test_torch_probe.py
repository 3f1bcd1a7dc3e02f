"""The int32 op-rate probe's plain twin (darwin_tpu_torch/tools/vpu_probe.py:
probe_plain, the CPU stand-in of csrc/int_probe.cu) against two witnesses:
tools/vpu_probe.py:probe_kernel itself, run through Pallas in interpret
mode (it is nested inside that file's main(), so its text is cut out of the
source and executed), and its semantics restated in numpy int32 with
two's-complement wraparound.  All five modes, exact equality; the chains
overflow int32 within their 64 reps, so wraparound is exercised.  Beside
them: csrc/int_probe.cu's persistent schedule transcribed in numpy (its
constants read from the source) against both, the SM clock readings'
parsing and statistics, and the compiled floor of the looped kernel."""

import functools
import os
import re
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
    over the ALU and FMA pipes' 128.  The compiled kernel's SASS goes
    through the same rule beside it (multiplies on the FMA pipe, adds in
    the shared term, shuffles on their 32 lanes), as a diagnostic that
    never sets the bound; memory and control opcodes count nowhere.  Its
    program loop runs once per program and column slice, the rest once
    per thread of the grid."""
    sass = {
        "_ZN12_GLOBAL__N_116int_probe_kernelILi0EEEvPKiPiij": {
            "all": {"VIMNMX": 900, "IMAD": 789, "IADD3": 24, "LDG": 12,
                    "BRA": 3},
            "loop": {"VIMNMX": 880, "IMAD": 789, "IADD3": 12, "BRA": 1}},
        "_ZN12_GLOBAL__N_116int_probe_kernelILi2EEEvPKiPiij": {
            "all": {"VIMNMX": 766, "IMAD": 30, "VIADD": 1181,
                    "IADD3": 382},
            "loop": {"VIMNMX": 766, "IMAD": 18, "VIADD": 1181,
                     "IADD3": 382}},
        "_ZN12_GLOBAL__N_116int_probe_kernelILi3EEEvPKiPiij": {
            "all": {"SHFL": 2000, "VIMNMX": 10},
            "loop": {"SHFL": 2000, "VIMNMX": 10}},
        "_ZN12_GLOBAL__N_114gact_dp_kernelILi6ELb1EEEvPKh": {
            "all": {"VIMNMX": 5}, "loop": {}},
    }
    programs = 8192
    blocks = dict.fromkeys(vpu_probe.MODES, 1056)
    got = vpu_probe.mode_bounds(programs, sass, blocks)
    assert set(got) == set(vpu_probe.MODES)
    elements = programs * vpu_probe.QT * vpu_probe.LANES
    per_program = programs * (vpu_probe.LANES // 8) * 256
    per_block = 1056 * 256

    def ms(n, lanes):
        return n / (lanes * 132 * 1.98e9) * 1e3
    # max: 64 maxes and 64 adds per element, y = x + 1 and x + y: the
    # maxes are half, so all 130 over 128 lanes bind (1.5647 ms)
    assert got["max"]["ops"] == [64, 130]
    assert got["max"]["bound_pipe"] == "alu+fma"
    assert got["max"]["bound_ms"] == pytest.approx(ms(elements * 130, 128))
    assert got["max"]["bound_ms"] == pytest.approx(1.5647, abs=1e-4)
    assert got["add"]["ops"] == [64, 130]
    assert got["sel"]["ops"] == [64, 194]       # a min and two adds a rep
    assert got["shift"]["ops"] == [64, 130]     # the row shift is a move
    assert got["max4"]["ops"] == [65, 134]
    for b in got.values():
        assert b["bound_pipe"] == "alu+fma"
    # the compiled split: max's extra ALU instructions set its floor
    c = got["max"]["compiled"]
    assert c["pipes"] == {"alu": 880 * per_program + 20 * per_block,
                          "fma": 789 * per_program,
                          "add": 12 * per_program + 12 * per_block,
                          "shfl": 0}
    assert c["other"] == {"LDG": 12 * per_block,
                          "BRA": per_program + 2 * per_block}
    assert c["floor_pipe"] == "alu"
    assert c["floor_ms"] == pytest.approx(
        ms(880 * per_program + 20 * per_block, 64))
    assert c["loop_per_element"] == pytest.approx((880 + 789 + 12 + 1) / 12)
    assert c["loop_alu_per_element"] == pytest.approx(880 / 12)
    c = got["sel"]["compiled"]
    assert c["floor_pipe"] == "alu+fma"
    assert c["floor_ms"] == pytest.approx(
        ms((766 + 18 + 1563) * per_program + 12 * per_block, 128))
    c = got["shift"]["compiled"]
    assert c["floor_pipe"] == "shfl"
    assert c["floor_ms"] == pytest.approx(ms(2000 * per_program, 32))
    assert "compiled" not in got["add"]
    assert vpu_probe.mode_bounds(programs)["sel"]["bound_ms"] == \
        got["sel"]["bound_ms"]


def _source_constants(*names):
    """``constexpr int NAME = <integer expression>;`` of csrc/int_probe.cu,
    so the transcription follows the kernel's own constants."""
    path = os.path.join(os.path.dirname(gact_cuda.__file__), "..", "csrc",
                        "int_probe.cu")
    with open(path) as f:
        text = re.sub(r"//[^\n]*", "", f.read())
    exprs = dict(re.findall(r"constexpr\s+int\s+(\w+)\s*=\s*([^;]+);",
                            text))

    def value(name):
        expr = exprs[name]
        assert re.fullmatch(r"[\w\s+*/()-]+", expr), (name, expr)
        return eval(expr.replace("/", "//"), {"__builtins__": {}},
                    {n: value(n) for n in re.findall(r"[A-Za-z_]\w*", expr)})
    return [value(n) for n in names]


(QT, LANES, CU_REPS, R, TPC, COLS, NT, SLICES) = _source_constants(
    "QT", "LANES", "REPS", "R", "TPC", "COLS", "NT", "SLICES")
# blocks an SM holds at once when threads are what limits them (2048 a
# Hopper SM), and the H100's SMs: the grid the card gives
PER_SM, SMS = 2048 // NT, 132


def _smax(a, b):
    return np.maximum(a.view(np.int32), b.view(np.int32)).view(np.uint32)


def _chain(x, mode):
    """csrc/int_probe.cu:chain on every thread at once: x (..., NT, R)
    uint32, a block's threads by threadIdx.x, each its R rows; x + y."""
    one = np.uint32(1)
    t = np.arange(NT) % TPC
    y = x + one
    if mode == "max":
        for _ in range(CU_REPS):
            x = _smax(x, y)
            y = y + x
    elif mode == "add":
        for _ in range(CU_REPS):
            x = x + y
            y = y ^ x
    elif mode == "sel":
        for _ in range(CU_REPS):
            m = x.view(np.int32) > y.view(np.int32)
            x = np.where(m, y, x) + one
            y = y + one
    elif mode == "shift":
        for _ in range(CU_REPS):
            # __shfl_up_sync(x[R - 1], 1, TPC): the thread before in the
            # column; a column's first thread keeps its own, then takes 0
            own = x[..., R - 1]
            before = np.concatenate([own[..., :1], own[..., :-1]], axis=-1)
            up = np.where(t >= 1, before, own)
            up = np.where(t == 0, np.uint32(0), up)
            nx = x.copy()
            nx[..., 1:] = _smax(x[..., :-1], y[..., 1:])
            nx[..., 0] = _smax(up, y[..., 0])
            x = nx
            y = y + x
    else:
        c, d = x + np.uint32(3), y ^ np.uint32(5)
        for _ in range(CU_REPS // 2):
            x = _smax(x, y)
            y = y + one
            c = _smax(c, d)
            d = d + np.uint32(3)
        x, y = x + c, y + d
    return x + y


def _grid(programs):
    """csrc/int_probe.cu:grid_of at PER_SM blocks an SM on SMS SMs."""
    lanes = max(1, PER_SM * SMS // SLICES)
    return SLICES * min(programs, lanes)


def _schedule(x, mode, programs, zero=0):
    """csrc/int_probe.cu's launch transcribed: the grid, each block's load
    (its offsets from blockIdx and threadIdx), its program loop, each
    program's input x0 + zero x the output of the program before (0 before
    the first), and its one store after the loop.  The
    blocks of one lane (the same first program) run side by side.  Returns
    ({lane: the (QT, LANES) block its blocks stored}, stores per element,
    {block: its last program})."""
    blocks = _grid(programs)
    step = blocks // SLICES
    flat = x.reshape(-1).view(np.uint32)
    stored, last = {}, {}
    stores = np.zeros(QT * LANES, np.int64)
    th = np.arange(NT)
    for lane in range(step):
        if lane >= programs:
            continue                        # these blocks return at once
        b = lane * SLICES + np.arange(SLICES)
        off = ((th % TPC) * R * LANES)[None, :] + \
            (b % SLICES * COLS)[:, None] + (th // TPC)[None, :]
        off = off[..., None] + np.arange(R) * LANES     # (SLICES, NT, R)
        x0 = flat[off]
        got = np.zeros_like(x0)
        p = lane
        while True:
            got = _chain(got * np.uint32(zero) + x0, mode)
            p += step
            if p >= programs:
                break
        out = np.zeros(QT * LANES, np.int32)
        out[off] = got.view(np.int32)
        np.add.at(stores, off.reshape(-1), 1)
        stored[lane] = out.reshape(QT, LANES)
        last.update(dict.fromkeys(b.tolist(), p - step))
    return stored, stores.reshape(QT, LANES), last


def _wrap(x, k):
    return ((x.astype(np.int64) + k.astype(np.int64) + (1 << 31))
            % (1 << 32) - (1 << 31)).astype(np.int32)


@pytest.mark.parametrize("mode", vpu_probe.MODES)
def test_persistent_schedule_transcribed_matches_the_twin(mode):
    """The kernel's schedule gives probe_plain's block at 1 and 3 programs,
    one fewer than the grid's lanes (programs in flight) and five more (a
    last partial wave of five lanes): every element stored once by each
    lane that had a program, the blocks no program needs never launched.
    With the opaque zero set to 1, each lane's store is the chain iterated
    over its programs, each from x plus the output before: the fold chains
    every program to the next."""
    assert (QT, LANES, CU_REPS) == (vpu_probe.QT, vpu_probe.LANES,
                                    vpu_probe.REPS)
    assert (R, COLS, NT, SLICES * NT) == (
        vpu_probe.R, vpu_probe.COLS, vpu_probe.BLOCK_THREADS,
        vpu_probe.THREADS_PER_PROGRAM)
    x = _block(34)
    want = _kernel_semantics(x, mode)
    np.testing.assert_array_equal(
        vpu_probe.probe_plain(torch.from_numpy(x), mode).numpy(), want)
    lanes = _grid(1 << 24) // SLICES
    assert lanes == 66
    for programs in (1, 3, lanes - 1, lanes + 5):
        stored, stores, last = _schedule(x, mode, programs)
        assert len(last) == _grid(programs) == SLICES * min(programs, lanes)
        assert len(stored) == min(programs, lanes)
        for out in stored.values():
            np.testing.assert_array_equal(out, want)
        assert (stores == min(programs, lanes)).all()
    programs = lanes + 5
    stored, _, last = _schedule(x, mode, programs, zero=1)
    assert [last[lane * SLICES] for lane in range(lanes)] == \
        [lane + lanes if lane < 5 else lane for lane in range(lanes)]
    once = _kernel_semantics(x, mode)
    twice = _kernel_semantics(_wrap(x, once), mode)
    for lane in range(lanes):
        np.testing.assert_array_equal(stored[lane], twice if lane < 5
                                      else once)


def test_clock_readings_parse_and_spread(monkeypatch):
    """nvidia-smi's SM clock and power draw: the first card's line, a
    field that is not a number (a card that does not report power) left
    out, and the min / median / max that each mode's entry carries, with
    the share at the sampled clock beside the share at 1.98 GHz."""
    assert vpu_probe.parse_clocks("1980, 312.45\n") == (1980.0, 312.45)
    assert vpu_probe.parse_clocks("1755, [N/A]\n") == (1755.0, None)
    assert vpu_probe.parse_clocks("1980, 300.00\n1410, 70.00\n") == \
        (1980.0, 300.0)
    assert vpu_probe.parse_clocks("[N/A], 100.0\n") is None
    assert vpu_probe.parse_clocks("") is None
    assert vpu_probe.spread([1980.0, 1965.0, None, 1995.0, 1980.0]) == \
        {"min": 1965.0, "median": 1980.0, "max": 1995.0}
    assert vpu_probe.spread([]) is None
    r = vpu_probe.rates([3.0, 2.0, 2.5], [(1980.0, 300.0), (1800.0, None)],
                        8192, 1.0)
    assert (r["ms"], r["ms_median"], r["ms_max"]) == (2.0, 2.5, 3.0)
    assert r["tops"] == pytest.approx(384 * 128 * 8192 * 128 / 2e-3 / 1e12)
    assert r["share"] == 0.5
    assert r["sm_clock_mhz"] == {"min": 1800.0, "median": 1890.0,
                                 "max": 1980.0}
    assert r["power_w"] == {"min": 300.0, "median": 300.0, "max": 300.0}
    assert r["share_at_clock"] == pytest.approx(1.0 * 1980 / 1890 / 2.0)
    r = vpu_probe.rates([2.0], [], 1, 1.0)
    assert r["sm_clock_mhz"] is None and r["share_at_clock"] is None

    # the sampler: readings from the first call on, until the block ends
    calls = []

    class Done:
        def __init__(self, out):
            self.stdout = out

    def run(cmd, **kw):
        assert cmd == vpu_probe.SMI_CLOCKS
        calls.append(1)
        return Done("1965, 250.5\n" if len(calls) % 2 else "[N/A], 1\n")
    monkeypatch.setattr(vpu_probe.subprocess, "run", run)
    with vpu_probe.ClockSampler() as clocks:
        pass
    assert not clocks._thread.is_alive()
    assert calls and clocks.readings[0] == (1965.0, 250.5)
    assert len(clocks.readings) == (len(calls) + 1) // 2


def test_executed_counts_the_program_loop_once_per_program():
    """The looped kernel's executed thread-instructions: the program
    loop's span once per program and column slice, the rest (load, store,
    the loop's way in and out) once per thread of the grid."""
    info = {"all": {"VIMNMX": 790, "IMAD": 800, "LDG": 12, "STG": 12,
                    "ISETP": 3, "BRA": 2},
            "loop": {"VIMNMX": 770, "IMAD": 790, "ISETP": 1, "BRA": 1}}
    T, B = vpu_probe.THREADS_PER_PROGRAM, vpu_probe.BLOCK_THREADS
    assert T == 16 * B
    got = vpu_probe.executed(info, 8192, 1056)
    assert got == {"VIMNMX": 770 * 8192 * T + 20 * 1056 * B,
                   "IMAD": 790 * 8192 * T + 10 * 1056 * B,
                   "LDG": 12 * 1056 * B, "STG": 12 * 1056 * B,
                   "ISETP": 8192 * T + 2 * 1056 * B,
                   "BRA": 8192 * T + 1056 * B}
    # one program: 16 blocks, each one pass of the loop
    assert vpu_probe.executed(info, 1, 16) == {
        op: n * 16 * B for op, n in info["all"].items()}
    # the loop dominates: per element, about its span over R rows
    per_element = sum(got.values()) / (8192 * vpu_probe.QT * vpu_probe.LANES)
    assert per_element == pytest.approx(
        sum(info["loop"].values()) / vpu_probe.R, rel=0.001)
