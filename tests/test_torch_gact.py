"""darwin_tpu_torch's plain tile DP and traceback walker (the CPU twins of
the CUDA kernels gact_dp and gact_tb) against darwin_tpu: the lax DP, the
Pallas DP and sweep traceback in interpret mode, and the strip kernel for
large tiles.  Every comparison is exact integer equality.

Trace bytes: the port's gap scans are unwindowed, darwin_tpu windows the
dominated short lane (oracle.gap_scan_windows: 32 rows at the default
scoring), so the F_OPEN8 bit may differ at cells no traceback reads.  Trace
bytes are compared inside [0, qlen) x [0, rlen) with that bit masked when
the window is active; the walked records are compared whole.  Generic
scorings (gap open cheaper than gap extend on either lane) are scanned
unwindowed by both packages: there every trace byte of the valid region is
compared, unmasked.
"""

import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from darwin_tpu.config import Config as JConfig
from darwin_tpu.ops import gact as jgact, gact_pallas, oracle
from darwin_tpu_torch.config import Config
from darwin_tpu_torch.ops import gact, gact_cuda
from tests.test_gact_device import _make_batch

torch.set_num_threads(2)

CFG = Config()
JPARAMS = jgact.make_params(JConfig())
PARAMS = gact.make_params(CFG)

# scorings outside the prefix-gap domain: (sub list, go, ge, goL, geL).
# "generic" is both lanes open-cheaper; "mixed" only the short lane;
# "tie_rich" has match = -mismatch and small gaps, so lanes tie often and
# the T-field tree and the open bits decide the path
TIE_SUB = [1, -1, -1, -1, 1, -1, -1, 1, -1, 1, 0]
GENERIC = {
    "generic": (None, -1, -3, -2, -6),
    "mixed": (None, -1, -3, -25, -1),
    "tie_rich": (TIE_SUB, -1, -2, -1, -3),
}
# scorings inside it (gap open <= gap extend on both lanes), where
# darwin_tpu takes its prefix-max scans and the port the same one
# recurrence: the default, a tie-rich one, open = extend, and two where a
# gap opened right after the other lane's gap is cheapest
PREFIX = {
    "default": (None, CFG.gap_open, CFG.gap_extend, CFG.long_gap_open,
                CFG.long_gap_extend),
    "prefix_tie_rich": (TIE_SUB, -2, -1, -3, -1),
    "prefix_open_is_extend": (TIE_SUB, -1, -1, -2, -1),
    "prefix_cross_lane": (None, -1, -1, -30, -3),
    "prefix_cross_lane_tie": (TIE_SUB, -5, -1, -2, -2),
}


def _scoring(name):
    """(darwin_tpu params, port params) of one GENERIC or PREFIX
    scoring."""
    sub, go, ge, goL, geL = {**GENERIC, **PREFIX}[name]
    out = []
    for cls, make in ((JConfig, jgact.make_params), (Config,
                                                    gact.make_params)):
        cfg = cls()
        if sub is not None:
            cfg.gact_sub_mat = list(sub)
        cfg.gap_open, cfg.gap_extend = go, ge
        cfg.long_gap_open, cfg.long_gap_extend = goL, geL
        out.append(make(cfg))
    assert (go <= ge and goL <= geL) == (name in PREFIX)
    return tuple(out)


def _masks(qt):
    wf, _ = oracle.gap_scan_windows(CFG.gap_open, CFG.gap_extend,
                                    CFG.long_gap_open, CFG.long_gap_extend,
                                    qt)
    return 0xFF & ~gact.F_OPEN8 if wf < qt else 0xFF


def _port(q, r, ql, rl, se, with_trace=True, params=PARAMS):
    return gact.batch_align(torch.from_numpy(q), torch.from_numpy(r),
                            torch.from_numpy(ql), torch.from_numpy(rl),
                            torch.from_numpy(se), params,
                            with_trace=with_trace)


def _jargs(q, r, ql, rl, se, jparams=JPARAMS):
    return (jnp.asarray(q), jnp.asarray(r), jnp.asarray(ql),
            jnp.asarray(rl), jnp.asarray(se), jparams)


def _assert_trace_equal(port_tr, ref_tr_brq, ql, rl, mask):
    """port (B, RT, QT) vs darwin_tpu's trace as (B, RT, QT), valid
    region only."""
    for b in range(len(ql)):
        np.testing.assert_array_equal(
            port_tr[b, :rl[b], :ql[b]] & mask,
            ref_tr_brq[b, :rl[b], :ql[b]] & mask, err_msg=f"tile {b}")


@pytest.fixture(scope="module", params=["max_cell", "start_to_end"])
def mode_batch(request):
    rng = np.random.default_rng(11)
    B, QT, RT = 16, 72, 64
    q, r, ql, rl, _ = _make_batch(rng, B, QT, RT)
    se = np.full(B, request.param == "start_to_end")
    return q, r, ql, rl, se


def test_plain_dp_matches_lax_and_pallas(mode_batch):
    q, r, ql, rl, se = mode_batch
    port = _port(q, r, ql, rl, se)
    lax = jgact.batch_align(*_jargs(q, r, ql, rl, se), with_trace=True)
    pal = gact_pallas.batch_align(*_jargs(q, r, ql, rl, se),
                                  with_trace=True, interpret=True)
    for k in ("score", "query_max_pos", "ref_max_pos"):
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(lax[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(pal[k]),
                                      err_msg=k)
    mask = _masks(q.shape[1])
    tr = port["trace"].numpy()
    _assert_trace_equal(tr, np.asarray(lax["trace"]).transpose(1, 0, 2),
                        ql, rl, mask)
    _assert_trace_equal(tr, np.asarray(pal["trace"]).transpose(2, 0, 1),
                        ql, rl, mask)


def _tb_starts(port, ql, rl, se):
    sq = np.where(se, ql - 1, port["query_max_pos"].numpy())
    sr = np.where(se, rl - 1, port["ref_max_pos"].numpy())
    return sq.astype(np.int32), sr.astype(np.int32)


@pytest.mark.parametrize("safe", [False, True])
def test_walker_records_match_tb_call(mode_batch, safe):
    """Records of the plain walker on the port's trace equal the Pallas
    sweep's (_tb_kernel and _tb_kernel_safe) on darwin_tpu's trace."""
    q, r, ql, rl, se = mode_batch
    QT = q.shape[1]
    port = _port(q, r, ql, rl, se)
    sq, sr = _tb_starts(port, ql, rl, se)
    pal = gact_pallas.batch_align(*_jargs(q, r, ql, rl, se),
                                  with_trace=True, interpret=True)
    B = len(ql)
    Bp = pal["trace"].shape[2]
    pad = lambda a: jnp.asarray(np.pad(a, (0, Bp - B), constant_values=-1))
    rec_j, qs_j, rs_j, spill = gact_pallas._tb_call(
        pal["trace"], pad(sq), pad(sr), 2 * QT, True, safe=safe)
    assert not np.asarray(spill).any()
    rec, qs, rs = gact.traceback(port["trace"], torch.from_numpy(sq),
                                 torch.from_numpy(sr), 2 * QT)
    np.testing.assert_array_equal(rec.numpy(), np.asarray(rec_j)[:, :B])
    np.testing.assert_array_equal(qs.numpy(), np.asarray(qs_j)[:B])
    np.testing.assert_array_equal(rs.numpy(), np.asarray(rs_j)[:B])


@pytest.mark.parametrize("max_tb", [7, 10])
def test_max_tb_cap(max_tb):
    """The step caps are checked before every op and cut insert runs,
    exactly like the serial walker (gact.align_and_traceback)."""
    rng = np.random.default_rng(5)
    B, QT, RT = 8, 48, 48
    q, r, ql, rl, _ = _make_batch(rng, B, QT, RT)
    ql[:] = QT
    rl[:] = RT
    se = np.ones(B, bool)
    port = _port(q, r, ql, rl, se)
    rec, qs, rs = gact.traceback(port["trace"], torch.from_numpy(ql - 1),
                                 torch.from_numpy(rl - 1), max_tb)
    ref = jgact.align_and_traceback(*_jargs(q, r, ql, rl, se), max_tb)
    L = min(QT + RT, 2 * max_tb)
    ops, n_ops = gact.expand_records(rec.numpy(), B, L)
    np.testing.assert_array_equal(n_ops, np.asarray(ref["n_ops"]))
    np.testing.assert_array_equal(qs.numpy(), np.asarray(ref["q_steps"]))
    np.testing.assert_array_equal(rs.numpy(), np.asarray(ref["r_steps"]))
    np.testing.assert_array_equal(ops, np.asarray(ref["ops"])[:, :L])


def test_two_insert_runs_in_one_column():
    """A column with two I-runs (reachable only through exact gap-lane
    ties): darwin_tpu's fast sweep spills and reruns the safe kernel; the
    port's walker takes it directly (tests/test_gact_pallas.py:175-200)."""
    QT, RT = 32, 8
    tr = np.zeros((RT, QT, 128), np.uint8)
    tr[3, 5, 0] = gact.T8_INS
    tr[3, 4, 0] = gact.T8_INS | gact.F_OPEN8
    tr[3, 3, 0] = gact.T8_INS_L | gact.FL_OPEN8
    tr[3, 2, 0] = gact.T8_DIAG
    sq = np.array([5], np.int32)
    sr = np.array([3], np.int32)
    rec, qs, rs = gact.traceback(
        torch.from_numpy(np.ascontiguousarray(tr[:, :, :1].transpose(2, 0,
                                                                     1))),
        torch.from_numpy(sq), torch.from_numpy(sr), 64)
    ops, n = gact.expand_records(rec.numpy(), 1, QT + RT)
    assert ops[0, :n[0]].tolist() == [1, 1, 1, 3]       # I I I M
    assert (int(qs[0]), int(rs[0])) == (4, 1)
    pad = lambda v: jnp.asarray(np.concatenate(
        [v, np.full(127, -1, np.int32)]))
    rec_s, qs_s, rs_s, spill = gact_pallas._tb_call(
        jnp.asarray(tr), pad(sq), pad(sr), 64, True, safe=True)
    assert not np.asarray(spill).any()
    np.testing.assert_array_equal(rec.numpy()[:, 0], np.asarray(rec_s)[:, 0])
    assert (int(qs_s[0]), int(rs_s[0])) == (4, 1)


def test_large_tile_matches_strip_kernel():
    """QT > 512 start-to-end tiles go through darwin_tpu's strip kernel
    (K4); the port's one DP covers them directly."""
    rng = np.random.default_rng(3)
    B, QT, RT = 8, 600, 32
    q, r, ql, rl, _ = _make_batch(rng, B, QT, RT)
    ql = np.maximum(ql, 520).astype(np.int32)       # reach the 2nd strip
    se = np.ones(B, bool)
    port = _port(q, r, ql, rl, se)
    pal = gact_pallas.batch_align(*_jargs(q, r, ql, rl, se),
                                  with_trace=True, all_start_end=True,
                                  interpret=True)
    np.testing.assert_array_equal(port["score"].numpy(),
                                  np.asarray(pal["score"]))
    _assert_trace_equal(port["trace"].numpy(),
                        np.asarray(pal["trace"]).transpose(2, 0, 1), ql, rl,
                        0xFF & ~gact.F_OPEN8)
    rec, qs, rs = gact.traceback(port["trace"], torch.from_numpy(ql - 1),
                                 torch.from_numpy(rl - 1), 2 * QT)
    Bp = pal["trace"].shape[2]
    pad = lambda a: jnp.asarray(np.pad(a - 1, (0, Bp - B),
                                       constant_values=-1))
    rec_j, qs_j, rs_j, _ = gact_pallas._tb_call(
        pal["trace"], pad(ql), pad(rl), 2 * QT, True, safe=True)
    np.testing.assert_array_equal(rec.numpy(), np.asarray(rec_j)[:, :B])
    np.testing.assert_array_equal(qs.numpy(), np.asarray(qs_j)[:B])


def test_expand_records_matches_darwin_tpu():
    rng = np.random.default_rng(2)
    RT, B = 40, 6
    n_ins = rng.integers(0, 4, (RT, B)) * (rng.random((RT, B)) < 0.3)
    closing = rng.choice([0, oracle.OP_M, oracle.OP_D], (RT, B),
                         p=[0.2, 0.6, 0.2])
    rec = (n_ins | (closing << 14)).astype(np.int32)
    for L in (30, 200):
        ops, n = gact.expand_records(rec, B, L)
        ops_j, n_j = gact_pallas._expand_records(rec, B, L)
        np.testing.assert_array_equal(ops, ops_j)
        np.testing.assert_array_equal(n, n_j)


def test_wrappers_take_the_twin_on_cpu_and_check_inputs():
    rng = np.random.default_rng(4)
    B, QT, RT = 4, 40, 40
    q, r, ql, rl, se = _make_batch(rng, B, QT, RT)
    args = [torch.from_numpy(x) for x in (q, r, ql, rl, se)]
    before = dict(gact_cuda.LAUNCHES)
    got = gact_cuda.dp_tiles(*args, PARAMS, True)
    want = gact.batch_align(*args, PARAMS, with_trace=True)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    sq, sr = (args[2] - 1), (args[3] - 1)
    for a, b in zip(gact_cuda.traceback_tiles(got["trace"], sq, sr, 80),
                    gact.traceback(got["trace"], sq, sr, 80)):
        assert torch.equal(a, b)
    assert gact_cuda.LAUNCHES == before        # the twin launches nothing
    with pytest.raises(TypeError):
        gact_cuda.dp_tiles(args[0].int(), *args[1:], PARAMS, True)
    with pytest.raises(ValueError):
        gact_cuda.dp_tiles(args[0][:, ::2], *args[1:], PARAMS, True)
    with pytest.raises(ValueError):
        gact_cuda.traceback_tiles(got["trace"], sq[:2], sr, 80)
    generic = PARAMS._replace(gap_open=-1, gap_extend=-3)
    got = gact_cuda.dp_tiles(*args, generic, True)     # any scoring is taken
    want = gact.batch_align(*args, generic, with_trace=True)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not torch.equal(got["trace"], gact.batch_align(
        *args, PARAMS, with_trace=True)["trace"])
    assert gact_cuda.LAUNCHES == before


def test_empty_batch_launches_nothing(monkeypatch):
    """B = 0 returns empty outputs before reaching a kernel or a twin, so
    the launch count stays a count of real launches."""
    def never(*_, **__):
        raise AssertionError("an empty batch reached a kernel or a twin")
    from darwin_tpu_torch.ops import build
    for mod, name in ((build, "load"), (gact, "batch_align"),
                      (gact, "traceback")):
        monkeypatch.setattr(mod, name, never)
    before = dict(gact_cuda.LAUNCHES)
    z8, z32 = torch.uint8, torch.int32
    for with_trace in (False, True):
        got = gact_cuda.dp_tiles(
            torch.zeros((0, 48), dtype=z8), torch.zeros((0, 64), dtype=z8),
            torch.zeros(0, dtype=z32), torch.zeros(0, dtype=z32),
            torch.zeros(0, dtype=torch.bool), PARAMS, with_trace)
        for k in ("score", "query_max_pos", "ref_max_pos"):
            assert got[k].shape == (0,) and got[k].dtype == z32
        assert ("trace" in got) == with_trace
        if with_trace:
            assert got["trace"].shape == (0, 64, 48)
    rec, qs, rs = gact_cuda.traceback_tiles(
        torch.zeros((0, 64, 48), dtype=z8), torch.zeros(0, dtype=z32),
        torch.zeros(0, dtype=z32), 80)
    assert rec.shape == (64, 0) and qs.shape == rs.shape == (0,)
    assert rec.dtype == qs.dtype == rs.dtype == z32
    assert gact_cuda.LAUNCHES == before


def test_empty_side_tiles_match_lax():
    """The extender can ask for a tile with an empty query or ref side
    (an anchor at a sequence end); it must score 0 and walk no ops."""
    rng = np.random.default_rng(9)
    B, QT, RT = 4, 32, 32
    q, r, ql, rl, _ = _make_batch(rng, B, QT, RT)
    ql[0], rl[1] = 0, 0
    se = np.ones(B, bool)
    port = _port(q, r, ql, rl, se)
    ref = jgact.align_and_traceback(*_jargs(q, r, ql, rl, se), 2 * QT)
    for k in ("score", "query_max_pos", "ref_max_pos"):
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    rec, qs, rs = gact.traceback(port["trace"], torch.from_numpy(ql - 1),
                                 torch.from_numpy(rl - 1), 2 * QT)
    _, n_ops = gact.expand_records(rec.numpy(), B, QT + RT)
    np.testing.assert_array_equal(n_ops, np.asarray(ref["n_ops"]))
    assert n_ops[0] == n_ops[1] == 0


@pytest.mark.parametrize("empty", ["query", "ref", "both"])
def test_empty_side_max_cell_tile_walks_nothing(empty):
    """Max-cell mode reports cell (0, 0) for a tile with an empty side,
    which has no valid cell: its trace word (0, 0) is ZERO, so the walk
    from the reported cell emits nothing, whatever codes lie beyond the
    lengths."""
    rng = np.random.default_rng(13)
    B, QT, RT = 3, 40, 24
    q, r, ql, rl, _ = _make_batch(rng, B, QT, RT)
    q[0], r[0, :QT - 16] = 1, 1                 # codes that would match
    if empty in ("query", "both"):
        ql[0] = 0
    if empty in ("ref", "both"):
        rl[0] = 0
    se = np.zeros(B, bool)
    port = _port(q, r, ql, rl, se)
    assert (int(port["score"][0]), int(port["query_max_pos"][0]),
            int(port["ref_max_pos"][0])) == (0, 0, 0)
    assert int(port["trace"][0, 0, 0]) == gact.T8_ZERO
    rec, qs, rs = gact.traceback(port["trace"], port["query_max_pos"],
                                 port["ref_max_pos"], 2 * QT)
    assert int(qs[0]) == int(rs[0]) == 0 and not rec[:, 0].any()
    assert int(qs[1]) > 0                       # the other tiles do walk


def _assert_generic_tiles(name, q, r, ql, rl, se, all_start_end=False,
                          lax=True):
    """Port twin vs darwin_tpu (lax scan and Pallas in interpret mode) on
    one generic scoring: scores, positions, every trace byte of the valid
    region unmasked, and the traceback records."""
    jparams, params = _scoring(name)
    QT = q.shape[1]
    B = len(ql)
    port = _port(q, r, ql, rl, se, params=params)
    pal = gact_pallas.batch_align(*_jargs(q, r, ql, rl, se, jparams),
                                  with_trace=True,
                                  all_start_end=all_start_end,
                                  interpret=True)
    refs = [("pallas", pal, (2, 0, 1))]
    if lax:
        refs.append(("lax", jgact.batch_align(
            *_jargs(q, r, ql, rl, se, jparams), with_trace=True), (1, 0, 2)))
    for what, ref, axes in refs:
        for k in ("score", "query_max_pos", "ref_max_pos"):
            np.testing.assert_array_equal(
                port[k].numpy(), np.asarray(ref[k]), err_msg=f"{what} {k}")
        _assert_trace_equal(port["trace"].numpy(),
                            np.asarray(ref["trace"]).transpose(*axes)[:B],
                            ql, rl, 0xFF)
    sq, sr = _tb_starts(port, ql, rl, se)
    Bp = pal["trace"].shape[2]
    pad = lambda a: jnp.asarray(np.pad(a, (0, Bp - B), constant_values=-1))
    rec_j, qs_j, rs_j, _ = gact_pallas._tb_call(
        pal["trace"], pad(sq), pad(sr), 2 * QT, True, safe=True)
    rec, qs, rs = gact.traceback(port["trace"], torch.from_numpy(sq),
                                 torch.from_numpy(sr), 2 * QT)
    np.testing.assert_array_equal(rec.numpy(), np.asarray(rec_j)[:, :B])
    np.testing.assert_array_equal(qs.numpy(), np.asarray(qs_j)[:B])
    np.testing.assert_array_equal(rs.numpy(), np.asarray(rs_j)[:B])
    return port


@pytest.mark.parametrize("name", list(GENERIC))
def test_generic_max_cell_128(name):
    """The filter's geometry: 128x128, max-cell mode."""
    rng = np.random.default_rng(21)
    q, r, ql, rl, _ = _make_batch(rng, 8, 128, 128)
    port = _assert_generic_tiles(name, q, r, ql, rl, np.zeros(8, bool))
    assert int(port["score"].max()) > 0


@pytest.mark.parametrize("name", list(GENERIC))
def test_generic_start_to_end_384(name):
    """The extender's geometry: 384x384, start-to-end, with trace."""
    rng = np.random.default_rng(22)
    q, r, ql, rl, _ = _make_batch(rng, 4, 384, 384)
    ql[0], rl[0] = 384, 384
    _assert_generic_tiles(name, q, r, ql, rl, np.ones(4, bool), lax=False)


@pytest.mark.parametrize("name", ["generic", "mixed"])
def test_generic_large_tile_matches_strip_kernel(name):
    """QT > 512 goes through darwin_tpu's strip kernel, whose generic
    branch carries the cross-lane term across strips
    (gact_pallas.py:417-430); reduced to 600 x 32."""
    rng = np.random.default_rng(23)
    B, QT, RT = 8, 600, 32
    q, r, ql, rl, _ = _make_batch(rng, B, QT, RT)
    ql = np.maximum(ql, 520).astype(np.int32)       # reach the 2nd strip
    _assert_generic_tiles(name, q, r, ql, rl, np.ones(B, bool),
                          all_start_end=True, lax=False)


@pytest.mark.parametrize("name", list(GENERIC) + list(PREFIX))
def test_generic_twin_is_the_coupled_recurrence(name):
    """The twin's closed form (two prefix scans and the shared cross-lane
    term) against the recurrence written out cell by cell in numpy, as
    the CUDA kernel walks it, for scorings of both domains: H and the
    whole trace byte.  Tile 0 holds a 30-row insertion and tile 1 a
    30-column deletion, so long gaps and gaps opened after gaps occur."""
    _, params = _scoring(name)
    rng = np.random.default_rng(24)
    B, QT, RT = 3, 72, 64
    q, r, ql, rl, _ = _make_batch(rng, B, QT, RT)
    ql[:], rl[:] = QT, RT
    q[0, :20], q[0, 50:72] = r[0, :20], r[0, 20:42]
    q[1, :20], q[1, 20:54] = r[1, :20], r[1, 30:64]
    port = _port(q, r, ql, rl, np.ones(B, bool), params=params)
    sub = np.array(params.sub)
    go, ge = params.gap_open, params.gap_extend
    goL, geL = params.long_gap_open, params.long_gap_extend
    for b in range(B):
        H = np.zeros(QT, np.int64)
        E = np.full(QT, go, np.int64)
        EL = np.full(QT, goL, np.int64)
        eb = np.full(QT, gact.E_OPEN8 | gact.EL_OPEN8)
        for c in range(RT):
            hup, f_up, fl_up = 0, gact.NEG_INF, gact.NEG_INF
            raw = gact.F_OPEN8 | gact.FL_OPEN8
            hdiag = 0
            for i in range(QT):
                dag = max(hdiag + sub[q[b, i], r[b, c]], 0)
                e, el = E[i], EL[i]
                hp = max(dag, e, el)
                f = max(hup + go, f_up + ge)
                fl = max(hup + goL, fl_up + geL)
                h = max(hp, f, fl)
                if h == dag:
                    t = (gact.T8_DEL_L if h == el else gact.T8_INS_L
                         if h == fl else gact.T8_ZERO if h == 0
                         else gact.T8_DIAG)
                else:
                    t = (gact.T8_INS if h == f else gact.T8_INS_L
                         if h == fl else gact.T8_DEL_L if h == el
                         else gact.T8_DEL)
                assert int(port["trace"][b, c, i]) == t + eb[i] + raw, \
                    (b, c, i)
                raw = ((gact.F_OPEN8 if h + go > f + ge else 0)
                       | (gact.FL_OPEN8 if h + goL > fl + geL else 0))
                eb[i] = ((gact.E_OPEN8 if h + go > e + ge else 0)
                         | (gact.EL_OPEN8 if h + goL > el + geL else 0))
                E[i] = max(h + go, e + ge)
                EL[i] = max(h + goL, el + geL)
                hdiag, H[i] = H[i], h
                hup, f_up, fl_up = h, f, fl
        assert int(port["score"][b]) == H[QT - 1]


# ---- the schedules of the two CUDA kernels, transcribed to numpy ----------
#
# The kernels run only on a card; what they compute is the twins'.  How they
# divide the work is transcribed here: which lane owns which cell at which
# step, what it is handed and when, where each byte is staged and flushed
# to, how a run is found and clipped.  The constants are read from the
# kernels' sources.

def _source_constants(source, *names):
    """The ``constexpr int NAME = <integer expression>;`` of a kernel source
    (several may share one statement), so the transcriptions below follow
    the kernels' own constants; a name the source no longer has fails."""
    path = os.path.join(os.path.dirname(gact_cuda.__file__), "..", "csrc",
                        source)
    with open(path) as f:
        text = re.sub(r"//[^\n]*", "", f.read())
    exprs = {}
    for stmt in re.findall(r"constexpr\s+int\s+([^;]+);", text):
        exprs.update(re.findall(r"(\w+)\s*=\s*([^,]+)", stmt))
    missing = [n for n in names if n not in exprs]
    assert not missing, f"{source} has no constexpr int {missing}"

    def value(name):
        expr = exprs[name]
        assert re.fullmatch(r"[\w\s+*()<>-]+", expr), (name, expr)
        return eval(expr, {"__builtins__": {}},
                    {n: value(n) for n in re.findall(r"[A-Za-z_]\w*", expr)})
    return [value(n) for n in names]


def _source_s_built():
    """The strip heights ``plan()`` of csrc/gact_dp.cu chooses from."""
    path = os.path.join(os.path.dirname(gact_cuda.__file__), "..", "csrc",
                        "gact_dp.cu")
    with open(path) as f:
        m = re.search(r"const int built\[\]\s*=\s*\{([\d,\s]+)\}", f.read())
    assert m, "gact_dp.cu: plan() has no list of built strip heights"
    return tuple(int(v) for v in m.group(1).split(","))


(CHUNK, LAG, ERING, TRING, TGROUP, TFLUSH, W_MAX, S_MAX,
 FILL_WARPS) = _source_constants(
    "gact_dp.cu", "CHUNK", "LAG", "ERING", "TRING", "TGROUP", "TFLUSH",
    "W_MAX", "S_MAX", "FILL_WARPS")
S_BUILT = _source_s_built()


def _strip_height(QT, W):
    """The smallest strip height built that covers QT rows with W warps."""
    need = -(-QT // (32 * W))
    return min(s for s in S_BUILT if s >= need)


def _dp_plan(B, QT):
    """plan() of csrc/gact_dp.cu."""
    w = 1
    while w < W_MAX and QT > w * 32 * S_MAX:
        w *= 2
    while w < W_MAX and B * w < FILL_WARPS and QT > w * 32:
        w *= 2
    return _strip_height(QT, w), w


def _t_field(x):
    """t_field() of csrc/gact_dp.cu: the select tree on the five predicates
    packed in x (a SET bit: the predicate does not hold)."""
    is_dag, is_el, is_fl, is_f, is_zero = (not x & (1 << k) for k in range(5))
    if is_dag:
        return (gact.T8_DEL_L if is_el else gact.T8_INS_L if is_fl
                else gact.T8_ZERO if is_zero else gact.T8_DIAG)
    return (gact.T8_INS if is_f else gact.T8_INS_L if is_fl
            else gact.T8_DEL_L if is_el else gact.T8_DEL)


T_LUT = np.array([_t_field(x) for x in range(32)])


@pytest.mark.parametrize("x", range(32))
def test_t_field_table_is_the_select_tree(x):
    """Every combination of the five predicates: the table entry the
    kernel's arithmetic index reaches is darwin_tpu's select tree
    (gact_pallas.py:233-244) on values that realise the combination."""
    is_dag, is_zero = not x & 1, not x & 16
    h = 0 if is_dag and is_zero else 7
    dag = h if is_dag else 0 if is_zero else h - 1
    el, fl, f = (h if not x & (1 << k) else h - 1 - k for k in (1, 2, 3))
    idx = (16 * min(dag, 1) - (max(dag - h, -1) + 2 * max(el - h, -1)
                               + 4 * max(fl - h, -1) + 8 * max(f - h, -1)))
    assert idx == x
    # darwin_tpu's tree, its own code: the trace word of one cell
    hj, dj, elj, flj, fj = (jnp.int32(v) for v in (h, dag, el, fl, f))
    is_f, is_fl, is_el = hj == fj, hj == flj, hj == elj
    dz = jnp.where(hj == 0, jgact.T8_ZERO, jgact.T8_DIAG)
    t_dag = jnp.where(is_el, jgact.T8_DEL_L,
                      jnp.where(is_fl, jgact.T8_INS_L, dz))
    t_nd = jnp.where(is_f, jgact.T8_INS, jnp.where(
        is_fl, jgact.T8_INS_L, jnp.where(is_el, jgact.T8_DEL_L,
                                         jgact.T8_DEL)))
    assert int(jnp.where(hj == dj, t_dag, t_nd)) == T_LUT[x]


def _dp_schedule_tile(q, r, qlen, rlen, track, params, S, W, trace):
    """One tile as one block of csrc/gact_dp.cu runs it: W warps x 32 lanes
    x S rows, skewed columns, the edge ring between warps with its pairwise
    barriers, the staged trace columns and their flush addresses.  Writes
    the tile's (RT, QT) ``trace`` in place (None: no trace) and returns
    (score, qpos, rpos).  Asserts the hand-offs' ordering: an edge column
    is read only after a barrier that follows its write, and a ring slot is
    written again only after a barrier that follows its last read."""
    QT, RT = len(q), len(r)
    sub = np.array(params.sub, np.int64)
    go, ge = params.gap_open, params.gap_extend
    goL, geL = params.long_gap_open, params.long_gap_extend
    qlen, n = min(int(qlen), QT), min(int(rlen), RT)
    if qlen <= 0 or n <= 0:
        if trace is not None:
            trace[0, 0] = gact.T8_ZERO
        return (0, 0, 0) if track else (0, qlen - 1, n - 1)
    PITCH = 32 * S
    NL = 32 * W
    nw = -(-qlen // PITCH)
    lane = np.arange(NL) % 32
    warp = np.arange(NL) // 32
    q0 = np.arange(NL) * S
    rows = q0[None, :] + np.arange(S)[:, None]              # (S, NL)
    qc = np.where(rows < QT, q[np.minimum(rows, QT - 1)], 4).astype(np.int64)
    nv = qlen - q0
    H = np.zeros((S, NL), np.int64)
    E = np.full((S, NL), go, np.int64)
    EL = np.full((S, NL), goL, np.int64)
    EB = np.full((S, NL), gact.E_OPEN8 | gact.EL_OPEN8, np.int64)
    diag_top = np.zeros(NL, np.int64)
    eh = np.zeros(NL, np.int64)
    ef = np.full(NL, gact.NEG_INF, np.int64)
    efl = np.full(NL, gact.NEG_INF, np.int64)
    best = np.zeros(NL, np.int64)
    bpos = np.zeros(NL, np.int64)
    edge = np.zeros((W, ERING, 3), np.int64)
    edge_col = np.full((W, ERING), -1)          # column a slot holds
    edge_wr = np.zeros((W, ERING), np.int64)    # phase of its write
    edge_rd = np.full((W, ERING), -1)           # phase of its last read
    ring = np.zeros((W, TRING, PITCH), np.uint8)
    ring_col = np.full((W, TRING, 32), -1)
    flat = trace.reshape(-1) if trace is not None else None
    if trace is not None:
        bits = QT                               # the tensor itself is aligned
        talign = 16 if bits % 16 == 0 else 4 if bits % 4 == 0 else 1
    steps = n + TFLUSH if trace is not None else n + 31
    total = steps + (nw - 1) * LAG
    for g in range(total):
        phase = g // CHUNK                      # barriers passed so far
        u = g - warp * LAG
        on = (warp < nw) & (u >= 0) & (u < steps)
        if trace is not None:
            for w in range(nw):
                uw = g - w * LAG
                if not (TFLUSH <= uw < steps and uw % TGROUP == TGROUP - 1):
                    continue
                c0 = uw - TFLUSH                # a group of finished columns
                tn = min(PITCH, QT - w * PITCH)
                per_col = PITCH // talign
                for k in range(-(-TGROUP * per_col // 32) * 32):
                    col, at = k // per_col, k % per_col * talign
                    c = c0 + col
                    if col < TGROUP and at < tn and c < n:
                        assert (ring_col[w, c % TRING] == c).all(), (g, w, c)
                        dst = c * QT + w * PITCH + at
                        assert at + talign <= tn and dst % talign == 0
                        flat[dst:dst + talign] = \
                            ring[w, c % TRING, at:at + talign]
        uh, uf, ufl = np.roll(eh, 1), np.roll(ef, 1), np.roll(efl, 1)
        col = u - lane
        act = on & (col >= 0) & (col < n)
        for w in range(nw):
            x = 32 * w
            if not act[x]:
                continue
            if w == 0:
                uh[x], uf[x], ufl[x] = 0, gact.NEG_INF, gact.NEG_INF
            else:
                slot = col[x] % ERING
                assert edge_col[w - 1, slot] == col[x], (g, w)
                assert edge_wr[w - 1, slot] < phase, (g, w)
                edge_rd[w - 1, slot] = phase
                uh[x], uf[x], ufl[x] = edge[w - 1, slot]
        rc = r[np.clip(col, 0, RT - 1)].astype(np.int64)
        hdiag = diag_top.copy()
        diag_top = np.where(act, uh, diag_top)
        h, f, fl = uh.copy(), uf.copy(), ufl.copy()
        a, al = uh + go, uh + goL
        # "opening beats extending", H + go > X + ge, as H + (go - ge) > X
        ad, adL = uh + (go - ge), uh + (goL - geL)
        for s in range(S):
            dag = np.maximum(hdiag + sub[qc[s], rc], 0)
            e, el = E[s].copy(), EL[s].copy()
            hp = np.maximum(np.maximum(dag, e), el)
            f_ext, fl_ext = ~(ad > f), ~(adL > fl)
            f = np.maximum(f + ge, a)
            fl = np.maximum(fl + geL, al)
            h = np.maximum(hp, np.maximum(f, fl))
            a, al = h + go, h + goL
            ad, adL = h + (go - ge), h + (goL - geL)
            e_ext, el_ext = ~(ad > e), ~(adL > el)
            E[s] = np.where(act, np.maximum(e + ge, a), e)
            EL[s] = np.where(act, np.maximum(el + geL, al), el)
            if trace is not None:
                # no candidate exceeds H: max(x - H, -1) is 0 where equal
                t3 = (np.maximum(dag - h, -1) + 2 * np.maximum(el - h, -1)
                      + 4 * np.maximum(fl - h, -1)
                      + 8 * np.maximum(f - h, -1))
                tv = T_LUT[16 * np.minimum(dag, 1) - t3]
                word = (tv + EB[s]
                        + np.where(f_ext, 0, gact.F_OPEN8)
                        + np.where(fl_ext, 0, gact.FL_OPEN8))
                x = np.flatnonzero(act)
                ring[warp[x], col[x] % TRING, lane[x] * S + s] = word[x]
                if s == S - 1:
                    ring_col[warp[x], col[x] % TRING, lane[x]] = col[x]
                EB[s] = np.where(act, np.where(e_ext, 0, gact.E_OPEN8)
                                 + np.where(el_ext, 0, gact.EL_OPEN8), EB[s])
            hdiag = H[s].copy()
            H[s] = np.where(act, h, H[s])
            if track:
                up = act & (s < nv) & (h > best)
                best = np.where(up, h, best)
                bpos = np.where(up, (col << 11) + q0 + s, bpos)
        eh = np.where(act, h, eh)
        ef = np.where(act, f, ef)
        efl = np.where(act, fl, efl)
        for w in range(nw - 1):
            x = 32 * w + 31
            if act[x]:
                slot = col[x] % ERING
                assert edge_rd[w, slot] < phase, (g, w)
                assert edge_col[w, slot] in (-1, col[x] - ERING), (g, w)
                edge[w, slot] = h[x], f[x], fl[x]
                edge_col[w, slot], edge_wr[w, slot] = col[x], phase
    if not track:
        return int(H[(qlen - 1) % S, (qlen - 1) // S]), qlen - 1, n - 1
    x = np.lexsort((bpos, -best))[0]
    return int(best[x]), int(bpos[x]) & 2047, int(bpos[x]) >> 11


def _dp_schedule(q, r, ql, rl, se, params, S, W, with_trace=True):
    B, QT = q.shape
    RT = r.shape[1]
    trace = np.full((B, RT, QT), 0xAA, np.uint8) if with_trace else None
    out = [_dp_schedule_tile(q[b], r[b], ql[b], rl[b], not se[b], params, S,
                             W, trace[b] if with_trace else None)
           for b in range(B)]
    res = {k: np.array([o[i] for o in out])
           for i, k in enumerate(("score", "query_max_pos", "ref_max_pos"))}
    if with_trace:
        res["trace"] = trace
    return res


# (QT, RT, tiles, warps per tile): the odd and the main path's geometries,
# each with the fewest warps that cover the tile and with more (the card
# takes more where a batch is small); the large tiles cut to two tiles
DP_GEOMETRIES = [(1, 1, 4, 1), (33, 100, 4, 1), (33, 100, 4, 2),
                 (128, 128, 4, 1), (128, 128, 4, 4), (385, 383, 4, 1),
                 (385, 383, 3, 4), (384, 384, 4, 1), (384, 384, 3, 2),
                 (384, 384, 3, 4), (960, 1984, 2, 2), (1984, 960, 2, 4),
                 (2048, 64, 3, 4)]


@pytest.mark.parametrize("name", ["default", "generic", "mixed"])
@pytest.mark.parametrize("QT,RT,B,W", DP_GEOMETRIES)
def test_dp_kernel_schedule_matches_twin(QT, RT, B, W, name):
    """The DP kernel's division of a tile (W warps x 32 lanes x S rows,
    skewed columns, chunked edge hand-off, staged trace) gives the twin's
    scores, positions and valid trace bytes, with max-cell and start-to-end
    tiles mixed in one batch."""
    _, params = _scoring(name)
    rng = np.random.default_rng(QT * 7 + RT + W)
    q, r, ql, rl, _ = _make_batch(rng, B, QT, RT)
    ql[0], rl[0] = QT, RT                       # one full tile
    if B > 3:
        ql[3], rl[3] = QT, RT
    se = np.arange(B) % 2 == 0
    W = min(max(W, _dp_plan(1 << 20, QT)[1]), W_MAX)
    S = _strip_height(QT, W)
    assert 32 * S * W >= QT
    want = _port(q, r, ql, rl, se, params=params)
    got = _dp_schedule(q, r, ql, rl, se, params, S, W)
    for k in ("score", "query_max_pos", "ref_max_pos"):
        np.testing.assert_array_equal(got[k], want[k].numpy(), err_msg=k)
    _assert_trace_equal(got["trace"], want["trace"].numpy(), ql, rl, 0xFF)
    for b in range(B):                          # nothing beyond rlen is touched
        beyond = got["trace"][b, rl[b]:].ravel()
        if min(ql[b], rl[b]) <= 0:              # but an empty tile's word (0, 0)
            assert beyond[0] == want["trace"][b, 0, 0] == gact.T8_ZERO
            beyond = beyond[1:]
        assert (beyond == 0xAA).all()


@pytest.mark.parametrize("B,QT,S,W", [(512, 384, 6, 2), (103, 384, 3, 4),
                                      (2048, 384, 12, 1), (64, 960, 8, 4),
                                      (64, 1984, 16, 4), (1, 1, 1, 1),
                                      (4096, 2048, 16, 4), (9, 33, 1, 2)])
def test_dp_plan_covers_the_tile(B, QT, S, W):
    assert _dp_plan(B, QT) == (S, W)


# the walker's staged patch
PH, PW = _source_constants("gact_tb.cu", "PH", "PW")


def _warp_walk(tr, i, j, max_tb):
    """One tile as one warp of csrc/gact_tb.cu walks it: the PH x PW words
    up and left of the walk staged as a patch, 32 words along the line of
    travel read from it per round, a ballot for the first word that ends
    the run, the run clipped and emitted in one step.  tr (RT, QT) uint8.
    Returns (rec (RT,), q_steps, r_steps, rounds, patches)."""
    RT, QT = tr.shape
    lane = np.arange(32)
    rec = np.zeros(RT, np.int64)
    qs = rs = n_ins = rounds = patches = 0
    st = gact.T8_DIAG
    DELS, INSS = (gact.T8_DEL, gact.T8_DEL_L), (gact.T8_INS, gact.T8_INS_L)
    patch, pi, pj = None, 0, 0

    def first(ends):                            # __ffs(__ballot_sync()) - 1
        return int(np.argmax(ends)) if ends.any() else 32
    if 0 <= j < RT:
        while qs != max_tb and rs != max_tb and i >= 0 and j >= 0:
            if patch is None or i < pi or j <= pj - PH:
                patches += 1
                pj, pi = j, max(i - 31, 0) & ~15
                patch = np.full((PH, PW), 0xEE, np.uint8)   # never read
                for k in range(min(PH, pj + 1)):
                    row = tr[pj - k, pi:pi + PW]
                    patch[k, :len(row)] = row
            rounds += 1
            ci = i - (0 if st in DELS else lane)
            cj = j - (0 if st in INSS else lane)
            inside = (ci >= 0) & (cj >= 0)
            known = (ci >= pi) & (cj > pj - PH)
            ok = inside & known & (ci < QT)
            w = np.where(ok, patch[np.clip(pj - cj, 0, PH - 1),
                                   np.clip(ci - pi, 0, PW - 1)],
                         0).astype(np.int64)
            if st == gact.T8_DIAG:
                run = first(~inside | ~known | ((w & 7) != gact.T8_DIAG))
                m = min(run, max_tb - qs, max_tb - rs)
                rec[cj[:m]] = gact.OP_M << 14
                if m > 0:
                    rec[cj[0]] |= n_ins
                    n_ins = 0
                qs, rs, i, j = qs + m, rs + m, i - m, j - m
                if m < run or run == 32:
                    continue
                if not inside[run]:
                    break
                if not known[run]:
                    continue
                t = int(w[run]) & 7
                if t < gact.T8_DEL or t > gact.T8_INS_L:
                    break
                if qs == max_tb or rs == max_tb:
                    break
                # the gap's first op, from the word already loaded
                if t in DELS:
                    rec[j] = n_ins | (gact.OP_D << 14)
                    n_ins, rs, j = 0, rs + 1, j - 1
                    bit = gact.E_OPEN8 if t == gact.T8_DEL else gact.EL_OPEN8
                else:
                    n_ins, qs, i = n_ins + 1, qs + 1, i - 1
                    bit = gact.F_OPEN8 if t == gact.T8_INS else gact.FL_OPEN8
                st = gact.T8_DIAG if int(w[run]) & bit else t
            else:
                bit = {gact.T8_DEL: gact.E_OPEN8, gact.T8_DEL_L: gact.EL_OPEN8,
                       gact.T8_INS: gact.F_OPEN8,
                       gact.T8_INS_L: gact.FL_OPEN8}[st]
                usable = inside & known
                f = first(~usable | ((w & bit) != 0))
                opened = f < 32 and bool(usable[f])
                run = f + 1 if opened else f
                assert run >= 1
                if st in DELS:
                    m = min(run, max_tb - rs)
                    rec[cj[:m]] = gact.OP_D << 14
                    rec[cj[0]] |= n_ins
                    n_ins, rs, j = 0, rs + m, j - m
                else:
                    m = min(run, max_tb - qs)
                    n_ins, qs, i = n_ins + m, qs + m, i - m
                if opened and m == run:
                    st = gact.T8_DIAG
        if j >= 0 and n_ins > 0:
            rec[j] = n_ins
    return rec, qs, rs, rounds, patches


def _walk_case(kind):
    """(trace (B, RT, QT) uint8, start_q, start_r) of one kind of input."""
    rng = np.random.default_rng(31)
    if kind in ("aligned_default", "aligned_generic"):
        _, params = _scoring(kind.split("_")[1])
        B, QT, RT = 12, 96, 80
        q, r, ql, rl, _ = _make_batch(rng, B, QT, RT)
        ql[:4], rl[:4] = QT, RT
        se = np.arange(B) % 3 != 0
        port = _port(q, r, ql, rl, se, params=params)
        sq, sr = _tb_starts(port, ql, rl, se)
        return port["trace"].numpy(), sq, sr
    if kind in ("random_words", "random_diag_heavy"):
        # any 7-bit word with T in 0-5; starts on the edges and outside
        B, QT, RT = 48, 40, 56
        p_diag = 0.2 if kind == "random_words" else 0.9
        t = np.where(rng.random((B, RT, QT)) < p_diag, gact.T8_DIAG,
                     rng.integers(0 if kind == "random_words" else 1, 6,
                                  (B, RT, QT)))
        tr = (t | (rng.integers(0, 16, (B, RT, QT)) << 3)).astype(np.uint8)
        sq = rng.integers(-1, QT + 3, B).astype(np.int32)
        sr = rng.integers(-2, RT + 2, B).astype(np.int32)
        sq[:6] = [QT - 1, QT, QT + 2, 0, -1, QT - 1]
        sr[:6] = [RT - 1, RT - 1, 5, 0, 3, RT]
        return tr, sq, sr
    if kind == "long_runs":
        # runs longer than 32 of every state: a pure diagonal, a column of
        # unopened deletes, a row of unopened inserts of either lane, and
        # gap runs that open exactly at the 32nd and 33rd word
        B, QT, RT = 8, 100, 100
        tr = np.full((B, RT, QT), gact.T8_DIAG, np.uint8)
        tr[1, :, :] = gact.T8_DEL
        tr[2, :, :] = gact.T8_INS_L
        tr[3, :, :] = gact.T8_DEL_L
        tr[3, 99 - 31, 99] |= gact.EL_OPEN8
        tr[4, :, :] = gact.T8_INS
        tr[4, 99, 99 - 32] |= gact.F_OPEN8
        tr[5, 60:, :] = gact.T8_DEL | gact.E_OPEN8   # every delete opens
        tr[6, :, 50:] = gact.T8_INS | gact.EL_OPEN8  # the wrong lane's bit
        tr[7, 40, 40] = gact.T8_ZERO
        return (tr, np.full(B, QT - 1, np.int32), np.full(B, RT - 1, np.int32))
    assert kind == "two_insert_runs"
    tr = np.zeros((1, 8, 32), np.uint8)
    tr[0, 3, 5] = gact.T8_INS
    tr[0, 3, 4] = gact.T8_INS | gact.F_OPEN8
    tr[0, 3, 3] = gact.T8_INS_L | gact.FL_OPEN8
    tr[0, 3, 2] = gact.T8_DIAG
    return tr, np.array([5], np.int32), np.array([3], np.int32)


@pytest.mark.parametrize("max_tb", [1, 7, 33, 768])
@pytest.mark.parametrize("kind", ["aligned_default", "aligned_generic",
                                  "random_words", "random_diag_heavy",
                                  "long_runs", "two_insert_runs"])
def test_tb_kernel_schedule_matches_twin(kind, max_tb):
    """The walker kernel's rounds (staged patches, 32-wide look-ahead
    along the line of travel, ballot, clipping at max_tb, at the patch's
    and at the tile's edge) give the twin's records and step counts word
    for word, in fewer rounds than steps wherever a run is longer than one
    cell."""
    tr, sq, sr = _walk_case(kind)
    rec, qs, rs = gact.traceback(torch.from_numpy(tr), torch.from_numpy(sq),
                                 torch.from_numpy(sr), max_tb)
    rec, qs, rs = rec.numpy(), qs.numpy(), rs.numpy()
    rounds = steps = 0
    for b in range(tr.shape[0]):
        got, gq, gr, n, n_patches = _warp_walk(tr[b], int(sq[b]), int(sr[b]),
                                               max_tb)
        np.testing.assert_array_equal(got, rec[:, b], err_msg=f"tile {b}")
        assert (gq, gr) == (qs[b], rs[b]), b
        n_ops = int((rec[:, b] & 0x3FFF).sum() + (rec[:, b] >> 14 != 0).sum())
        # a patch holds the walk's next 32 steps at least
        assert n_patches <= n_ops // 32 + 1
        rounds += n
        steps += n_ops
    # a round takes an op at least, but for the one that sees the walk's end
    # and those that only cross into the next patch
    assert rounds <= steps + steps // 32 + 2 * tr.shape[0]
    if kind in ("long_runs", "random_diag_heavy") and max_tb >= 33:
        assert rounds < steps / 3
