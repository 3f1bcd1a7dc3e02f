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
