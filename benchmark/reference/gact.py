"""Plain GACT tile DP and traceback for the benchmark's reference, in NumPy,
batched over tiles.

The recurrence is Darwin's two-piece affine local alignment
(software/Processor.cpp's DualAlignSIMD, as darwin_tpu/ops/oracle.py states
it), with query q and reference r:

    dag(q,r) = max(H(q-1,r-1) + sub(query[q], ref[r]), 0)
    E(q,r)   = max(H(q,r-1) + go,  E(q,r-1) + ge)      (E_L: goL, geL)
    F(q,r)   = max(H(q-1,r) + go,  F(q-1,r) + ge)      (F_L: goL, geL)
    H(q,r)   = max(dag, E, E_L, F, F_L)

with H = 0 and E = F = -inf outside the tile.  It is computed here one
anti-diagonal q + r = d at a time: every cell of a diagonal needs only the
two diagonals before it, so the coupled recurrence is solved as written,
with no closed form.  Results are kept by diagonal: cell (q, r) of tile b
is ``out[b, q + r, q]``.

Trace word of a cell (8 bits, as the program's kernels lay them out): bits
0-2 the T field, which the walk follows from a diagonal state; bits 3-6 set
when E, F, E_L, F_L opened at this cell (strictly better than extending),
which sends the walk back to the diagonal state.  T is the select tree of
Darwin's striped kernel: where H equals dag, E_L beats F_L beats the
diagonal (ZERO when H is 0); otherwise F beats F_L beats E_L beats E.

``bits`` = 8 is the benchmark's control: every value saturates to int8, as
an 8-bit SIMD lane would hold it.  32 is exact.
"""

from __future__ import annotations

import numpy as np

ZERO, DEL, INS, DEL_L, INS_L, DIAG = 0, 1, 2, 3, 4, 5
E_OPEN, F_OPEN, EL_OPEN, FL_OPEN = 8, 16, 32, 64
OP_I, OP_D, OP_M = 1, 2, 3
NEG = -(1 << 28)


def tile_dp(q, r, scoring, trace: bool, bits: int = 32):
    """DP over a batch of tiles: q (B, QT) / r (B, RT) int codes 0-4
    (cells past a tile's own size are computed and never read).  Returns
    (B, QT + RT - 1, QT) by diagonal: H as int32, or with ``trace`` the
    trace words as uint8."""
    sub, go, ge, goL, geL = scoring
    if bits == 32:
        def sat(x):
            return x
        neg = NEG
    else:
        lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1

        def sat(x):
            return np.clip(x, lo, hi, out=x)
        neg = lo
    B, QT = q.shape
    RT = r.shape[1]
    D = QT + RT - 1
    i32 = np.int32
    prof = np.asarray(sub, i32)[q]                       # (B, QT, 5)
    qi = np.arange(QT)
    bq = (np.arange(B)[:, None], qi[None, :])
    # diagonals d-1 and d-2 by row, column 0 holding row -1
    Hp1 = np.zeros((B, QT + 1), i32)
    Hp2 = np.zeros((B, QT + 1), i32)
    Fp = np.full((B, QT + 1), neg, i32)
    FLp = np.full((B, QT + 1), neg, i32)
    E1 = np.full((B, QT), neg, i32)
    EL1 = np.full((B, QT), neg, i32)
    out = np.empty((B, D, QT), np.uint8 if trace else i32)
    for d in range(D):
        s = prof[bq[0], bq[1], r[:, np.clip(d - qi, 0, RT - 1)]]
        dag = np.maximum(sat(Hp2[:, :-1] + s), 0)
        H1, Hu = Hp1[:, 1:], Hp1[:, :-1]
        e_open, e_ext = sat(H1 + go), sat(E1 + ge)
        el_open, el_ext = sat(H1 + goL), sat(EL1 + geL)
        f_open, f_ext = sat(Hu + go), sat(Fp[:, :-1] + ge)
        fl_open, fl_ext = sat(Hu + goL), sat(FLp[:, :-1] + geL)
        E = np.maximum(e_open, e_ext)
        EL = np.maximum(el_open, el_ext)
        F = np.maximum(f_open, f_ext)
        FL = np.maximum(fl_open, fl_ext)
        H = np.maximum(np.maximum(dag, E), np.maximum(np.maximum(EL, F), FL))
        if trace:
            is_el, is_fl = H == EL, H == FL
            td = np.where(is_el, DEL_L, np.where(
                is_fl, INS_L, np.where(H == 0, ZERO, DIAG)))
            tn = np.where(H == F, INS, np.where(
                is_fl, INS_L, np.where(is_el, DEL_L, DEL)))
            word = np.where(H == dag, td, tn).astype(np.uint8)
            word |= (e_open > e_ext).view(np.uint8) << 3
            word |= (f_open > f_ext).view(np.uint8) << 4
            word |= (el_open > el_ext).view(np.uint8) << 5
            word |= (fl_open > fl_ext).view(np.uint8) << 6
            out[:, d, :] = word
        else:
            out[:, d, :] = H
        # rows below the diagonal's first column are left of the tile
        # there: column -1 holds H = 0 and no gap state
        H[:, d + 1:] = 0
        E[:, d + 1:] = neg
        EL[:, d + 1:] = neg
        Hp1, Hp2 = Hp2, Hp1
        Hp1[:, 1:] = H
        Fp[:, 1:] = F
        FLp[:, 1:] = FL
        E1, EL1 = E, EL
    return out


def max_cell(H, qlen, rlen):
    """Max-cell mode (H by diagonal, as ``tile_dp`` gives it): (score, q,
    r) of the best cell in each tile's valid region, the first column
    holding it and its smallest row there; all 0 where no cell is
    positive."""
    B, D, QT = H.shape
    RT = D - QT + 1
    q = np.arange(QT)[:, None]
    rr = np.arange(RT)[None, :]
    full = H[:, q + rr, np.broadcast_to(q, (QT, RT))]   # (B, QT, RT)
    ok = ((q[None] < qlen[:, None, None]) & (rr[None] < rlen[:, None, None]))
    full = np.where(ok, full, -1)
    best = np.maximum(full.max(axis=(1, 2)), 0)
    hit = (full == best[:, None, None]) & (best[:, None, None] > 0)
    col = hit.any(axis=1).argmax(axis=1)
    row = hit[np.arange(B), :, col].argmax(axis=1)
    return best, row, col


def walk(Tr, start_q, start_r, max_tb: int):
    """Traceback of each tile from (start_q, start_r) over its trace words
    (by diagonal): ops in walk order (B, L) uint8 and their counts.  From
    the diagonal state a cell's T field picks the move; in a gap state the
    move repeats until the cell's open bit for that gap returns the walk
    to the diagonal state.  The walk stops at a ZERO T field, at the
    tile's edge, or once max_tb query or reference bases were consumed."""
    B, D, QT = Tr.shape
    RT = D - QT + 1
    b = np.arange(B)
    i = np.asarray(start_q, np.int64).copy()
    j = np.asarray(start_r, np.int64).copy()
    st = np.full(B, DIAG, np.int64)
    qs = np.zeros(B, np.int64)
    rs = np.zeros(B, np.int64)
    L = min(QT + RT, 2 * max_tb)
    ops = np.zeros((B, L + 1), np.uint8)
    n = np.zeros(B, np.int64)
    live = np.ones(B, bool)
    bit_of = np.zeros(8, np.int64)
    bit_of[[DEL, INS, DEL_L, INS_L]] = [E_OPEN, F_OPEN, EL_OPEN, FL_OPEN]
    for _ in range(L + 1):
        live &= (i >= 0) & (j >= 0) & (qs < max_tb) & (rs < max_tb)
        if not live.any():
            break
        ic = np.clip(i, 0, QT - 1)
        w = Tr[b, ic + np.clip(j, 0, RT - 1), ic].astype(np.int64)
        eff = np.where(st == DIAG, w & 7, st)
        m = live & (eff == DIAG)
        dl = live & ((eff == DEL) | (eff == DEL_L))
        il = live & ((eff == INS) | (eff == INS_L))
        live &= m | dl | il
        ops[b, np.where(live, n, L)] = np.where(m, OP_M,
                                                np.where(dl, OP_D, OP_I))
        back = m | ((w & bit_of[eff]) != 0)
        st = np.where(live, np.where(back, DIAG, eff), st)
        step_q = live & (m | il)
        step_r = live & (m | dl)
        i -= step_q
        j -= step_r
        qs += step_q
        rs += step_r
        n += live
    return ops[:, :L], n
