"""GACT tile DP and traceback: scoring parameters, the 8-bit trace word,
and the plain PyTorch twins of the two CUDA kernels.

Counterpart of ``darwin_tpu/ops/gact.py`` and of the Pallas kernels in
``darwin_tpu/ops/gact_pallas.py``.  ``batch_align`` is the twin of
``csrc/gact_dp.cu`` (which replaces ``_dp_kernel`` and
``_dp_strip_kernel``); ``traceback`` is the twin of ``csrc/gact_tb.cu``
(which replaces ``_tb_kernel`` and ``_tb_kernel_safe``); ``spec_next_tiles``
(``spec_next``, ``gather_tiles``, ``tile_sizes``) is the twin of
``csrc/gact_next.cu``.  All run on any device; ``ops/gact_cuda.py`` routes
CPU tensors here and CUDA tensors to the kernels.  ``expand_records`` turns
fetched records into op arrays on the host, in the native host library.

The DP is the exact recurrence of ``darwin_tpu.ops.oracle.clean_align``
(two-piece affine local Smith-Waterman), for any scoring: the within-column
lanes F/F_L solve the coupled recurrence F(q) = max(H(q-1) + go, F(q-1) +
ge), the kernel row by row, this twin in closed form.  ``darwin_tpu`` does
so only where opening a gap is cheaper than extending it on either lane;
elsewhere (the default ``params.cfg``) it takes prefix-max scans and
windows them (``oracle.gap_scan_windows``).  There H, the T field, scores,
max positions and every walked traceback record are identical; only F/F_L
open bits at cells no traceback can read may differ from ``darwin_tpu``'s
trace bytes (see ``gap_scan_windows`` for the proof).  Where ``darwin_tpu``
takes the coupled recurrence too, every trace byte is equal.  The port's
kernel and twin agree byte for byte for every scoring.

Trace layout: ``(B, RT, QT)`` uint8, a tile contiguous (``darwin_tpu``
uses ``(RT, B, QT)`` for lax and ``(RT, QT, B)`` for Pallas).
Traceback records: ``(RT, B)`` int32, ``nI | closing << 14`` per column,
exactly ``_tb_kernel_safe``'s.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from darwin_tpu_torch import native

# 8-bit trace word (darwin_tpu/ops/gact.py:45-54).  Bits 0-2: exclusive T
# field; bits 3-6: gap-source "open" flags (set = the gap opened here, the
# traceback returns to DIAG).
T8_ZERO = 0
T8_DEL = 1
T8_INS = 2
T8_DEL_L = 3
T8_INS_L = 4
T8_DIAG = 5
E_OPEN8 = 8
F_OPEN8 = 16
EL_OPEN8 = 32
FL_OPEN8 = 64

# 2-bit traceback op codes (darwin_tpu/ops/oracle.py:67-70)
OP_NONE = 0
OP_I = 1   # consumes one query base
OP_D = 2   # consumes one reference base
OP_M = 3   # consumes one of each


class GactParams(NamedTuple):
    """Scoring as plain ints (darwin_tpu/ops/gact.py:75-81 holds the same
    fields as device scalars)."""
    sub: tuple               # 5x5 tuple of tuples (A, C, G, T, N)
    gap_open: int
    gap_extend: int
    long_gap_open: int
    long_gap_extend: int


def make_params(cfg) -> GactParams:
    """darwin_tpu/ops/gact.py:126-133."""
    return GactParams(
        sub=tuple(tuple(int(v) for v in row) for row in cfg.sub_matrix_5x5),
        gap_open=int(cfg.gap_open), gap_extend=int(cfg.gap_extend),
        long_gap_open=int(cfg.long_gap_open),
        long_gap_extend=int(cfg.long_gap_extend))


NEG_INF = -(1 << 28)    # F(-1): survives "+ gap extend", never wins a max


def batch_align(qcodes, rcodes, qlens, rlens, start_end, params: GactParams,
                with_trace: bool = True):
    """Plain twin of the ``gact_dp`` kernel: align a batch of tiles.

    qcodes (B, QT) / rcodes (B, RT) uint8 5-letter codes; qlens/rlens (B,)
    int32 actual sizes (0..QT / 0..RT); start_end (B,) bool — score at the
    end cell (qlen-1, rlen-1) instead of max-cell mode.

    Returns a dict of (B,) int32 ``score``, ``query_max_pos``,
    ``ref_max_pos`` and, with_trace, ``trace`` (B, RT, QT) uint8.  Trace
    bytes at q >= qlen or r >= rlen are unspecified (here: computed from the
    codes beyond the lengths; the kernel leaves them unwritten), but for
    word (0, 0) of a tile with an empty side, which is ZERO: max-cell mode
    reports (0, 0) for such a tile, and a walk from there stops at once.
    """
    dev = qcodes.device
    i32 = torch.int32
    B, QT = qcodes.shape
    RT = rcodes.shape[1]
    go, ge = params.gap_open, params.gap_extend
    goL, geL = params.long_gap_open, params.long_gap_extend
    qlens = qlens.to(i32)
    rlens = rlens.to(i32)

    sub = torch.tensor(params.sub, dtype=i32, device=dev)
    prof5 = sub[qcodes.long()]                         # (B, QT, 5)
    rc = rcodes.long()
    q_idx = torch.arange(QT, dtype=i32, device=dev)[None, :]
    valid_q = q_idx < qlens[:, None]
    q_end = (qlens - 1).clamp(0, max(QT - 1, 0)).long()[:, None]
    # the coupled recurrence F(q) = max(H(q-1)+go, F(q-1)+ge) (same for
    # F_L) in closed form (gact_pallas.py:196-223), exact for any scoring:
    # two prefix-max scans go + sf*(q-1) + max_{j=-1..q-1}(Hp(j) - sf*j)
    # with slopes sf = max(go, ge), sfl = max(goL, geL), the j = -1 term
    # (Hp(-1) = 0) being the first column of the cummax input below, plus
    # one term p3 shared by both lanes, a one-row shift of the steeper scan
    sf, sfl = max(go, ge), max(goL, geL)
    slope_m = max(sf, sfl)
    ramp_f = sf * (q_idx - 1) + go
    ramp_fl = sfl * (q_idx - 1) + goL
    ramp_p3 = slope_m * (q_idx - 1) + (go + goL - slope_m)
    tilt_f = sf * q_idx[:, :-1]
    tilt_fl = sfl * q_idx[:, :-1]

    def col(v):
        return torch.full((B, 1), v, dtype=i32, device=dev)

    zero1, sf1, sfl1, neg1 = col(0), col(sf), col(sfl), col(NEG_INF)
    raw_row0 = col(F_OPEN8 | FL_OPEN8)     # row 0's F/F_L bits are open
    h = torch.zeros((B, QT), dtype=i32, device=dev)
    e = torch.full((B, QT), go, dtype=i32, device=dev)
    el = torch.full((B, QT), goL, dtype=i32, device=dev)
    ebits = torch.full((B, QT), E_OPEN8 | EL_OPEN8, dtype=i32, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    best_q = torch.zeros(B, dtype=i32, device=dev)
    best_r = torch.zeros(B, dtype=i32, device=dev)
    h_end = torch.zeros(B, dtype=i32, device=dev)
    trace = (torch.empty((B, RT, QT), dtype=torch.uint8, device=dev)
             if with_trace else None)
    track = bool((~start_end).any())

    for r in range(RT):
        prof = torch.gather(prof5, 2, rc[:, r].view(B, 1, 1).expand(B, QT, 1))
        prof = prof.squeeze(2)
        dag = (torch.cat([zero1, h[:, :-1]], 1) + prof).clamp_min(0)
        hp = torch.maximum(torch.maximum(dag, e), el)
        cmf = torch.cummax(
            torch.cat([sf1, hp[:, :-1] - tilt_f], 1), 1).values
        cmfl = torch.cummax(
            torch.cat([sfl1, hp[:, :-1] - tilt_fl], 1), 1).values
        cm = cmf if sf >= sfl else cmfl
        p3 = ramp_p3 + torch.cat([neg1, cm[:, :-1]], 1)
        f = torch.maximum(ramp_f + cmf, p3)
        fl = torch.maximum(ramp_fl + cmfl, p3)
        h = torch.maximum(hp, torch.maximum(f, fl))

        if with_trace:
            # T field: darwin_tpu's select tree (gact_pallas.py:233-244)
            is_f, is_fl, is_el = h == f, h == fl, h == el
            dz = torch.where(h == 0, T8_ZERO, T8_DIAG)
            td = torch.where(is_el, T8_DEL_L, torch.where(is_fl, T8_INS_L,
                                                          dz))
            tn = torch.where(is_f, T8_INS, torch.where(
                is_fl, T8_INS_L, torch.where(is_el, T8_DEL_L, T8_DEL)))
            t = torch.where(h == dag, td, tn)
            # F/F_L open bits of row q compare row q-1 (gact_pallas.py:
            # 249-252); row 0 is open for both
            raw = (torch.where(h + go > f + ge, F_OPEN8, 0)
                   + torch.where(h + goL > fl + geL, FL_OPEN8, 0))
            word = t + ebits + torch.cat([raw_row0, raw[:, :-1]], 1)
            trace[:, r, :] = word.to(torch.uint8)
            ebits = (torch.where(h + go > e + ge, E_OPEN8, 0)
                     + torch.where(h + goL > el + geL, EL_OPEN8, 0))
        e = torch.maximum(h + go, e + ge)
        el = torch.maximum(h + goL, el + geL)

        if track:
            # earliest column with a strict improvement, then the smallest
            # q in it; invalid cells hold -1 (gact_pallas.py:267-278)
            hm = torch.where(valid_q & (r < rlens)[:, None], h, -1)
            colmax = hm.max(1).values
            colarg = (hm == colmax[:, None]).to(i32).argmax(1).to(i32)
            improved = colmax > best
            best = torch.where(improved, colmax, best)
            best_q = torch.where(improved, colarg, best_q)
            best_r = torch.where(improved, r, best_r)
        h_at = torch.gather(h, 1, q_end).squeeze(1)
        h_end = torch.where((rlens == r + 1) & (qlens > 0), h_at, h_end)

    out = {"score": torch.where(start_end, h_end, best),
           "query_max_pos": torch.where(start_end, qlens - 1, best_q),
           "ref_max_pos": torch.where(start_end, rlens - 1, best_r)}
    if with_trace:
        if RT and QT:
            trace[(qlens <= 0) | (rlens <= 0), 0, 0] = T8_ZERO
        out["trace"] = trace
    return out


def traceback(trace, start_q, start_r, max_tb: int):
    """Plain twin of the ``gact_tb`` kernel: walk each tile's trace from
    (start_q, start_r) with ``_tb_kernel_safe``'s state machine
    (gact_pallas.py:756-841; the reference's Processor.cpp:585-716).

    trace (B, RT, QT) uint8; start_q/start_r (B,) int32 (a lane whose
    start_r lies outside [0, RT) does not walk).  The walk stops on a ZERO
    T field, on i < 0, or when q or r steps reach max_tb (checked before
    every op).  Returns (rec (RT, B) int32 with ``nI | closing << 14`` per
    visited column and 0 elsewhere, q_steps (B,), r_steps (B,)).
    """
    dev = trace.device
    B, RT, QT = trace.shape
    i64 = torch.int64
    flat = trace.reshape(-1)
    lanes = torch.arange(B, dtype=i64, device=dev)
    base = lanes * (RT * QT)
    i = start_q.to(i64).clone()
    j = start_r.to(i64).clone()
    active = (j >= 0) & (j < RT)
    st = torch.full((B,), T8_DIAG, dtype=i64, device=dev)
    qs = torch.zeros(B, dtype=i64, device=dev)
    rs = torch.zeros(B, dtype=i64, device=dev)
    n_ins = torch.zeros(B, dtype=i64, device=dev)
    rec = torch.zeros((RT, B), dtype=torch.int32, device=dev)
    # every live step emits one op; ops are bounded by both caps and by
    # the tile's extent, plus one step to observe the stop
    for step in range(min(QT + RT, 2 * max_tb) + 2):
        if step % 64 == 63 and not bool(active.any()):
            break
        ended = (qs == max_tb) | (rs == max_tb) | (i < 0) | (j < 0)
        idx = base + j.clamp(0, RT - 1) * QT + i.clamp(0, QT - 1)
        w = torch.where(i < QT, flat[idx].to(i64), 0)
        eff = torch.where(st == T8_DIAG, w & 7, st)
        live = active & ~ended
        is_m = live & (eff == T8_DIAG)
        is_d = live & ((eff == T8_DEL) | (eff == T8_DEL_L))
        is_i = live & ((eff == T8_INS) | (eff == T8_INS_L))
        stop = active & ~(is_m | is_d | is_i)
        close = is_m | is_d
        val = torch.where(close, n_ins | (torch.where(is_m, OP_M, OP_D)
                                          << 14), n_ins)
        wr = close | (stop & (j >= 0))
        rec[j[wr], lanes[wr]] = val[wr].to(torch.int32)
        open_bit = torch.where(
            eff == T8_DEL, w & E_OPEN8, torch.where(
                eff == T8_INS, w & F_OPEN8, torch.where(
                    eff == T8_DEL_L, w & EL_OPEN8, w & FL_OPEN8)))
        nst = torch.where(is_m | (open_bit != 0), T8_DIAG, eff)
        st = torch.where(live, nst, st)
        step_q = (is_m | is_i).to(i64)
        qs += step_q
        i -= step_q
        rs += close.to(i64)
        j -= close.to(i64)
        n_ins = torch.where(close, 0, n_ins + is_i.to(i64))
        active = active & ~stop
    return rec, qs.to(torch.int32), rs.to(torch.int32)


def spec_next(rec, lane, curr, T: int, stop_thr: int, max_ops: int):
    """The request part of the ``gact_next`` kernel's twin: the next square
    tile of a speculative chain, from the walker's records of the tile
    before.

    The advance (dr, dq) is darwin_tpu/ops/dispatch.py:_device_consumed
    (:273-329) term for term: the walk's op stream cut at L = 32 *
    ceil(max_ops / 32) ops, taken per 32-op word, a word only up to and
    including its first M once the applied count at the word's start plus
    the M's 1-based place reaches ``stop_thr``.  The new position and the
    next tile are the arithmetic of _extend_round_spec_pallas (:433-451),
    in int64.

    rec (RT, B) int32 records (``nI | closing << 14`` per column); lane
    (5, B) int64 rows rev, chrom_start, chrom_len, q_buf_start, q_len;
    curr (2, B) int64 rows curr_ref, curr_q.  Returns (8, B) int64 rows
    r_start, r_size, q_start, q_size, curr_ref, curr_q, dr, dq."""
    dev = rec.device
    i64 = torch.int64
    RT, B = rec.shape
    w = rec.to(i64).flip(0)                     # walk order
    n_ins = w & 0x3FFF
    closing = (w >> 14) & 0x3
    has_close = (closing != 0).to(i64)
    ends = torch.cumsum(n_ins + has_close, 0)
    n_ops = ends[-1] if RT else torch.zeros(B, dtype=i64, device=dev)
    L = -(-max_ops // 32) * 32
    # the stream: I everywhere, each closing op at its place (places past
    # L go to a spare row), 0 past the stream's end
    ops = torch.full((L + 1, B), OP_I, dtype=i64, device=dev)
    close_pos = torch.where(has_close == 1, ends - 1, L).clamp_(max=L)
    ops.scatter_(0, close_pos, torch.where(has_close == 1, closing, OP_I))
    ops = ops[:L]
    opidx = torch.arange(L, dtype=i64, device=dev)[:, None]
    ops = torch.where(opidx < n_ops[None, :], ops, 0)
    bidx = torch.arange(1, 33, dtype=i64, device=dev)[:, None]
    count = torch.zeros(B, dtype=i64, device=dev)
    dr = torch.zeros(B, dtype=i64, device=dev)
    dq = torch.zeros(B, dtype=i64, device=dev)
    for t0 in range(0, L, 32):
        blk = ops[t0:t0 + 32]
        cond = (count[None, :] + bidx >= stop_thr) & (blk == OP_M)
        first = torch.where(cond, bidx, 33).min(0).values
        consumed = torch.minimum(first.clamp(max=32),
                                 (n_ops - t0).clamp(0, 32))
        take = bidx <= consumed[None, :]
        dr += (take & (blk != OP_I)).sum(0)
        dq += (take & (blk != OP_D)).sum(0)
        count += consumed
    rev = lane[0] != 0
    chrom_start, chrom_len, q_buf_start, q_len = lane[1], lane[2], lane[3], \
        lane[4]
    cr = torch.where(rev, torch.minimum(curr[0] + dr, chrom_len),
                     (curr[0] - dr).clamp(min=0))
    cq = torch.where(rev, torch.minimum(curr[1] + dq, q_len),
                     (curr[1] - dq).clamp(min=0))
    r_size = torch.where(rev, (chrom_len - cr).clamp(max=T),
                         (cr + 1).clamp(max=T)).clamp(min=1)
    q_size = torch.where(rev, (q_len - cq).clamp(max=T),
                         (cq + 1).clamp(max=T)).clamp(min=1)
    r_rel = torch.where(rev, cr, torch.where(cr >= T, cr - T + 1, 0))
    q_rel = torch.where(rev, cq, torch.where(cq >= T, cq - T + 1, 0))
    return torch.stack([chrom_start + r_rel, r_size, q_buf_start + q_rel,
                        q_size, cr, cq, dr, dq])


def gather_tiles(ref_codes, query_codes, r_start, r_size, q_start, q_size,
                 rev, qt: int, rt: int):
    """(B, qt) query and (B, rt) ref tiles from the code buffers
    (darwin_tpu/ops/dispatch.py:gather_tiles).  r_start/r_size/q_start/
    q_size: (B,) int64 tensors; rev (B,) bool gathers both tiles reversed
    (the right-extension orientation).  Indices are clamped into the
    buffers in int64, so a lane whose request points outside them holds
    the end codes (darwin_tpu relies on uint32 wraparound there)."""
    dev = ref_codes.device
    i = torch.arange(rt, dtype=torch.int64, device=dev)[None, :]
    ridx = torch.where(rev[:, None], (r_start + r_size - 1)[:, None] - i,
                       r_start[:, None] + i)
    j = torch.arange(qt, dtype=torch.int64, device=dev)[None, :]
    qidx = torch.where(rev[:, None], (q_start + q_size - 1)[:, None] - j,
                       q_start[:, None] + j)
    rtile = ref_codes[ridx.clamp_(0, ref_codes.shape[0] - 1)]
    qtile = query_codes[qidx.clamp_(0, query_codes.shape[0] - 1)]
    return qtile, rtile


def tile_sizes(q_size, r_size):
    """(4, B) int32 rows q_size, r_size, q_size - 1, r_size - 1: a level's
    tile sizes as ``gact_dp`` takes them and the walk's start as
    ``gact_tb`` takes it."""
    q32, r32 = q_size.to(torch.int32), r_size.to(torch.int32)
    return torch.stack([q32, r32, q32 - 1, r32 - 1])


def spec_next_tiles(rec, lane, curr, ref_codes, query_codes, T: int,
                    stop_thr: int, max_ops: int):
    """Plain twin of the ``gact_next`` kernel: ``spec_next``'s (8, B)
    int64 request rows, then the next level's inputs — its (B, T) query
    and ref tiles as ``gather_tiles`` cuts them and its ``tile_sizes``."""
    req = spec_next(rec, lane, curr, T, stop_thr, max_ops)
    qtile, rtile = gather_tiles(ref_codes, query_codes, req[0], req[1],
                                req[2], req[3], lane[0] != 0, T, T)
    return req, qtile, rtile, tile_sizes(req[3], req[1])


def expand_records(rec: np.ndarray, n_valid: int, L: int):
    """Per-column (nI, closing) records -> the serial walker's op arrays
    (darwin_tpu/ops/gact_pallas.py:920-975), in the native host library.

    rec: (RT, B) int32, any strided view.  Returns ops (n_valid, L) uint8
    in walk order + the true op counts n_ops (n_valid,) int32; ops past L
    are dropped, and columns the walk did not visit hold zero records and
    expand to no ops.
    """
    res = native.expand_records_native(rec, n_valid, L)
    if res is None:
        raise RuntimeError("record expansion: " + native.unavailable_reason())
    return res
