"""Wrappers of the GACT kernels (counterpart of
``darwin_tpu/ops/gact_pallas.py``'s ``_dp_call`` and ``_tb_call``), and the
launch counts of every kernel of the package.

``dp_tiles`` launches ``csrc/gact_dp.cu`` and ``traceback_tiles`` launches
``csrc/gact_tb.cu`` for CUDA tensors, on the current stream, without
synchronising.  A tensor on the CPU takes the kernel's plain twin in
``ops/gact.py``; any other device raises.  An empty batch returns empty
outputs on any device and launches nothing.  Each wrapper checks device,
dtype, shape and contiguity, allocates its outputs, raises when the launch
is refused (the limits live in the sources alone: ``csrc/gact.h``,
``csrc/int_probe.cu``), and adds one
to its launch count (``LAUNCHES``) where — and only where — it launches
its kernel.
"""

from __future__ import annotations

import ctypes

import torch

from darwin_tpu_torch.ops import build, gact

# kernel launches in this process, by kernel (plain-twin calls on CPU
# tensors do not count); reset_launches() zeroes them
LAUNCHES = {"gact_dp": 0, "gact_tb": 0, "int_probe": 0}

_CUDA_ERROR_INVALID_VALUE = 1      # what the sources' limits checks return


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_tensor(name, t, dtype, ndim, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f"{name}: expected {ndim}-D {dtype}, got "
                        f"{t.dim()}-D {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def count_launch(name, err, shape):
    """Count a launch the library made; raise on a refusal."""
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"{name}: {shape} is outside the limits its "
                         f"source states (csrc/)")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def dp_tiles(qcodes, rcodes, qlens, rlens, start_end, params, with_trace):
    """Batched tile DP.  qcodes (B, QT) / rcodes (B, RT) uint8 codes 0-4,
    qlens / rlens (B,) int32 in [0, QT] / [0, RT], start_end (B,) bool.
    Returns {score, query_max_pos, ref_max_pos} (B,) int32 and, with_trace,
    ``trace`` (B, RT, QT) uint8 — the tile-contiguous layout
    (darwin_tpu's Pallas kernel emits (RT, QT, B)).  Its bytes at q >= qlen
    or r >= rlen are unspecified (the card does not write them, the twin
    computes them from the codes beyond the lengths): a walk from any cell
    inside moves up and left and never reads them.  A tile with an empty
    side reports (0, 0) in max-cell mode and has word (0, 0) ZERO on either
    device, so a walk from the reported cell stops at once."""
    dev = qcodes.device
    check_tensor("qcodes", qcodes, torch.uint8, 2, dev)
    check_tensor("rcodes", rcodes, torch.uint8, 2, dev)
    for name, t in (("qlens", qlens), ("rlens", rlens)):
        check_tensor(name, t, torch.int32, 1, dev)
    check_tensor("start_end", start_end, torch.bool, 1, dev)
    (B, QT), RT = qcodes.shape, rcodes.shape[1]
    if not (rcodes.shape[0] == qlens.shape[0] == rlens.shape[0]
            == start_end.shape[0] == B):
        raise ValueError("dp_tiles: batch sizes differ")
    if B == 0:
        out = {k: torch.empty(0, dtype=torch.int32, device=dev)
               for k in ("score", "query_max_pos", "ref_max_pos")}
        if with_trace:
            out["trace"] = torch.empty((0, RT, QT), dtype=torch.uint8,
                                       device=dev)
        return out
    if dev.type == "cpu":
        return gact.batch_align(qcodes, rcodes, qlens, rlens, start_end,
                                params, with_trace=with_trace)
    if dev.type != "cuda":
        raise ValueError(f"dp_tiles: unsupported device {dev}")
    lib = build.load()
    out = {k: torch.empty(B, dtype=torch.int32, device=dev)
           for k in ("score", "query_max_pos", "ref_max_pos")}
    trace = (torch.empty((B, RT, QT), dtype=torch.uint8, device=dev)
             if with_trace else None)
    sub = (ctypes.c_int32 * 25)(*[v for row in params.sub for v in row])
    with torch.cuda.device(dev):
        err = lib.gact_dp(
            ptr(qcodes), ptr(rcodes), ptr(qlens), ptr(rlens),
            ptr(start_end), B, QT, RT, ctypes.cast(sub, ctypes.c_void_p),
            params.gap_open, params.gap_extend, params.long_gap_open,
            params.long_gap_extend, ptr(out["score"]),
            ptr(out["query_max_pos"]), ptr(out["ref_max_pos"]),
            ctypes.c_void_p(trace.data_ptr() if with_trace else None),
            stream_ptr(dev))
    count_launch("gact_dp", err, f"tile {QT}x{RT} (query x ref), B={B}")
    if with_trace:
        out["trace"] = trace
    return out


def dp_plan(B: int, QT: int):
    """(S, W) that ``dp_tiles`` launches with for B tiles of QT query rows
    on the card: S rows per lane, W warps per tile (csrc/gact_dp.cu)."""
    s, w = ctypes.c_int(), ctypes.c_int()
    err = build.load().gact_dp_plan(B, QT, ctypes.byref(s), ctypes.byref(w))
    if err != 0:
        raise ValueError(f"gact_dp_plan: B={B}, QT={QT} is outside the "
                         f"limits its source states (csrc/gact.h)")
    return s.value, w.value


def traceback_tiles(trace, start_q, start_r, max_tb: int):
    """Batched traceback walk.  trace (B, RT, QT) uint8; start_q / start_r
    (B,) int32.  Returns (rec (RT, B) int32 — ``nI | closing << 14`` per
    visited column, 0 elsewhere — q_steps (B,) int32, r_steps (B,) int32)."""
    dev = trace.device
    check_tensor("trace", trace, torch.uint8, 3, dev)
    check_tensor("start_q", start_q, torch.int32, 1, dev)
    check_tensor("start_r", start_r, torch.int32, 1, dev)
    B, RT, QT = trace.shape
    if not start_q.shape[0] == start_r.shape[0] == B:
        raise ValueError("traceback_tiles: batch sizes differ")
    if max_tb < 1:
        raise ValueError(f"traceback_tiles: max_tb must be >= 1: {max_tb}")
    if B == 0:
        empty = torch.empty(0, dtype=torch.int32, device=dev)
        return (torch.empty((RT, 0), dtype=torch.int32, device=dev), empty,
                empty.clone())
    if dev.type == "cpu":
        return gact.traceback(trace, start_q, start_r, max_tb)
    if dev.type != "cuda":
        raise ValueError(f"traceback_tiles: unsupported device {dev}")
    lib = build.load()
    rec = torch.zeros((RT, B), dtype=torch.int32, device=dev)
    q_steps = torch.empty(B, dtype=torch.int32, device=dev)
    r_steps = torch.empty(B, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.gact_tb(ptr(trace), ptr(start_q), ptr(start_r), B, QT,
                          RT, int(max_tb), ptr(rec), ptr(q_steps),
                          ptr(r_steps), stream_ptr(dev))
    count_launch("gact_tb", err, f"trace {QT}x{RT} (query x ref), B={B}")
    return rec, q_steps, r_steps
