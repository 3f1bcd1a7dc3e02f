"""Device dispatchers: tile gather from resident code buffers + tile DP
(+ traceback).  Counterpart of ``darwin_tpu/ops/dispatch.py``'s
``gather_tiles``, ``first_tile_scores`` and ``extend_tiles_async``.

The genome and the read batch live on the device as 1-byte 5-letter codes;
tiles are gathered by index arithmetic (a reversed tile is a reversed index
range) with int64 indices clamped into the buffer — lanes whose indices
fall outside hold garbage codes that the DP's length masking never reads
(darwin_tpu relies on uint32 wraparound for the same thing; an
out-of-range CUDA index would be a device assert).  Requests go up as one
(4|5, B) int64 transfer; results come back as one packed int32 transfer,
fetched only in ``resolve()``.

darwin_tpu's TPU transport workarounds are not carried over, and the
outputs are identical without them: 128-lane batch padding, compact 4/8-bit
records and the int16 result matrix, chunked >2^31 genome buffers, the
2-bit packed genome, and the sweep spill/rerun wiring (the port's
traceback kernel never spills).
"""

from __future__ import annotations

import numpy as np
import torch

from darwin_tpu_torch.ops import gact
from darwin_tpu_torch.ops.gact_cuda import dp_tiles, traceback_tiles

# extension-dispatch telemetry for this process: tiles, DP cells
# (tiles x ref x query) and, on CUDA, device milliseconds between events
# recorded around the DP + traceback launches (read back in resolve(),
# which synchronises anyway).  reset_ext_stats() zeroes it.
EXT_STATS = {"dispatches": 0, "tiles": 0, "cells": 0, "device_ms": 0.0}


def reset_ext_stats():
    EXT_STATS.update(dispatches=0, tiles=0, cells=0, device_ms=0.0)


def gather_tiles(ref_codes, query_codes, r_start, r_size, q_start, q_size,
                 rev, qt: int, rt: int):
    """(B, qt) query and (B, rt) ref tiles from the code buffers.
    r_start/r_size/q_start/q_size: (B,) int64 device tensors; rev (B,) bool
    gathers both tiles reversed (the right-extension orientation)."""
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


def _upload(device, *rows):
    """One host->device transfer of the request vectors, as int64 rows."""
    req = torch.from_numpy(np.stack([np.asarray(r, np.int64) for r in rows]))
    return req.to(device)


def first_tile_scores(ref_codes, query_codes, r_start, r_size, q_start,
                      q_size, params, qt: int, rt: int):
    """Filter-stage dispatch: max-cell scores + positions, no traceback.
    Returns device tensors {score, query_max_pos, ref_max_pos} and
    ``packed`` (3, B) int32 holding all three for one fetch."""
    req = _upload(ref_codes.device, r_start, r_size, q_start, q_size)
    B = req.shape[1]
    rev = torch.zeros(B, dtype=torch.bool, device=req.device)
    qtile, rtile = gather_tiles(ref_codes, query_codes, req[0], req[1],
                                req[2], req[3], rev, qt, rt)
    res = dp_tiles(qtile, rtile, req[3].to(torch.int32),
                   req[1].to(torch.int32), rev, params, with_trace=False)
    packed = torch.stack([res["score"], res["query_max_pos"],
                          res["ref_max_pos"]])
    return {"score": packed[0], "query_max_pos": packed[1],
            "ref_max_pos": packed[2], "packed": packed}


def extend_tiles_async(ref_codes, query_codes, r_start, r_size, q_start,
                       q_size, rev, params, qt: int, rt: int, max_tb: int):
    """Extension-stage dispatch (start-to-end tiles with traceback), split
    into enqueue + resolve: the gather, DP and traceback are enqueued now;
    the returned zero-arg ``resolve()`` fetches the packed records + stats
    (the one host sync) and expands the records into op arrays.

    resolve() -> {ops (B, L) uint8, n_ops, q_steps, r_steps, score,
    query_max_pos, ref_max_pos}, L = min(qt + rt, 2 * max_tb)."""
    dev = ref_codes.device
    req = _upload(dev, r_start, r_size, q_start, q_size, rev)
    B = req.shape[1]
    timed = dev.type == "cuda"
    if timed:
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
    qtile, rtile = gather_tiles(ref_codes, query_codes, req[0], req[1],
                                req[2], req[3], req[4] != 0, qt, rt)
    q_size32 = req[3].to(torch.int32)
    r_size32 = req[1].to(torch.int32)
    se = torch.ones(B, dtype=torch.bool, device=dev)
    if timed:
        ev0.record()
    res = dp_tiles(qtile, rtile, q_size32, r_size32, se, params,
                   with_trace=True)
    rec, q_steps, r_steps = traceback_tiles(
        res["trace"], q_size32 - 1, r_size32 - 1, max_tb)
    if timed:
        ev1.record()
    packed = torch.cat([rec, torch.stack(
        [q_steps, r_steps, res["score"], res["query_max_pos"],
         res["ref_max_pos"]])])
    L = min(qt + rt, 2 * max_tb)

    def resolve():
        p = packed.cpu().numpy()
        if timed:
            EXT_STATS["device_ms"] += ev0.elapsed_time(ev1)
        EXT_STATS["dispatches"] += 1
        EXT_STATS["tiles"] += B
        EXT_STATS["cells"] += B * qt * rt
        R = p.shape[0] - 5
        ops, n_ops = gact.expand_records(p[:R], B, L)
        tail = p[R:]
        return {"ops": ops, "n_ops": n_ops, "q_steps": tail[0],
                "r_steps": tail[1], "score": tail[2],
                "query_max_pos": tail[3], "ref_max_pos": tail[4]}
    return resolve
