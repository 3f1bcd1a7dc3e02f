"""Meshes: one process's tile batches split over several devices
(counterpart of ``darwin_tpu/parallel/shard.py``).

darwin_tpu's mesh is single-controller: one process drives every local
chip through ``shard_map``.  Here a ``Mesh`` is a tuple of
``torch.device``s, and one process drives them the same way:

* each shard takes a contiguous block of a dispatch's B lanes (darwin_tpu's
  ``P("data")``; the blocks of ``torch.tensor_split``) and runs the
  one-device dispatch of ``ops/dispatch.py`` on its device, on the stream
  that device has for the calling thread; a shard with no lanes launches
  nothing;
* the genome and each read batch's codes are replicated (``Replicated``):
  one copy per distinct device, the tensor itself on its own device, so a
  mesh that names one card twice holds one genome;
* results come back shard by shard and merge in shard order.  Nothing
  crosses devices in the hot loop but the replicas and the filter's
  (3, B) scores, and nothing needs a process group.

A mesh may name one device more than once: the counterpart of the virtual
CPU devices darwin_tpu's tests run on, and how a machine with one card
runs the mesh path.  darwin_tpu pads each shard to 128 lanes, a TPU
workaround that is not carried over.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from darwin_tpu_torch.ops import dispatch
from darwin_tpu_torch.ops.gact_cuda import launches_into
from darwin_tpu_torch.utils.device import resolve_device


class Mesh(tuple):
    """The shards' devices in shard order: a tuple of ``torch.device``,
    each through ``resolve_device`` (an absent card raises)."""

    def __new__(cls, devices):
        devs = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        return super().__new__(cls, devs)

    def distinct(self):
        """The mesh's devices, each once, in shard order."""
        return tuple(dict.fromkeys(self))


def make_mesh(n: int | None = None, device_type: str = "cuda") -> Mesh:
    """A mesh over the first ``n`` local devices (darwin_tpu's
    ``make_mesh``): distinct cards, all of them when n is None, raising
    when fewer than n exist; for ``"cpu"``, n entries of the one CPU
    device (the tests' mesh)."""
    if device_type == "cpu":
        return Mesh(("cpu",) * (1 if n is None else n))
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}")
    have = torch.cuda.device_count()
    n = have if n is None else n
    if not 1 <= n <= have:
        raise ValueError(f"a mesh of {n} cards needs {n} local CUDA "
                         f"devices, have {have}")
    return Mesh(torch.device("cuda", i) for i in range(n))


def block(n_items: int, i: int, n: int) -> tuple[int, int]:
    """[start, stop) of block i when n_items split into n contiguous
    blocks, the first n_items % n one longer: torch.tensor_split's blocks
    (darwin_tpu's P("data") shards and its hosts' read blocks)."""
    base, extra = divmod(n_items, n)
    start = i * base + min(i, extra)
    return start, start + base + (i < extra)


class Replicated:
    """One copy of a tensor per distinct device of a mesh: the tensor
    itself on its own device, ``.to(dev)`` elsewhere (a peer copy between
    cards) — what a replicated sharding holds in darwin_tpu.  ``device``
    is the source tensor's."""

    def __init__(self, tensor: torch.Tensor, mesh: Mesh):
        self.device = tensor.device
        self.copies = {d: tensor.to(d, non_blocking=True)
                       for d in mesh.distinct()}

    def on(self, dev) -> torch.Tensor:
        return self.copies[dev]


def _on(x, dev):
    """``x``'s copy on ``dev``: a Replicated's, or a tensor moved there."""
    return x.on(dev) if isinstance(x, Replicated) else x.to(dev)


class _ShardLevels:
    """``SpecLevels`` of a mesh dispatch: lane b is lane b - starts[s] of
    shard s's levels, s the last shard whose lanes start at or before b."""

    def __init__(self, parts, starts):
        self._parts = parts
        self._starts = np.asarray(starts, np.int64)

    def take(self, j, lanes):
        lanes = np.asarray(lanes, np.int64)
        shard = np.searchsorted(self._starts, lanes, side="right") - 1
        ops = n_ops = None
        for s in np.unique(shard):
            sel = np.flatnonzero(shard == s)
            o, n = self._parts[s].take(j, lanes[sel] - self._starts[s])
            if ops is None:
                ops = np.empty((len(lanes), o.shape[1]), o.dtype)
                n_ops = np.empty(len(lanes), n.dtype)
            ops[sel], n_ops[sel] = o, n
        if ops is None:
            return self._parts[0].take(j, lanes)
        return ops, n_ops


class MeshDispatcher:
    """The one-device dispatches of ``ops/dispatch.py`` (the filter's first
    tiles and the extension chains) with every batch split over a mesh,
    same arguments and results (the codes may be ``Replicated``).

    Telemetry for one run: ``launches`` (per shard, kernel -> launches of
    that shard's dispatches), ``lanes`` (per shard, lanes dispatched) and
    ``cross_copies`` (tensor copies between two distinct devices: the
    replicas and the filter's scores)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n = len(mesh)
        self.launches = [{} for _ in mesh]
        self.lanes = [0] * self.n
        self.cross_copies = 0
        self._lock = threading.Lock()

    def replicate(self, tensor: torch.Tensor) -> Replicated:
        rep = Replicated(tensor, self.mesh)
        self._crossed(sum(d != tensor.device for d in rep.copies))
        return rep

    def _crossed(self, n):
        with self._lock:
            self.cross_copies += n

    def _shards(self, B):
        """(shard, device, lane slice) of each shard with lanes (``block``
        i of B)."""
        for i, dev in enumerate(self.mesh):
            lo, hi = block(B, i, self.n)
            if hi > lo:
                with self._lock:
                    self.lanes[i] += hi - lo
                yield i, dev, slice(lo, hi)

    @contextlib.contextmanager
    def _on_shard(self, i, dev):
        """Shard i's launches counted as its own, on its device."""
        with launches_into(self.launches[i]), (
                torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext()):
            yield

    def first_tile_scores(self, ref_codes, query_codes, r_start, r_size,
                          q_start, q_size, params, qt: int, rt: int):
        """``dispatch.first_tile_scores`` over the mesh; the shards' (3, b)
        results are joined on the first shard's device."""
        parts = []
        for i, dev, sl in self._shards(len(r_start)):
            with self._on_shard(i, dev):
                parts.append(dispatch.first_tile_scores(
                    _on(ref_codes, dev), _on(query_codes, dev),
                    r_start[sl], r_size[sl], q_start[sl], q_size[sl],
                    params, qt=qt, rt=rt)["packed"])
        home = parts[0].device
        self._crossed(sum(p.device != home for p in parts))
        packed = torch.cat([p.to(home, non_blocking=True) for p in parts], 1)
        return {"score": packed[0], "query_max_pos": packed[1],
                "ref_max_pos": packed[2], "packed": packed}

    def extend_tiles_async(self, ref_codes, query_codes, r_start, r_size,
                           q_start, q_size, rev, chrom_start, chrom_len,
                           q_buf_start, q_len, params, qt: int, rt: int,
                           max_tb: int, stop_thr: int, K: int):
        """``dispatch.extend_tiles_async`` over the mesh: each shard runs
        its lanes' whole chains (per-shard speculation needs no
        communication); results in lane order."""
        shards, starts = [], []
        for i, dev, sl in self._shards(len(r_start)):
            with self._on_shard(i, dev):
                shards.append(dispatch.extend_tiles_async(
                    _on(ref_codes, dev), _on(query_codes, dev),
                    *(np.asarray(x)[sl] for x in (
                        r_start, r_size, q_start, q_size, rev, chrom_start,
                        chrom_len, q_buf_start, q_len)),
                    params, qt, rt, max_tb, stop_thr, K))
            starts.append(sl.start)

        def resolve():
            parts = [r() for r in shards]
            out = {k: np.concatenate([p[k] for p in parts])
                   for k in ("ops", "n_ops", "q_steps", "r_steps", "score",
                             "query_max_pos", "ref_max_pos")}
            out["spec_req"] = [
                tuple(np.concatenate([p["spec_req"][j][f] for p in parts])
                      for f in range(4)) for j in range(K - 1)]
            out["ops_spec"] = _ShardLevels([p["ops_spec"] for p in parts],
                                           starts)
            return out
        return resolve
