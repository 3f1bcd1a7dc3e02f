"""darwin_tpu's default extension path in darwin_tpu_torch, against
darwin_tpu on the CPU: the next-tile rule of the speculative chains
(``gact.spec_next``, the twin of the ``gact_next`` kernel), the K-tile
speculative dispatch, ``run()`` at every tested chain depth and number of
read batches in flight, its stage telemetry and ``--index-cache``; and a
numpy transcription of the ``gact_next`` kernel's schedule (warp-wide
scan, a ballot per word, the warp's carry, the fused tile gather) held to
the twin and to darwin_tpu.
Tolerance: none — integers are equal, SAM bytes and the counter block
identical.

darwin_tpu's speculative dispatch runs as its own tests run it on the CPU
(tests/test_spec_dispatch.py): its Pallas kernels in interpret mode
(``DARWIN_TPU_KERNEL=pallas``, ``DARWIN_TPU_PALLAS_INTERPRET=1``); its
``run()`` otherwise takes its lax path, which has no speculation."""

import io
import itertools
import os
import re
import threading
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from darwin_tpu.config import Config as JConfig
from darwin_tpu.genome import GenomeStore as JGenomeStore
from darwin_tpu.index import seed_table as jst
from darwin_tpu.ops import dispatch as jdisp, gact as jgact
from darwin_tpu.pipeline.align import run as jax_run
from darwin_tpu_torch import cli
from darwin_tpu_torch.config import Config
from darwin_tpu_torch.genome import GenomeStore, encode5, revcomp_bytes
from darwin_tpu_torch.ops import dispatch, gact, gact_cuda
from darwin_tpu_torch.pipeline.align import run
from darwin_tpu_torch.utils.simulate import mutate_read

torch.set_num_threads(2)

T = 384
MAX_OPS = 2 * T
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _block(err: str):
    return [ln for ln in err.splitlines() if ln.startswith("#")]


def _spec_line(err: str):
    """(hits, misses, rounds) from the port's spec line."""
    ln = next(x for x in err.splitlines() if "#spec hits" in x)
    return tuple(int(re.search(f"#{k}: (\\d+)", ln).group(1))
                 for k in ("spec hits", "spec misses", "extend rounds"))


# ------------------------------------------------------ (a) the next tile

def _walker_records(rng, B):
    """Records of the port's twin walker on B 384x384 start-to-end tiles:
    mutated copies (long diagonals, indels) and unrelated pairs."""
    r = rng.integers(0, 4, (B, T)).astype(np.uint8)
    q = np.empty_like(r)
    for b in range(B):
        if b % 3 == 2:
            q[b] = rng.integers(0, 4, T)
            continue
        seq = mutate_read(rng, ACGT[r[b]], 0.04, 0.03, 0.03)
        seq = np.concatenate([encode5(seq), rng.integers(0, 4, T)])
        q[b] = seq[:T]
    lens = torch.full((B,), T, dtype=torch.int32)
    res = gact.batch_align(torch.from_numpy(q), torch.from_numpy(r), lens,
                           lens, torch.ones(B, dtype=torch.bool),
                           gact.make_params(Config()))
    return gact.traceback(res["trace"], lens - 1, lens - 1, 2 * T)[0]


def _synthetic_records(rng):
    """Insert runs up to the 14-bit limit, all-M and all-D walks, an empty
    walk, a lone insert run, and random mixes (closing I included, which
    _device_consumed takes like any op)."""
    cols = []

    def col(n_ins, closing):
        c = np.zeros(T, np.int64)
        c[:] = np.asarray(n_ins) | (np.asarray(closing) << 14)
        return c
    cols.append(col(0, gact.OP_M))                        # all M
    cols.append(col(0, gact.OP_D))                        # all D
    cols.append(col(0, 0))                                # empty walk
    c = col(0, 0)
    c[T - 1] = 0x3FFF                                     # 16383 I's
    cols.append(c)
    c = col(0, gact.OP_M)
    c[200] = 0x3FFF | gact.OP_M << 14                     # a huge I run
    cols.append(c)
    c = col(0, gact.OP_M)
    c[:T // 2] = 0                                        # half a walk
    c[T // 2] = 5                                         # ends in I's
    cols.append(c)
    M = gact.OP_M << 14
    # walks given in walk order (record row T - 1 first), all M after the
    # ops listed: a closing M at word places 31 and 32; a closing M at
    # place 32 on the step's last column (a zero column first); an insert
    # run over three words; a step of 37 ops, so that every later word
    # straddles two steps (cut in its second step at stop_thr 320, the cut
    # carried into the next step at 0, 1 and 320); rows above the walk's
    # start left zero
    for head in ([30 | M, M], [0] + [M] * 30 + [1 | M], [M, 100 | M],
                 [5 | M], [0] * 50):
        c = np.full(T, M)
        c[:len(head)] = head
        cols.append(c[::-1].copy())
    for _ in range(10):
        n_ins = np.where(rng.random(T) < 0.2, rng.integers(0, 60, T), 0)
        cols.append(col(n_ins, rng.integers(0, 4, T)))
    return torch.from_numpy(np.stack(cols, 1).astype(np.int32))


def _lanes(rng, B):
    """(lane (5, B), curr (2, B)) int64: both orientations, chromosome and
    read ends near enough that the clamps fire."""
    rev = rng.integers(0, 2, B)
    clen = rng.integers(T // 2, 6000, B)
    qlen = rng.integers(T // 2, 6000, B)
    cstart = rng.integers(0, 1 << 30, B)
    qbuf = rng.integers(0, 1 << 20, B)
    pick = rng.integers(0, 4, B)
    # curr: anywhere, at the start, near the far end, at the far end
    cr = np.select([pick == 0, pick == 1, pick == 2],
                   [rng.integers(0, clen), np.zeros(B, np.int64),
                    np.maximum(clen - rng.integers(1, 500, B), 0)], clen)
    cq = np.select([pick == 0, pick == 1, pick == 2],
                   [rng.integers(0, qlen), np.zeros(B, np.int64),
                    np.maximum(qlen - rng.integers(1, 500, B), 0)], qlen)
    lane = np.stack([rev, cstart, clen, qbuf, qlen]).astype(np.int64)
    curr = np.stack([cr, cq]).astype(np.int64)
    return torch.from_numpy(lane), torch.from_numpy(curr)


def _darwin_tpu_next(rec, lane, curr, stop_thr):
    """_device_consumed itself, then the request arithmetic of
    _extend_round_spec_pallas (darwin_tpu/ops/dispatch.py:437-451) in its
    own int32 terms."""
    dr, dq = jdisp._device_consumed(jnp.asarray(rec.numpy()), None, None,
                                    stop_thr, MAX_OPS)
    rev = jnp.asarray(lane[0].numpy() != 0)
    cl32 = jnp.asarray(lane[2].numpy(), jnp.int32)
    q_len = jnp.asarray(lane[4].numpy(), jnp.int32)
    curr_ref = jnp.asarray(curr[0].numpy(), jnp.int32)
    curr_q = jnp.asarray(curr[1].numpy(), jnp.int32)
    TT = jnp.int32(T)
    curr_ref = jnp.where(rev, jnp.minimum(curr_ref + dr, cl32),
                         jnp.maximum(curr_ref - dr, 0))
    curr_q = jnp.where(rev, jnp.minimum(curr_q + dq, q_len),
                       jnp.maximum(curr_q - dq, 0))
    rsz2 = jnp.maximum(jnp.where(rev, jnp.minimum(cl32 - curr_ref, TT),
                                 jnp.minimum(curr_ref + 1, TT)), 1)
    qsz2 = jnp.maximum(jnp.where(rev, jnp.minimum(q_len - curr_q, TT),
                                 jnp.minimum(curr_q + 1, TT)), 1)
    r_rel2 = jnp.where(rev, curr_ref,
                       jnp.where(curr_ref >= TT, curr_ref - TT + 1, 0))
    q_rel2 = jnp.where(rev, curr_q,
                       jnp.where(curr_q >= TT, curr_q - TT + 1, 0))
    rs2 = lane[1].numpy() + np.asarray(r_rel2, np.int64)
    qs2 = lane[3].numpy() + np.asarray(q_rel2, np.int64)
    return np.stack([rs2, np.asarray(rsz2), qs2, np.asarray(qsz2),
                     np.asarray(curr_ref), np.asarray(curr_q),
                     np.asarray(dr), np.asarray(dq)]).astype(np.int64)


def _source_constants(source, *names):
    """``constexpr int NAME = <integer expression>;`` of a kernel source, so
    the transcription follows the kernel's own constants."""
    path = os.path.join(os.path.dirname(gact_cuda.__file__), "..", "csrc",
                        source)
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


(WARP, LANES_PER_BLOCK, THREADS, CHUNK_ROWS, PSTRIDE, STAGE,
 GATHER) = _source_constants("gact_next.cu", "WARP", "LANES_PER_BLOCK",
                             "THREADS", "CHUNK_ROWS", "PSTRIDE", "STAGE",
                             "GATHER")


def _stage(rec, b0, hi):
    """One block's patch of csrc/gact_next.cu: thread x's k-th load is
    element g = x + k * THREADS, walk row g / LANES_PER_BLOCK of lane g %
    LANES_PER_BLOCK (record column hi - row), stored lane-major at stride
    PSTRIDE; rows past the records and lanes past B hold 0."""
    RT, B = rec.shape
    rows = min(CHUNK_ROWS, hi + 1)
    nl = min(LANES_PER_BLOCK, B - b0)
    patch = np.zeros(LANES_PER_BLOCK * PSTRIDE, np.int64)
    g = np.arange(THREADS)[:, None] + np.arange(STAGE)[None, :] * THREADS
    r, ln = g // LANES_PER_BLOCK, g % LANES_PER_BLOCK
    ok = (r < rows) & (ln < nl)
    patch[ln * PSTRIDE + r] = np.where(
        ok, rec[np.clip(hi - r, 0, RT - 1), np.minimum(b0 + ln, B - 1)], 0)
    return patch


def _warp_advance(rec, stop_thr, max_ops):
    """csrc/gact_next.cu's walk, transcribed: (dr, dq) per lane.  A block
    stages its lanes' records CHUNK_ROWS rows at a time; a warp walks its
    lane WARP columns a step, one per thread; an inclusive scan of the
    columns' op counts places them in the stream; each word the step
    touches takes one ballot for its first cutting M; the carry (p, count,
    base, cut) is the warp's; each thread sums the taken part of its own
    column, and the warp adds the threads' sums at the end."""
    rec = np.asarray(rec).astype(np.int64)
    RT, B = rec.shape
    L = -(-max_ops // 32) * 32
    t = np.arange(WARP)
    out = np.zeros((2, B), np.int64)
    for b0 in range(0, B, LANES_PER_BLOCK):
        warps = range(min(LANES_PER_BLOCK, B - b0))
        carry = [[0, 0, 0, False] for _ in warps]    # p, count, base, cut
        dr = np.zeros((len(warps), WARP), np.int64)
        dq = np.zeros((len(warps), WARP), np.int64)
        for hi in range(RT - 1, -1, -CHUNK_ROWS):
            if all(c[0] >= L for c in carry):        # __syncthreads_and
                break
            patch = _stage(rec, b0, hi)
            rows = min(CHUNK_ROWS, hi + 1)
            for wi in warps:
                p, count, base, cut = carry[wi]
                for s0 in range(0, rows, WARP):
                    if p >= L:
                        break
                    w = patch[wi * PSTRIDE + s0 + t]
                    n_ins, closing = w & 0x3FFF, (w >> 14) & 3
                    cnt = n_ins + (closing != 0)
                    incl = np.cumsum(cnt)
                    total = int(incl[-1])
                    if total == 0:
                        continue
                    s = p + incl - cnt
                    cpos = s + n_ins
                    end = min(p + total, L)
                    for ws in range(p & ~31, end, 32):
                        if ws >= p:
                            base, cut = count, False
                        if cut:
                            continue
                        lo, hi_op = max(p, ws), min(ws + 32, end)
                        m = ((closing == gact.OP_M) & (cpos >= lo)
                             & (cpos < hi_op)
                             & (base + (cpos - ws) + 1 >= stop_thr))
                        bal = np.flatnonzero(m)
                        if bal.size:
                            hi_op = int(cpos[bal[0]]) + 1
                            cut = True
                        dq[wi] += np.maximum(np.minimum(s + n_ins, hi_op)
                                             - np.maximum(s, lo), 0)
                        inw = (closing != 0) & (cpos >= lo) & (cpos < hi_op)
                        dr[wi] += inw & (closing != gact.OP_I)
                        dq[wi] += inw & (closing != gact.OP_D)
                        count += hi_op - lo
                    p += total
                carry[wi] = [p, count, base, cut]
        out[:, b0:b0 + len(warps)] = dr.sum(1), dq.sum(1)
    return out


def _warp_next(rec, lane, curr, ref, query, stop_thr, max_ops):
    """The whole of csrc/gact_next.cu, transcribed: the advance, the next
    request (int64, both orientations, every clamp) and the gather — code
    j of a tile at index first + step * j clamped into its buffer, WARP *
    GATHER codes per pass.  Returns (req (8, B), qtile, rtile, sizes)."""
    dr, dq = _warp_advance(rec, stop_thr, max_ops)
    rev, cstart, clen, qbuf, qlen = np.asarray(lane)
    cr, cq = np.asarray(curr)
    cr = np.where(rev != 0, np.minimum(cr + dr, clen), np.maximum(cr - dr, 0))
    cq = np.where(rev != 0, np.minimum(cq + dq, qlen), np.maximum(cq - dq, 0))
    rsz = np.maximum(np.where(rev != 0, np.minimum(clen - cr, T),
                              np.minimum(cr + 1, T)), 1)
    qsz = np.maximum(np.where(rev != 0, np.minimum(qlen - cq, T),
                              np.minimum(cq + 1, T)), 1)
    rs = cstart + np.where(rev != 0, cr, np.where(cr >= T, cr - T + 1, 0))
    qs = qbuf + np.where(rev != 0, cq, np.where(cq >= T, cq - T + 1, 0))
    step = np.where(rev != 0, -1, 1)
    j = np.concatenate([j0 + np.arange(GATHER)[:, None] * WARP
                        + np.arange(WARP)[None, :]
                        for j0 in range(0, T, WARP * GATHER)], None)
    j = j[j < T]

    def gather(buf, start, size):
        first = np.where(rev != 0, start + size - 1, start)
        idx = np.clip(first[:, None] + step[:, None] * j[None, :], 0,
                      len(buf) - 1)
        tile = np.zeros((len(first), T), np.uint8)
        tile[:, j] = buf[idx]
        return tile
    req = np.stack([rs, rsz, qs, qsz, cr, cq, dr, dq]).astype(np.int64)
    sizes = np.stack([qsz, rsz, qsz - 1, rsz - 1]).astype(np.int32)
    return req, gather(query, qs, qsz), gather(ref, rs, rsz), sizes


@pytest.fixture(scope="module")
def records():
    rng = np.random.default_rng(11)
    return torch.cat([_walker_records(rng, 12), _synthetic_records(rng)], 1)


@pytest.mark.parametrize("stop_thr", [0, 1, 320, 384])
def test_spec_next_is_device_consumed_and_the_request_rule(records,
                                                           stop_thr):
    rng = np.random.default_rng(stop_thr)
    lane, curr = _lanes(rng, records.shape[1])
    got = gact.spec_next(records, lane, curr, T, stop_thr, MAX_OPS)
    want = _darwin_tpu_next(records, lane, curr, stop_thr)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[6:].numpy(),
                                  _warp_advance(records, stop_thr, MAX_OPS))
    # the cases are real: clamps at both ends, cut and uncut walks
    assert (got[1] < T).any() and (got[3] < T).any()
    assert (got[6] == 0).any() and (got[6] > T // 2).any()


@pytest.mark.parametrize("RT", [45, 1000])
def test_warp_walk_across_chunks(RT):
    """Records shorter than a step and longer than a staged chunk (three
    chunks at 1000 rows): the transcription, the twin and darwin_tpu's
    _device_consumed agree at every stop_thr class."""
    rng = np.random.default_rng(RT)
    B = 19
    # ~0.9 ops a column: the walks reach the last chunk before L
    n_ins = np.where(rng.random((RT, B)) < 0.02,
                     rng.integers(0, 10, (RT, B)), 0)
    n_ins[rng.integers(0, RT, 4), rng.integers(0, B, 4)] = 0x3FFF
    rec = (n_ins | rng.integers(0, 4, (RT, B)) << 14).astype(np.int32)
    rec[RT // 3:, :3] = 0                 # walks that start lower down
    rec = torch.from_numpy(rec)
    lane, curr = _lanes(rng, B)
    wants = []
    for stop_thr in (0, 1, RT - 64, 2 * RT):
        got = gact.spec_next(rec, lane, curr, T, stop_thr, 2 * RT)
        jdr, jdq = jdisp._device_consumed(jnp.asarray(rec.numpy()), None,
                                          None, stop_thr, 2 * RT)
        want = _warp_advance(rec, stop_thr, 2 * RT)
        np.testing.assert_array_equal(got[6:].numpy(), want)
        np.testing.assert_array_equal(np.stack([jdr, jdq]), want)
        wants.append(want)
    # words were cut, and uncut walks went past the first chunk
    assert (wants[0][1] < wants[-1][1]).any()
    assert RT < CHUNK_ROWS or (wants[-1].sum(0) > CHUNK_ROWS).any()


def _gather_case(rng, B, n_ref, n_q):
    """lane / curr rows whose requests land inside small code buffers,
    at both of their ends and past them, so that the gather's clamps fire."""
    lane, curr = _lanes(rng, B)
    lane[1] = torch.from_numpy(rng.integers(0, n_ref - 200, B))
    lane[3] = torch.from_numpy(rng.integers(0, n_q - 200, B))
    lane[1, :4] = torch.tensor([0, 0, n_ref - 1, n_ref + 50])
    lane[3, :4] = torch.tensor([0, n_q - 5, 0, n_q + 9])
    # a right extension on a chromosome shorter than a tile, at its start:
    # the reversed ref tile's indices run below 0
    lane[:3, 0] = torch.tensor([1, 0, 100])
    curr[0, 0] = 10
    ref = torch.from_numpy(rng.integers(0, 5, n_ref).astype(np.uint8))
    query = torch.from_numpy(rng.integers(0, 5, n_q).astype(np.uint8))
    return lane, curr, ref, query


@pytest.mark.parametrize("stop_thr", [0, 320])
def test_next_tiles_twin_gathers_spec_next_requests(records, stop_thr):
    """The wrapper's CPU twin: spec_next's requests, the tiles
    gather_tiles cuts for them (clamps included) and their sizes; the
    kernel's transcription gives every byte of the same."""
    rng = np.random.default_rng(100 + stop_thr)
    B = records.shape[1]
    lane, curr, ref, query = _gather_case(rng, B, 9000, 7000)
    before = dict(gact_cuda.LAUNCHES)
    req, qtile, rtile, sizes = gact_cuda.next_tiles(
        records, lane, curr, ref, query, T, stop_thr, MAX_OPS)
    assert gact_cuda.LAUNCHES == before          # the twin launches nothing
    want = gact.spec_next(records, lane, curr, T, stop_thr, MAX_OPS)
    assert torch.equal(req, want)
    wq, wr = dispatch.gather_tiles(ref, query, want[0], want[1], want[2],
                                   want[3], lane[0] != 0, T, T)
    assert torch.equal(qtile, wq) and torch.equal(rtile, wr)
    assert sizes.dtype == torch.int32 and torch.equal(
        sizes, torch.stack([want[3], want[1], want[3] - 1,
                            want[1] - 1]).int())
    k_req, k_q, k_r, k_sizes = _warp_next(records, lane, curr, ref.numpy(),
                                          query.numpy(), stop_thr, MAX_OPS)
    np.testing.assert_array_equal(k_req, req.numpy())
    np.testing.assert_array_equal(k_q, qtile.numpy())
    np.testing.assert_array_equal(k_r, rtile.numpy())
    np.testing.assert_array_equal(k_sizes, sizes.numpy())
    # the clamps fired: indices below 0 and past both buffers' ends
    rev = lane[0] != 0
    lo_r = torch.where(rev, req[0] + req[1] - T, req[0])
    hi_r = torch.where(rev, req[0] + req[1] - 1, req[0] + T - 1)
    hi_q = torch.where(rev, req[2] + req[3] - 1, req[2] + T - 1)
    assert (lo_r < 0).any() and (hi_r >= 9000).any() and (hi_q >= 7000).any()


def test_patch_is_free_of_bank_conflicts():
    """The staged patch's layout: each warp's staging store and each walk
    step's load touch 32 distinct shared-memory banks."""
    g = np.arange(THREADS * STAGE)
    addr = (g % LANES_PER_BLOCK) * PSTRIDE + g // LANES_PER_BLOCK
    for warp in addr.reshape(-1, WARP):
        assert len(set(warp % 32)) == WARP
    for wi in range(LANES_PER_BLOCK):
        for s0 in range(0, CHUNK_ROWS, WARP):
            reads = wi * PSTRIDE + s0 + np.arange(WARP)
            assert len(set(reads % 32)) == WARP
    assert len(set(addr)) == addr.size                # no two in one word
    assert addr.max() < LANES_PER_BLOCK * PSTRIDE


def test_next_tiles_checks_inputs_and_empty_batch(records, monkeypatch):
    rng = np.random.default_rng(3)
    lane, curr, ref, query = _gather_case(rng, records.shape[1], 900, 700)
    with pytest.raises(TypeError):
        gact_cuda.next_tiles(records, lane, curr, ref.int(), query, T, 0,
                             MAX_OPS)
    with pytest.raises(ValueError):
        gact_cuda.next_tiles(records, lane[:4], curr, ref, query, T, 0,
                             MAX_OPS)
    with pytest.raises(ValueError):
        gact_cuda.next_tiles(records, lane, curr, ref[::2], query, T, 0,
                             MAX_OPS)

    def never(*_, **__):
        raise AssertionError("an empty batch reached a kernel or a twin")
    from darwin_tpu_torch.ops import build
    monkeypatch.setattr(build, "load", never)
    monkeypatch.setattr(gact, "spec_next_tiles", never)
    req, q, r, sizes = gact_cuda.next_tiles(
        records[:, :0], lane[:, :0], curr[:, :0], ref, query, T, 0, MAX_OPS)
    assert (req.shape, q.shape, r.shape, sizes.shape) == (
        (8, 0), (0, T), (0, T), (4, 0))
    assert (req.dtype, q.dtype, sizes.dtype) == (torch.int64, torch.uint8,
                                                 torch.int32)


# ----------------------------------------------- (b) the speculative dispatch

@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("DARWIN_TPU_KERNEL", "pallas")
    monkeypatch.setenv("DARWIN_TPU_PALLAS_INTERPRET", "1")
    jdisp.use_pallas.cache_clear()
    yield monkeypatch
    jdisp.use_pallas.cache_clear()


def _chain_case():
    """A 12 kb chromosome and reads cut from it (both strands' worth of
    orientations), and 8 first-tile requests: left and right extensions
    from mid-read, from near a read's start and end, and at the
    chromosome's ends."""
    rng = np.random.default_rng(5)
    store = GenomeStore()
    store.add_chromosome("c", ACGT[rng.integers(0, 4, 12_000)])
    store.finalize()
    chrom = store.chromosomes[0]
    ref = encode5(store.bases_with_margin(4 * Config().large_tile_long))
    margin = np.full(4 * T, ord("N"), np.uint8)
    # (genome start, length) of each read, chromosome-relative
    spans = [(0, 2500), (3000, 3000), (9500, 2500), (6000, 2000)]
    parts, qbuf, qlen = [], [], []
    pos = 0
    for s, n in spans:
        seq = store.bases[chrom.start + s:chrom.start + s + n].copy()
        sub = rng.random(n) < 0.03
        seq[sub] = ACGT[rng.integers(0, 4, sub.sum())]
        parts += [seq, margin]
        qbuf.append(pos)
        qlen.append(n)
        pos += n + len(margin)
    query = encode5(np.concatenate(parts))
    # (read, chromosome-relative ref position, read position, right?)
    starts = [(0, 1200, 1200, False), (0, 300, 300, False),
              (1, 4500, 1500, True), (1, 3500, 500, False),
              (2, 11_800, 2300, True), (2, 10_000, 500, True),
              (3, 6100, 100, False), (3, 7500, 1500, True)]
    rows = []
    for i, cr, cq, right in starts:
        if right:
            rows.append((chrom.start + cr, min(chrom.length - cr, T),
                         qbuf[i] + cq, min(qlen[i] - cq, T), 1))
        else:
            rows.append((chrom.start + max(cr - T + 1, 0), min(cr + 1, T),
                         qbuf[i] + max(cq - T + 1, 0), min(cq + 1, T), 0))
        rows[-1] += (chrom.start, chrom.length, qbuf[i], qlen[i])
    cols = [np.array(c, np.int64) for c in zip(*rows)]
    return ref, query, cols


def test_spec_dispatch_matches_darwin_tpu(interpret):
    K = 3
    interpret.setattr(jdisp, "SPEC_K", K)
    ref, query, cols = _chain_case()
    kw = dict(qt=T, rt=T, max_tb=2 * T, stop_thr=T - Config().tile_overlap)
    want = jdisp.extend_tiles_spec_async(
        jnp.asarray(ref), jnp.asarray(query), *cols[:4],
        cols[4].astype(bool), *cols[5:], jgact.make_params(JConfig()), **kw)()
    got = dispatch.extend_tiles_async(
        torch.from_numpy(ref), torch.from_numpy(query), *cols,
        gact.make_params(Config()), K=K, **kw)()
    L = got["ops"].shape[1]
    assert L == 2 * T

    def same_ops(g_ops, g_n, w_ops, w_n, what):
        w_ops = np.asarray(w_ops)
        np.testing.assert_array_equal(g_n, np.asarray(w_n), err_msg=what)
        np.testing.assert_array_equal(g_ops, w_ops[:, :L], err_msg=what)
        assert not w_ops[:, L:].any()

    same_ops(got["ops"], got["n_ops"], want["ops"], want["n_ops"], "tile 1")
    for k in ("q_steps", "r_steps", "score", "query_max_pos",
              "ref_max_pos"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    assert len(got["spec_req"]) == K - 1
    for j in range(K - 1):
        ops, n = got["ops_spec"].take(j, np.arange(len(cols[0])))
        same_ops(ops, n, want["ops_spec"][j], want["n_ops_spec"][j],
                 f"level {j + 2}")
        for g, w in zip(got["spec_req"][j], want["spec_req"][j]):
            np.testing.assert_array_equal(g, np.asarray(w, np.int64))
        # a subset of the lanes expands to those lanes' rows
        lanes = [5, 0, 3]
        sub_ops, sub_n = got["ops_spec"].take(j, lanes)
        np.testing.assert_array_equal(sub_ops, ops[lanes])
        np.testing.assert_array_equal(sub_n, n[lanes])
    # the case is real: some lanes end at a sequence end, some go on
    assert (got["spec_req"][0][1] < T).any()
    assert (got["n_ops"] > 0).all()


def test_spec_dispatch_counts_every_computed_tile():
    """Every tile a chain computes comes back: tile 1 and each later level
    for all B lanes.  K = 1 takes a tile of any shape; K > 1 refuses a
    tile that is not square."""
    ref, query, cols = _chain_case()
    B = len(cols[0])
    ref, query = torch.from_numpy(ref), torch.from_numpy(query)
    params = gact.make_params(Config())
    kw = dict(max_tb=2 * T, stop_thr=256)
    got = dispatch.extend_tiles_async(ref, query, *cols, params, qt=T,
                                      rt=T, K=2, **kw)()
    assert got["ops"].shape[0] == len(got["n_ops"]) == B
    assert len(got["spec_req"]) == 1
    assert all(len(f) == B for f in got["spec_req"][0])
    ops, n_ops = got["ops_spec"].take(0, np.arange(B))
    assert ops.shape[0] == len(n_ops) == B
    got = dispatch.extend_tiles_async(ref, query, *cols, params, qt=T,
                                      rt=2 * T, K=1, **kw)()
    assert got["ops"].shape == (B, 3 * T) and got["spec_req"] == []
    assert (got["n_ops"] > 0).all()
    with pytest.raises(ValueError, match="square"):
        dispatch.extend_tiles_async(ref, query, *cols, params, qt=T,
                                    rt=2 * T, K=2, **kw)


def test_chain_of_one_is_level_one_of_a_chain():
    """K = 1 on square requests gives what level 1 of a K = 3 chain gives
    on the same requests: ops, n_ops and the five stats."""
    ref, query, cols = _chain_case()
    args = (torch.from_numpy(ref), torch.from_numpy(query), *cols,
            gact.make_params(Config()))
    kw = dict(qt=T, rt=T, max_tb=2 * T, stop_thr=T - Config().tile_overlap)
    one = dispatch.extend_tiles_async(*args, K=1, **kw)()
    three = dispatch.extend_tiles_async(*args, K=3, **kw)()
    for k in ("ops", "n_ops", "q_steps", "r_steps", "score",
              "query_max_pos", "ref_max_pos"):
        np.testing.assert_array_equal(one[k], three[k], err_msg=k)
    assert one["spec_req"] == [] and len(three["spec_req"]) == 2


# ------------------------------------------------------- (c) end to end

def _tiny_cfg(cls):
    """tests/test_spec_dispatch.py's small tiles: cheap in interpret mode
    and on the twins, and still many tiles per extension."""
    cfg = cls()
    cfg.tile_size = 64
    cfg.tile_overlap = 16
    cfg.first_tile_size = 32
    cfg.first_tile_score_threshold = 20
    return cfg


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """tests/test_spec_dispatch.py's tiny workload as files: a 20 kb genome
    and 3 mutated 800 bp reads, one reverse-complemented; and darwin_tpu's
    SAM and counter block for it."""
    tmp = tmp_path_factory.mktemp("torch_spec")
    rng = np.random.default_rng(0)
    genome = rng.choice(ACGT, size=20_000)
    with open(tmp / "ref.fa", "w") as f:
        f.write(">chr1\n" + genome.tobytes().decode() + "\n")
    with open(tmp / "reads.fa", "w") as f:
        for i in range(3):
            start = int(rng.integers(0, genome.size - 900))
            seq = mutate_read(rng, genome[start:start + 800], 0.03, 0.01,
                              0.01)
            if i == 2:
                seq = revcomp_bytes(seq)
            f.write(f">read{i}\n{seq.tobytes().decode()}\n")
    out, err = io.StringIO(), io.StringIO()
    jax_run(str(tmp / "ref.fa"), str(tmp / "reads.fa"), False,
            cfg=_tiny_cfg(JConfig), out=out, err=err)
    return tmp, out.getvalue(), _block(err.getvalue())


def _run_tiny(tmp, cfg=None, **kw):
    out, err = io.StringIO(), io.StringIO()
    counters = run(str(tmp / "ref.fa"), str(tmp / "reads.fa"), False,
                   cfg=cfg or _tiny_cfg(Config), out=out, err=err,
                   device="cpu", reads_per_batch=1, **kw)
    return out.getvalue(), err.getvalue(), counters


@pytest.mark.parametrize("spec_k,depth", list(itertools.product(
    [1, 4, 12], [1, 2])))
def test_run_matches_darwin_tpu(tiny, spec_k, depth):
    """Three read batches of one read, one or two in flight."""
    tmp, sam, block = tiny
    out, err, c = _run_tiny(tmp, spec_k=spec_k, pipeline_depth=depth)
    assert sum(1 for ln in sam.splitlines() if not ln.startswith("@")) >= 2
    assert int(block[4].split(":")[1]) > 20          # #extend tiles
    assert out == sam
    assert _block(err) == block
    hits, misses, rounds = _spec_line(err)
    assert (hits, misses, rounds) == (c["num_spec_hits"],
                                      c["num_spec_misses"],
                                      c["num_extend_rounds"])
    assert (hits > 0) == (spec_k > 1)


def test_spec_counters_match_darwin_tpu_speculation(tiny, interpret):
    """At K = 4 the port accepts and refuses the same speculative tiles in
    the same rounds as darwin_tpu's Pallas path (interpret mode)."""
    tmp, sam, block = tiny
    interpret.setattr(jdisp, "SPEC_K", 4)
    out, err = io.StringIO(), io.StringIO()
    jc = jax_run(str(tmp / "ref.fa"), str(tmp / "reads.fa"), False,
                 cfg=_tiny_cfg(JConfig), out=out, err=err,
                 reads_per_batch=1, pipeline_depth=1)
    assert out.getvalue() == sam
    got_out, got_err, c = _run_tiny(tmp, spec_k=4, pipeline_depth=2)
    assert got_out == sam
    want = (jc["num_spec_hits"], jc["num_spec_misses"],
            jc["num_extend_rounds"])
    assert want[0] > want[1] > 0
    assert _spec_line(got_err) == want


# ------------------------------------------------ (d) the stage telemetry

def test_stats_out(tiny):
    tmp, sam, block = tiny
    stats = {}
    out, err, c = _run_tiny(tmp, stats_out=stats, spec_k=1,
                            pipeline_depth=1)
    assert out == sam
    assert set(stats) == {"align_seconds", "index_seconds", "index_build",
                          "stage_seconds", "stage_seconds_cold",
                          "stage_seconds_warm", "counters", "compile_s"}
    assert stats["counters"] == c and stats["compile_s"] >= 0
    assert stats["index_seconds"] > 0
    build = stats["index_build"]
    assert (build["layout"], build["method"], build["batches"]) == (
        "pairs", "device", 1)
    total, cold = stats["stage_seconds"], stats["stage_seconds_cold"]
    assert {"read_upload", "seed", "filter", "extend", "print",
            "seed_chain", "extend_decode"} <= set(total)
    assert set(cold) == set(total) == set(stats["stage_seconds_warm"])
    for k, v in total.items():
        assert cold[k] + stats["stage_seconds_warm"][k] == \
            pytest.approx(v, abs=1e-9)
        assert 0 < cold[k] <= v
    assert 0 < stats["align_seconds"]


# ------------------------------------------------- (e) the index cache

def test_index_cache(tiny, monkeypatch, capsys):
    tmp, sam, block = tiny
    cache = tmp / "index.npz"
    k1 = dict(spec_k=1, pipeline_depth=1)

    def cached_run(path, cfg=None):
        out, err, _ = _run_tiny(tmp, cfg=cfg, index_cache=str(path), **k1)
        return out, err
    out, err = cached_run(cache)                        # builds, writes
    assert out == sam and f"Seed table saved to {cache}" in err
    stamp = cache.stat().st_mtime_ns
    out, err = cached_run(cache)                        # loads
    assert out == sam and "saved" not in err and "rebuild" not in err
    assert cache.stat().st_mtime_ns == stamp
    cfg = _tiny_cfg(Config)
    cfg.seed_size = 12                                  # stale: rebuilds
    out, err = cached_run(cache, cfg)
    assert "does not match the reference/config; rebuilding" in err
    assert f"Seed table saved to {cache}" in err

    # a cache darwin_tpu wrote is read as it is
    jcfg = _tiny_cfg(JConfig)
    g = np.frombuffer((tmp / "ref.fa").read_bytes().split(b"\n")[1],
                      np.uint8)
    jstore = JGenomeStore()
    jstore.add_chromosome("chr1", g)
    jstore.finalize()
    jst.build_seed_table(jstore, jcfg).save(str(tmp / "jindex.npz"))
    # through the CLI's flags: --index-cache loads it, --profile writes a
    # trace
    monkeypatch.chdir(tmp)
    (tmp / "params.cfg").write_text(
        "[GACT_extend]\ntile_size = 64\ntile_overlap = 16\n"
        "[GACT_first_tile]\nfirst_tile_size = 32\n"
        "first_tile_score_threshold = 20\n")
    try:
        assert cli.main(["ref.fa", "reads.fa", "0", "--device=cpu",
                         "--index-cache=jindex.npz", "--profile=prof"],
                        **k1) == 0
    finally:
        (tmp / "params.cfg").unlink()
    got = capsys.readouterr()
    assert got.out == sam
    assert "saved" not in got.err and "rebuild" not in got.err
    assert (tmp / "prof" / "trace.json").stat().st_size > 0


# --------------------------------------------- batches in flight take turns

def test_a_batch_gives_up_its_turn_only_while_it_waits():
    """utils.turns: batch A hands the host over while its fetch waits for
    the card, and goes on only when batch B gives the turn back (at its
    own wait, or when it ends); outside a turn, fetch is a plain copy."""
    from darwin_tpu_torch.utils.turns import HostTurns, fetch
    turns = HostTurns()
    waiting, done = threading.Event(), threading.Event()
    order = []

    class Slow:
        """A tensor whose device-to-host copy waits until B has run."""

        def cpu(self):
            waiting.set()
            assert done.wait(10)
            return torch.arange(3)

    def batch_a():
        with turns.turn():
            order.append("a starts")
            order.append(("a fetched", fetch(Slow()).tolist()))

    def batch_b():
        assert waiting.wait(10)
        with turns.turn():
            order.append("b runs")
            done.set()
            time.sleep(0.05)          # A's copy is done; A must wait
            order.append("b ends")

    threads = [threading.Thread(target=f) for f in (batch_a, batch_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
        assert not t.is_alive()
    assert order == ["a starts", "b runs", "b ends", ("a fetched", [0, 1, 2])]
    assert fetch(torch.arange(2)).tolist() == [0, 1]
