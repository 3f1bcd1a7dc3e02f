"""darwin_tpu's default extension path in darwin_tpu_torch, against
darwin_tpu on the CPU: the next-tile rule of the speculative chains
(``gact.spec_next``, the twin of the ``gact_next`` kernel), the K-tile
speculative dispatch, ``run()`` at every tested chain depth and number of
read batches in flight, its stage telemetry and ``--index-cache``.
Tolerance: none — integers are equal, SAM bytes and the counter block
identical.

darwin_tpu's speculative dispatch runs as its own tests run it on the CPU
(tests/test_spec_dispatch.py): its Pallas kernels in interpret mode
(``DARWIN_TPU_KERNEL=pallas``, ``DARWIN_TPU_PALLAS_INTERPRET=1``); its
``run()`` otherwise takes its lax path, which has no speculation."""

import io
import itertools
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
from darwin_tpu_torch.ops import dispatch, gact
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
    ln = next(x for x in err.splitlines() if "#spec hits" in x).split()
    return int(ln[3]), int(ln[6]), int(ln[-1])


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


def _kernel_advance(rec, stop_thr):
    """csrc/gact_next.cu's per-lane loop, transcribed: (dr, dq) per lane."""
    rec = rec.numpy()
    RT, B = rec.shape
    L = -(-MAX_OPS // 32) * 32
    out = []
    for b in range(B):
        p = count = base = dr = dq = 0
        cut = False
        for c in range(RT - 1, -1, -1):
            if p >= L:
                break
            w = int(rec[c, b])
            n_ins, closing = w & 0x3FFF, (w >> 14) & 3
            while n_ins > 0 and p < L:
                if p % 32 == 0:
                    base, cut = count, False
                seg = min(n_ins, 32 - p % 32, L - p)
                if not cut:
                    dq += seg
                    count += seg
                p += seg
                n_ins -= seg
            if closing and p < L:
                if p % 32 == 0:
                    base, cut = count, False
                if not cut:
                    dr += closing != gact.OP_I
                    dq += closing != gact.OP_D
                    count += 1
                    cut = closing == gact.OP_M and base + p % 32 + 1 \
                        >= stop_thr
                p += 1
        out.append((dr, dq))
    return np.array(out, np.int64).T


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
                                  _kernel_advance(records, stop_thr))
    # the cases are real: clamps at both ends, cut and uncut walks
    assert (got[1] < T).any() and (got[3] < T).any()
    assert (got[6] == 0).any() and (got[6] > T // 2).any()


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
    got = dispatch.extend_tiles_spec_async(
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
    ref, query, cols = _chain_case()
    dispatch.reset_ext_stats()
    dispatch.extend_tiles_spec_async(
        torch.from_numpy(ref), torch.from_numpy(query), *cols,
        gact.make_params(Config()), qt=T, rt=T, max_tb=2 * T, stop_thr=256,
        K=2)()
    B = len(cols[0])
    assert dispatch.EXT_STATS == {"dispatches": 1, "tiles": 2 * B,
                                  "spec_tiles": B, "cells": 2 * B * T * T,
                                  "device_ms": 0.0}
    with pytest.raises(ValueError, match="square"):
        dispatch.extend_tiles_spec_async(
            torch.from_numpy(ref), torch.from_numpy(query), *cols,
            gact.make_params(Config()), qt=T, rt=2 * T, max_tb=2 * T,
            stop_thr=256)


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
    assert set(stats) == {"align_seconds", "stage_seconds",
                          "stage_seconds_cold", "stage_seconds_warm",
                          "counters", "compile_s"}
    assert stats["counters"] == c and stats["compile_s"] >= 0
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
