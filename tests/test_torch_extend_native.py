"""The port's extension table (``native.ExtensionTable``, the tile state
machine in csrc/darwin_native.cpp) against darwin_tpu's ``_Ext``, driven
tile by tile with random op streams through ``_Ext.decode``: requests and
large-tile counts, every state field, the finish flags after every tile,
and each emitted alignment with its score.  Also the acceptance step of a
chain level against the loop the extension manager ran in Python (the
device's request differing in each one field), and
``reference_emission_order`` against darwin_tpu's slot-by-slot replay."""

import types

import numpy as np
import pytest

from darwin_tpu.config import Config as JConfig
from darwin_tpu.pipeline import extend as jext_mod
from darwin_tpu_torch import native
from darwin_tpu_torch.config import Config
from darwin_tpu_torch.pipeline.extend import reference_emission_order

# small tiles, so that extensions cross many of them in a short genome
TILES = dict(tile_size=32, tile_overlap=8, large_tile_long=80,
             large_tile_short=48)
ACGT = np.frombuffer(b"ACGT", np.uint8)
OPS = np.array([1, 2, 3], np.uint8)          # I, D, M


def _configs(do_overlap):
    cfgs = Config(), JConfig()
    for cfg in cfgs:
        for k, v in TILES.items():
            setattr(cfg, k, v)
        cfg.do_overlap = do_overlap
    return cfgs


def _world(rng):
    """Three chromosomes and five reads: the genome with its margin, the
    query buffer (each read's strands, each followed by 'N'), the
    chromosomes and each (read, strand)'s length and buffer offset."""
    lens = [400, 650, 520]
    seqs = [ACGT[rng.integers(0, 4, n)] for n in lens]
    margin = np.full(4 * TILES["large_tile_long"], ord("N"), np.uint8)
    bases = np.concatenate(seqs + [margin])
    starts = np.cumsum([0] + lens[:-1])
    chroms = [types.SimpleNamespace(start=int(s), length=n)
              for s, n in zip(starts, lens)]
    bufs, offsets, pos = [], {}, 0
    qmargin = np.full(4 * TILES["tile_size"], ord("N"), np.uint8)
    for r, n in enumerate([300, 470, 610, 90, 520]):
        seq = ACGT[rng.integers(0, 4, n)]
        for strand in "+-":
            bufs += [seq, qmargin]
            offsets[(r, strand)] = (pos, n)
            pos += n + len(qmargin)
    return bases, np.concatenate(bufs), chroms, offsets


def _hits(rng, x, q, left, n):
    """n chained hits (hit << 32 | offset) around (x, q), on the side the
    list serves (left ascending, right descending), the anchor among them
    on the right (as D-SOFT's chains hold it)."""
    sign = -1 if left else 1
    h = np.maximum(x + sign * rng.integers(0, 300, n), 0)
    o = np.maximum(q + sign * rng.integers(0, 300, n), 0)
    keys = (h.astype(np.uint64) << np.uint64(32)) | o.astype(np.uint64)
    if left:
        return np.sort(keys)
    return np.sort(np.append(keys, np.uint64((x << 32) | q)))[::-1]


def _extensions(rng, chroms, offsets, n):
    """n extensions: (loc, strand, chrom, q_len, q_code_start, zero_prob),
    a sixth of them at a chromosome's or read's last base with tiles of no
    ops (the left side ends where the right side cannot start: the rc path
    emits, the fw path drops), some near the start (the left bound), the
    rest anywhere; zero_prob is the chance of a tile with no ops."""
    out = []
    for i in range(n):
        chr_id = int(rng.integers(0, len(chroms)))
        chrom = chroms[chr_id]
        read = int(rng.integers(0, 5))
        strand = "+-"[(i // 6) % 2]
        qcs, q_len = offsets[(read, strand)]
        kind = i % 6
        r = int(rng.integers(0, chrom.length))
        q = int(rng.integers(0, q_len))
        zero = 0.3 if i % 3 == 0 else 0.04
        if kind == 0:
            r, zero = chrom.length - 1, 1.0
        elif kind == 1:
            q, zero = q_len - 1, 1.0
        elif kind == 2:
            r, q = int(rng.integers(0, 40)), int(rng.integers(0, 40))
        x = chrom.start + r
        nl = int(rng.integers(0, 6)) if kind != 5 else 0
        loc = types.SimpleNamespace(
            read_num=read, chr_id=chr_id, reference_pos=x, query_pos=q,
            left_hits=_hits(rng, x, q, True, nl),
            right_hits=_hits(rng, x, q, False, int(rng.integers(0, 6))))
        out.append((loc, strand, chrom, q_len, qcs, zero))
    return out


def _table(exts, bases, q_ascii, cfg):
    fields = np.array([(s == "-", c.start, c.length, ql, qcs,
                        loc.reference_pos - c.start, loc.query_pos)
                       for loc, s, c, ql, qcs, _ in exts], np.int64).T
    return native.ExtensionTable(fields, [e[0].left_hits for e in exts],
                                 [e[0].right_hits for e in exts], bases,
                                 q_ascii, cfg)


def _jstate(e, finished):
    st = {"curr_ref": e.curr_ref, "curr_q": e.curr_q,
          "ref_start_off": e.ref_start_off, "q_start_off": e.q_start_off,
          "ref_end_off": e.ref_end_off, "q_end_off": e.q_end_off,
          "left_done": e.left_done, "right_done": e.right_done,
          "used_large": e.used_large, "tiles": e.tiles,
          "left_hits": len(e.left_hits), "right_hits": len(e.right_hits),
          "finished": finished, "emitted": e.emitted is not None}
    if not finished or e.emitted is not None:
        st["columns"] = sum(len(c[0]) for c in e.left_chunks
                            + e.right_chunks)
    return st


def _check_state(table, jexts, done):
    st = table.state()
    for i, e in enumerate(jexts):
        want = _jstate(e, bool(done[i]))
        got = {k: int(st[k][i]) for k in want}
        assert got == {k: int(v) for k, v in want.items()}, i


def _drive(seed, do_overlap, with_next):
    """Drive every extension to its end in the table and in darwin_tpu's
    _Ext, one tile a step, checking after each; returns what the run
    covered."""
    rng = np.random.default_rng(seed)
    cfg, jcfg = _configs(do_overlap)
    T = cfg.tile_size
    bases, q_ascii, chroms, offsets = _world(rng)
    exts = _extensions(rng, chroms, offsets, 60)
    jexts = [jext_mod._Ext(loc, s, c, ql, qcs, 0)
             for loc, s, c, ql, qcs, _ in exts]
    jc = {"num_large_tiles": 0}
    hits = misses = large = 0
    emptied = set()
    n = len(exts)
    done = np.zeros(n, bool)
    cached = {}             # the Python loop's requests of refused lanes
    need_req = np.arange(n)    # lanes whose next tile needs a request
    going = np.arange(n)
    with _table(exts, bases, q_ascii, cfg) as table:
        for _ in range(2000):
            if not len(going):
                break
            # the requests of the lanes not accepted at the level before
            req, n_large = table.requests(need_req)
            large += n_large
            shapes = {}
            for k, i in enumerate(need_req):
                r = cached.pop(i, None) or jexts[i].request(jcfg, jc)
                qcs = exts[i][4]
                assert tuple(req[:, k]) == (r[0], r[1], qcs + r[2], r[3],
                                            int(r[4]), *r[5]), i
                shapes[i] = r[5]
            assert large == jc["num_large_tiles"]
            # one level: random ops for every going lane
            L = max(sum(shapes.get(i, (T, T))) for i in going)
            ops = np.zeros((len(going), L), np.uint8)
            n_ops = np.zeros(len(going), np.int32)
            for k, i in enumerate(going):
                rt, qt = shapes.get(i, (T, T))
                if rng.random() >= exts[i][5]:
                    n_ops[k] = rng.integers(1, rt + qt + 1)
                    ops[k, :n_ops[k]] = rng.choice(OPS, n_ops[k],
                                                   p=[0.15, 0.15, 0.7])
            had_left = {i: len(jexts[i].left_hits) for i in going}
            jdone = []
            for k, i in enumerate(going):
                qcs = exts[i][4]
                jdone.append(jexts[i].decode(
                    ops[k, :n_ops[k]], bases, q_ascii[qcs:], jcfg, jc, None))
            jdone = np.array(jdone, bool)
            # the device's next requests: the exact ones, but for a lane
            # in six one field off (or the direction flipped)
            B = len(going) + 3
            rows = rng.permutation(B)[:len(going)]
            nxt = rng.integers(0, 1 << 40, (4, B))
            rev = rng.integers(0, 2, B)
            accept = np.zeros(len(going), bool)
            jh = jm = 0
            if with_next:
                for k, i in enumerate(going):
                    if jdone[k]:
                        continue
                    r = jexts[i].request(jcfg, jc)
                    b = rows[k]
                    nxt[:, b] = (r[0], r[1], exts[i][4] + r[2], r[3])
                    rev[b] = int(r[4])
                    f = rng.integers(0, 6)
                    if f < 4:
                        nxt[f, b] += rng.choice([-1, 1])
                    elif f == 4:
                        rev[b] = 1 - rev[b]
                    if (r[5] == (T, T) and r[4] == rev[b]
                            and tuple(nxt[:, b]) == (r[0], r[1],
                                                     exts[i][4] + r[2],
                                                     r[3])):
                        jh += 1
                        accept[k] = True
                    else:
                        jm += 1
                        cached[i] = r
            status, h, m, n_large = table.decode_level(
                going, ops, n_ops, *((list(nxt), rows, rev) if with_next
                                     else ()))
            assert (h, m) == (jh, jm)
            hits, misses, large = hits + h, misses + m, large + n_large
            assert large == jc["num_large_tiles"]
            np.testing.assert_array_equal(status == 1, jdone)
            np.testing.assert_array_equal(status == 2, accept)
            done[going[jdone]] = True
            for i in going:
                if had_left[i] and not len(jexts[i].left_hits):
                    emptied.add(i)
            _check_state(table, jexts, done)
            need_req = going[~jdone & ~accept]
            going = going[~jdone]
        assert done.all()
        st = table.state()
        emitted = np.flatnonzero(st["emitted"])
        ref, q, offs, scores = table.emit(emitted, st["columns"][emitted])
    for k, i in enumerate(emitted):
        a = jexts[i].emitted
        assert ref[offs[k]:offs[k + 1]].tobytes() == a.aligned_reference
        assert q[offs[k]:offs[k + 1]].tobytes() == a.aligned_query
        assert scores[k] == a.score
    assert [i for i, e in enumerate(jexts) if e.emitted is not None] \
        == emitted.tolist()
    return {
        "large": jc["num_large_tiles"], "hits": hits, "misses": misses,
        "emptied": len(emptied),
        "rc_left_emit": sum(e.emitted is not None and not e.right_chunks
                            for e in jexts),
        "fw_drop": sum(e.emitted is None for e in jexts),
        "left_bound": sum(e.ref_start_off == 0 or e.q_start_off == 0
                          for e in jexts),
        "right_end": sum(e.emitted is not None
                         and (e.ref_end_off == e.ref_len - 1
                              or e.q_end_off == e.q_len - 1)
                         for e in jexts),
        "no_ops": sum(loc_zero == 1.0 for *_, loc_zero in exts),
        "strands": {s for _, s, *_ in exts},
    }


@pytest.mark.parametrize("with_next", [False, True])
@pytest.mark.parametrize("do_overlap", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_matches_darwin_tpu_ext_tile_by_tile(seed, do_overlap,
                                                   with_next):
    """Sixty extensions on both strands, a sixth starting at a
    chromosome's or read's last base with tiles of no ops, through random
    op streams to their ends: the table's requests (and large-tile
    counts), every field, the finish flags and, with ``with_next``, the
    acceptance against the device's next requests equal darwin_tpu's
    _Ext and the extension manager's Python loop after every tile; the
    emitted rows and scores are _Ext's; and the run reached every branch:
    large tiles, hit lists popped to empty, the left bound, the right end,
    the rc path's emit on the left and the fw path's drop."""
    got = _drive(seed, do_overlap, with_next)
    assert got["large"] > 0
    assert got["emptied"] > 0
    assert got["rc_left_emit"] > 0 and got["fw_drop"] > 0
    assert got["left_bound"] > 0 and got["right_end"] > 0
    assert got["strands"] == {"+", "-"}
    if with_next:
        assert got["hits"] > 0 and got["misses"] > 0


def test_table_refuses_what_it_cannot_decode():
    """Out-of-range extensions and rows, an op count past its row and a
    large tile with no hit left raise; an empty batch of lanes is a
    no-op."""
    rng = np.random.default_rng(5)
    cfg, _ = _configs(False)
    bases, q_ascii, chroms, offsets = _world(rng)
    exts = _extensions(rng, chroms, offsets, 4)
    with _table(exts, bases, q_ascii, cfg) as table:
        with pytest.raises(IndexError):
            table.requests([4])
        ops = np.zeros((1, 8), np.uint8)
        with pytest.raises(ValueError):
            table.decode_level([0], ops, [9])
        with pytest.raises(IndexError):
            table.decode_level([0], ops, [1], [np.zeros(2, np.int64)] * 4,
                               [2], np.zeros(2, np.int64))
        assert table.requests([])[0].shape == (7, 0)
        st, h, m, n_large = table.decode_level([], np.zeros((0, 8), np.uint8),
                                               [])
        assert len(st) == 0 and (h, m, n_large) == (0, 0, 0)
    # the left side ends through a large tile with its hit kept, and the
    # right side has no hit to size its large tile by: darwin_tpu's _Ext
    # raises there too
    chrom = chroms[0]
    loc = types.SimpleNamespace(
        read_num=0, chr_id=0, reference_pos=chrom.start + 100, query_pos=100,
        left_hits=np.array([(chrom.start + 50) << 32 | 50], np.uint64),
        right_hits=np.zeros(0, np.uint64))
    qcs, q_len = offsets[(0, "-")]
    _, jcfg = _configs(False)
    jx = jext_mod._Ext(loc, "-", chrom, q_len, qcs, 0)
    with _table([(loc, "-", chrom, q_len, qcs, 1.0)], bases, q_ascii,
                cfg) as table:
        for flag in ("used_large", "left_done"):
            st, *_ = table.decode_level([0], np.zeros((1, 8), np.uint8),
                                        [0])
            assert st[0] == 0 and table.state()[flag][0] == 1
            assert not jx.decode(np.zeros(0, np.uint8), bases,
                                 q_ascii[qcs:], jcfg, {}, None)
        with pytest.raises(IndexError):
            table.requests([0])
        with pytest.raises(IndexError):
            jx.request(jcfg, {"num_large_tiles": 0})


@pytest.mark.parametrize("batch_size", [1, 2, 3, 7])
def test_emission_order_matches_darwin_tpu_replay(batch_size):
    """The per-extension replay gives darwin_tpu's slot-by-slot order and
    num_extend_tiles / num_active_tiles on random tile counts (ties of
    completion included), and refuses an extension of no tiles."""
    rng = np.random.default_rng(batch_size)
    for n in [0, 1, 2, 3, 5, 8, 40, 200]:
        for hi in (2, 6, 300):
            counts = rng.integers(1, hi, n).tolist()
            got_c = {"num_extend_tiles": 0, "num_active_tiles": 0}
            want_c = dict(got_c)
            assert reference_emission_order(counts, batch_size, got_c) == \
                jext_mod.reference_emission_order(counts, batch_size, want_c)
            assert got_c == want_c
    with pytest.raises(ValueError):
        reference_emission_order([3, 0, 2], batch_size)
