"""darwin_tpu_torch's minimizer scan and seed table against darwin_tpu's
(the host build is darwin_tpu's identity oracle): the work-list scan
against ``scan_many_minimizers`` and every build method and layout against
darwin_tpu's, with rows and row batches patched small in both packages so
that sequences straddle rows and batches; the repeat genome both packages
make; the streaming build's retry and its sort in hash-range pieces; the
out-of-memory fallback.  Tables cross between the packages through .npz
files and from_numpy.  Exact equality (integer arrays, tolerance 0)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from darwin_tpu.config import Config
from darwin_tpu.genome import GenomeStore
from darwin_tpu.index import minimizers as jmin
from darwin_tpu.index import seed_table as jst
from darwin_tpu.utils import synthgenome as jsynthgenome
from darwin_tpu_torch.genome import GenomeStore as PortStore
from darwin_tpu_torch.index import minimizers, seed_table
from darwin_tpu_torch.utils import synthgenome

torch.set_num_threads(2)


def _store(rng):
    acgt = np.frombuffer(b"ACGT", np.uint8)
    store = GenomeStore()
    a = acgt[rng.integers(0, 4, 23_457)]
    a[4000:4300] = ord("N")                 # an N run inside a chromosome
    store.add_chromosome("chrA", a)
    store.add_chromosome("chrB", acgt[rng.integers(0, 4, 9_001)])
    store.add_chromosome("chrC", acgt[rng.integers(0, 4, 333)])
    return store.finalize()


@pytest.mark.parametrize("k,w", [(10, 3), (14, 5)])
def test_build_matches_darwin_tpu_host_build(k, w):
    rng = np.random.default_rng(k)
    store = _store(rng)
    cfg = Config()
    cfg.seed_size, cfg.minimizer_window = k, w
    want = jst.build_seed_table(store, cfg, method="host")
    got = seed_table.build_seed_table(store, cfg, "cpu")
    np.testing.assert_array_equal(got.sorted_hashes.numpy(),
                                  np.asarray(want.sorted_hashes))
    np.testing.assert_array_equal(got.positions.numpy(),
                                  np.asarray(want.positions))
    assert (got.kmer_size, got.minimizer_window, got.ref_size,
            got.kmer_max_occurence) == (
        want.kmer_size, want.minimizer_window, want.ref_size,
        want.kmer_max_occurence)
    h = np.asarray(want.sorted_hashes)
    for probe in list(h[::97][:20]) + [0, 12345, (1 << 2 * k) - 1]:
        assert got.is_present(int(probe)) == want.is_present(int(probe))


def test_minimizer_scan_matches_darwin_tpu():
    rng = np.random.default_rng(1)
    B, L = 6, 512
    codes2 = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lengths = rng.integers(40, L + 1, B).astype(np.int32)
    for b in range(B):
        codes2[b, lengths[b]:] = 0
    for k, w in ((14, 3), (12, 7)):
        m, e = minimizers.minimizer_scan(torch.from_numpy(codes2),
                                         torch.from_numpy(lengths), k, w)
        jm, je = jmin.minimizer_scan(jnp.asarray(codes2),
                                     jnp.asarray(lengths), k, w)
        np.testing.assert_array_equal(e.numpy(), np.asarray(je))
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


def test_tables_cross_between_packages(tmp_path):
    """A darwin_tpu-saved .npz and from_numpy of darwin_tpu's arrays both
    load into the port; the port's save() loads back into darwin_tpu."""
    store = _store(np.random.default_rng(3))
    cfg = Config()
    cfg.seed_size = 12
    jt = jst.build_seed_table(store, cfg, method="host")
    path = str(tmp_path / "index.npz")
    jt.save(path)
    loaded = seed_table.SeedTable.load(path, "cpu")
    meta = np.array([jt.kmer_size, jt.minimizer_window, jt.ref_size,
                     jt.kmer_max_occurence])
    carried = seed_table.SeedTable.from_numpy(
        np.asarray(jt.sorted_hashes), np.asarray(jt.positions), meta, "cpu")
    built = seed_table.build_seed_table(store, cfg, "cpu")
    for t in (loaded, carried):
        assert torch.equal(t.sorted_hashes, built.sorted_hashes)
        assert torch.equal(t.positions, built.positions)
        assert t.kmer_max_occurence == built.kmer_max_occurence
    back = str(tmp_path / "port.npz")
    built.save(back)
    jt2 = jst.SeedTable.load(back)
    np.testing.assert_array_equal(np.asarray(jt2.sorted_hashes),
                                  np.asarray(jt.sorted_hashes))
    np.testing.assert_array_equal(np.asarray(jt2.positions),
                                  np.asarray(jt.positions))
    assert jt2.ref_size == jt.ref_size


def _call_without_device(name, tmp_path):
    store = _store(np.random.default_rng(5))
    cfg = Config()
    cfg.seed_size = 12
    if name == "build_seed_table":
        return seed_table.build_seed_table, (store, cfg)
    if name == "build_read_seed_table":
        from darwin_tpu_torch.genome import reads_from_numpy
        acgt = np.frombuffer(b"ACGT", np.uint8)
        rng = np.random.default_rng(6)
        reads = reads_from_numpy(
            ["r0", "r1"], [acgt[rng.integers(0, 4, 700)] for _ in range(2)])
        return seed_table.build_read_seed_table, (reads, cfg)
    built = seed_table.build_seed_table(store, cfg, "cpu")
    if name == "from_numpy":
        meta = [built.kmer_size, built.minimizer_window, built.ref_size,
                built.kmer_max_occurence]
        return seed_table.SeedTable.from_numpy, (
            built.sorted_hashes.numpy(), built.positions.numpy(), meta)
    path = str(tmp_path / "t.npz")
    built.save(path)
    return seed_table.SeedTable.load, (path,)


@pytest.mark.parametrize("name", ["from_numpy", "load", "build_seed_table",
                                  "build_read_seed_table"])
def test_index_entry_points_default_to_the_card(name, tmp_path):
    """Each entry point runs on the card unless asked for the CPU: the
    default is ``cuda``, a host without a card raises, and ``device="cpu"``
    gives the table a direct CPU build gives."""
    import inspect
    fn, args = _call_without_device(name, tmp_path)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            fn(*args)
    got = fn(*args, device="cpu")
    table = got[0] if isinstance(got, tuple) else got
    assert table.positions.device.type == "cpu"
    assert table.sorted_hashes.device.type == "cpu"
    assert table.num_seeds > 0
    assert bool((table.sorted_hashes[1:] >= table.sorted_hashes[:-1]).all())
    if name in ("from_numpy", "load"):
        store = _store(np.random.default_rng(5))
        cfg = Config()
        cfg.seed_size = 12
        built = seed_table.build_seed_table(store, cfg, "cpu")
        assert torch.equal(table.positions, built.positions)
        assert torch.equal(table.sorted_hashes, built.sorted_hashes)


# ------------------------------------------------ the work-list scan

@pytest.fixture
def small_batches(monkeypatch):
    """Rows of 256 new positions, 3 rows a batch, in both packages."""
    monkeypatch.setattr(jmin, "CHUNK", 256)
    monkeypatch.setattr(jmin, "CROWS", 3)
    monkeypatch.setattr(minimizers, "CHUNK", 256)
    monkeypatch.setattr(minimizers, "ROWS", 3)


def _scan_many(seqs, k, w):
    """scan_many_minimizers' counterpart on the work-list scan: seqs are
    (codes2, length_unpadded) numpy pairs laid out in one buffer; one
    (local positions int64, hashes uint32) pair per sequence."""
    lengths = [n for _, n in seqs]
    room = [max((n + 15) // 16 * 16, len(c)) for c, n in seqs]
    starts = np.concatenate([[0], np.cumsum(room)[:-1]]).astype(np.int64)
    buf = np.zeros(int(sum(room)), np.uint8)
    for (c, _), s in zip(seqs, starts):
        buf[s:s + len(c)] = c
    seq_of_row = minimizers.work_list(lengths, k)[0]
    out_p = [[np.zeros(0, np.int64)] for _ in seqs]
    out_h = [[np.zeros(0, np.uint32)] for _ in seqs]
    for m, emit, pos, (r0, _) in minimizers.scan_batches(
            torch.from_numpy(buf), starts, lengths, k, w):
        m, emit, pos = m.numpy(), emit.numpy(), pos.numpy()
        for i in range(emit.shape[0]):
            si = seq_of_row[r0 + i]
            out_p[si].append(pos[i][emit[i]] - starts[si])
            out_h[si].append(m[i][emit[i]].astype(np.uint32))
    return [(np.concatenate(p), np.concatenate(h))
            for p, h in zip(out_p, out_h)]


@pytest.mark.parametrize("k,w", [(8, 3), (10, 5), (14, 3)])
def test_work_list_scan_matches_scan_many_minimizers(k, w, small_batches):
    """Reads shorter than k + w (and empty), 1-3 kb reads and a 40 kb
    sequence in one work list: anchors chain through rows and batches,
    a new sequence resets them, every sequence starts at last_m = 0."""
    rng = np.random.default_rng(k * w)
    lens = [0, 1, 5, k + w - 1, k + w, 17, 1000, 2100, 3000, 40_000, 9,
            1500, 2999]
    seqs = [(rng.integers(0, 4, n).astype(np.uint8), n) for n in lens]
    # a run of equal bases: the window minimum holds, so emission comes
    # from the w-step rule alone across row seams
    seqs[9][0][5000:9000] = 2
    want = jmin.scan_many_minimizers(seqs, k, w)
    got = _scan_many(seqs, k, w)
    assert len(minimizers.work_list(lens, k)[0]) > 3 * 20   # many batches
    for (wp, wh), (gp, gh) in zip(want, got):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gh, wh)
    assert sum(len(p) for p, _ in got) > 10_000


# ------------------------------------------------ builds on a repeat genome

def test_repeat_genome_copy_is_byte_equal():
    for seed in (0, 5):
        a, sa = jsynthgenome.repeat_genome(np.random.default_rng(seed),
                                           150_000)
        b, sb = synthgenome.repeat_genome(np.random.default_rng(seed),
                                          150_000)
        assert a.tobytes() == b.tobytes() and sa == sb
    rng = np.random.default_rng(1)
    x = synthgenome._random_bases(rng, 500)
    y = jsynthgenome.diverge(np.random.default_rng(2), x, 0.1)
    assert synthgenome.diverge(np.random.default_rng(2), x, 0.1
                               ).tobytes() == y.tobytes()


@pytest.fixture(scope="module")
def repeat_stores():
    """The same three chromosomes in both packages' stores: a repeat
    genome, random bases with an N run, and a short one."""
    rng = np.random.default_rng(9)
    bases, stats = synthgenome.repeat_genome(rng, 60_000)
    assert stats["repeat_frac"] > 0.2
    acgt = np.frombuffer(b"ACGT", np.uint8)
    other = acgt[rng.integers(0, 4, 9_000)]
    other[2000:2300] = ord("N")
    chroms = [("rep", bases), ("rnd", other), ("tiny", acgt[:7])]
    jstore = GenomeStore()
    for name, seq in chroms:
        jstore.add_chromosome(name, seq)
    jstore.finalize()
    store = PortStore.from_numpy([n for n, _ in chroms],
                                 [s for _, s in chroms])
    return jstore, store


def _cfg(k):
    cfg = Config()
    cfg.seed_size = k
    return cfg


def _same_table(got, want):
    """A port table equals a darwin_tpu table of the same layout."""
    assert got.layout == ("csr" if want.bucket_offsets is not None
                          else "pairs")
    if want.bucket_offsets is not None:
        assert got.sorted_hashes is None
        np.testing.assert_array_equal(got.bucket_offsets.numpy(),
                                      np.asarray(want.bucket_offsets))
    else:
        np.testing.assert_array_equal(
            got.sorted_hashes.numpy().view(np.uint32),
            np.asarray(want.sorted_hashes))
    np.testing.assert_array_equal(got.positions.numpy().view(np.uint32),
                                  np.asarray(want.positions))
    assert (got.kmer_size, got.minimizer_window, got.ref_size,
            got.kmer_max_occurence) == (
        want.kmer_size, want.minimizer_window, want.ref_size,
        want.kmer_max_occurence)


@pytest.mark.parametrize("k", [8, 10])
@pytest.mark.parametrize("layout,method", [
    ("pairs", None), ("pairs", "device"), ("pairs", "stream"),
    ("pairs", "host"), ("csr", None)])
def test_build_matches_darwin_tpu(repeat_stores, small_batches, k, layout,
                                  method):
    jstore, store = repeat_stores
    want = jst.build_seed_table(jstore, _cfg(k), method=method,
                                layout=layout)
    got = seed_table.build_seed_table(store, _cfg(k), "cpu", method=method,
                                      layout=layout)
    _same_table(got, want)
    stats = got.build_stats
    assert stats["layout"] == layout
    assert stats["method"] == method or (layout, method) in (
        ("pairs", None), ("csr", None))
    hashes = np.unique(np.asarray(jst.build_seed_table(
        jstore, _cfg(k), method="host").sorted_hashes))
    for probe in [0, 1, 77, (1 << 2 * k) - 1] + hashes[::37].tolist():
        assert got.is_present(probe) == want.is_present(probe)
    # the repeat genome fills some buckets past the occupancy cap
    assert not all(got.is_present(int(h)) for h in hashes)


def test_streaming_build_retries_and_sorts_in_pieces(repeat_stores,
                                                     small_batches,
                                                     monkeypatch):
    """A capacity too small for the seeds is retried, nothing lost; a sort
    in hash-range pieces gives the one sort's table."""
    jstore, store = repeat_stores
    want = jst.build_seed_table(jstore, _cfg(8), method="host")
    real = minimizers.sorted_pairs_streaming
    caps = []

    def tight(codes, starts, lengths, k, w, cap, stats=None):
        caps.append(cap)
        return real(codes, starts, lengths, k, w,
                    100 if len(caps) == 1 else cap, stats)

    monkeypatch.setattr(minimizers, "sorted_pairs_streaming", tight)
    monkeypatch.setattr(minimizers, "SORT_PIECE", 1000)
    got = seed_table.build_seed_table(store, _cfg(8), "cpu",
                                      method="stream")
    _same_table(got, want)
    assert len(caps) == 2 and got.build_stats["retries"] == 1
    assert got.num_seeds > 16 * 1000            # 32 pieces


def test_out_of_memory_falls_back_to_the_host_build(repeat_stores,
                                                    monkeypatch, capsys):
    """A device pairs build that runs out of memory gives the host build's
    table and says so on stderr; any other error propagates."""
    jstore, store = repeat_stores
    want = jst.build_seed_table(jstore, _cfg(10), method="host")

    def oom(*a, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory.")

    monkeypatch.setattr(minimizers, "sorted_pairs_device", oom)
    monkeypatch.setattr(minimizers, "sorted_pairs_streaming", oom)
    for method in (None, "device", "stream"):
        got = seed_table.build_seed_table(store, _cfg(10), "cpu",
                                          method=method)
        _same_table(got, want)
        assert got.build_stats["method"] == "host"
        assert got.build_stats["fallback"] in ("device", "stream")
        err = capsys.readouterr().err
        assert err == (
            "[darwin_tpu_torch] device seed-table build exhausted HBM; "
            "falling back to the host build (identical output).  Consider "
            "--index-layout csr for genomes this large.\n")

    def other(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(minimizers, "sorted_pairs_device", other)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        seed_table.build_seed_table(store, _cfg(10), "cpu", method="device")
    assert capsys.readouterr().err == ""


def test_csr_and_method_validation(repeat_stores):
    """darwin_tpu's refusals: csr has one build and needs k <= 14."""
    _, store = repeat_stores
    with pytest.raises(ValueError, match="single"):
        seed_table.build_seed_table(store, _cfg(8), "cpu", method="stream",
                                    layout="csr")
    with pytest.raises(ValueError, match="seed_size <= 14"):
        seed_table.build_seed_table(store, _cfg(15), "cpu", layout="csr")
    with pytest.raises(ValueError, match="unknown index layout"):
        seed_table.build_seed_table(store, _cfg(8), "cpu", layout="bogus")
