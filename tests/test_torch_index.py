"""darwin_tpu_torch's minimizer scan and seed table against darwin_tpu's
(the host build is darwin_tpu's identity oracle); tables cross between
the packages through .npz files and from_numpy.  Exact equality."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from darwin_tpu.config import Config
from darwin_tpu.genome import GenomeStore
from darwin_tpu.index import minimizers as jmin
from darwin_tpu.index import seed_table as jst
from darwin_tpu_torch.index import minimizers, seed_table

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
    loaded = seed_table.SeedTable.load(path)
    meta = np.array([jt.kmer_size, jt.minimizer_window, jt.ref_size,
                     jt.kmer_max_occurence])
    carried = seed_table.SeedTable.from_numpy(
        np.asarray(jt.sorted_hashes), np.asarray(jt.positions), meta)
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
