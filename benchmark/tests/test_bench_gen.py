"""The benchmark's generators: one seed gives the same bytes, two seeds
differ, and sizes and shares are what the configuration files state."""

import json
import os

import numpy as np
import pytest

from benchmark.gen import genomes, reads as greads

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def _small(spec, n):
    """``spec`` at ``n`` bases, without its N gaps."""
    small = dict(spec, chromosomes=[[spec["chromosomes"][0][0], n]])
    small.pop("gaps", None)
    return small


@pytest.mark.parametrize("name", ["ecoli_k12_pacbio", "chr21_ont"])
def test_genome_same_seed_same_bytes(name):
    spec = _small(_config(name)["genome"], 300_000)
    (a,), _ = genomes.make_genome(spec)
    (b,), _ = genomes.make_genome(spec)
    c, _ = genomes.make_genome(dict(spec, seed=spec["seed"] + 1))
    assert a[0] == b[0] and a[1].tobytes() == b[1].tobytes()
    assert len(a[1]) == 300_000
    assert a[1].tobytes() != c[0][1].tobytes()
    assert set(np.unique(a[1]).tobytes()) <= set(b"ACGT")


def test_repeat_genome_shares():
    spec = _small(_config("chr21_ont")["genome"], 2_000_000)
    _, stats = genomes.make_genome(spec)
    fr = spec["repeat_fracs"]
    n = 2_000_000
    for k in ("sine", "line", "tandem"):
        assert abs(stats[k] / n - fr[f"{k}_frac"]) < 0.03, (k, stats)
    assert abs(stats["repeat_frac"] - sum(fr.values())) < 0.03


@pytest.mark.parametrize("name", ["ecoli_k12_pacbio", "chr21_ont"])
def test_pool_same_seed_same_reads(name):
    cfg = _config(name)
    chroms, _ = genomes.make_genome(_small(cfg["genome"], 400_000))
    a = greads.make_pool(chroms, cfg["reads"], 99, 2**31 + 5)
    b = greads.make_pool(chroms, cfg["reads"], 99, 2**31 + 5)
    c = greads.make_pool(chroms, cfg["reads"], 99, 2**31 + 6)
    assert greads.fasta_bytes(a) == greads.fasta_bytes(b)
    assert greads.fasta_bytes(a) != greads.fasta_bytes(c)


@pytest.mark.parametrize("name", ["ecoli_k12_pacbio", "chr21_ont"])
def test_pool_profile_as_stated(name):
    cfg = _config(name)
    r = cfg["reads"]
    chroms, _ = genomes.make_genome(_small(cfg["genome"], 1_000_000))
    pool = greads.make_pool(chroms, r, 330, 7)
    sub, ins, dele = r["error"]
    mean = np.mean([len(s) for _, s in pool])
    # a read of L bases keeps L (1 - del) (1 + ins) on average
    expect = r["length"] * (1 - dele) * (1 + ins)
    assert abs(mean - expect) < 0.002 * expect
    minus = np.mean([n.endswith("-") for n, _ in pool])
    assert 0.4 < minus < 0.6                  # both strands


def test_chr21_gaps_as_stated():
    """N over the telomeres, the short arm and the scaffold gaps, at
    chr21's length; every read drawn from N-free sequence."""
    spec = _config("chr21_ont")["genome"]
    (name, n), = spec["chromosomes"]
    g = spec["gaps"]
    layout = genomes.gap_layout(spec["chromosomes"], g)
    arm = g["short_arms"][name]
    scaffolds = [p for p in range(g["scaffold_every"], n, g["scaffold_every"])
                 if p >= arm]
    assert sum(ln for *_, ln, _ in layout) == (
        arm + g["telomere"] + len(scaffolds) * g["scaffold_len"])
    small = dict(spec, chromosomes=[[name, 1_200_000]],
                 gaps=dict(g, short_arms={name: 300_000},
                           scaffold_every=400_000))
    (c,), stats = genomes.make_genome(small)
    isn = c[1] == ord("N")
    assert isn[:300_000].all() and isn[-g["telomere"]:].all()
    assert isn[400_000:400_100].all() and not isn[400_100]
    assert stats["n_bases"] == int(isn.sum()) == 300_000 + 10_000 + 200
    cfg = _config("chr21_ont")["reads"]
    pool = greads.make_pool([c], cfg, 200, 3)
    for nm, _ in pool:
        start = int(nm.split("_")[-2])
        assert not isn[start:start + cfg["length"]].any()


def test_same_loci_for_every_seed():
    """Every seed aligns the same loci; strands and errors differ."""
    cfg = _config("chr21_ont")
    chroms, _ = genomes.make_genome(_small(cfg["genome"], 400_000))
    a = greads.make_pool(chroms, cfg["reads"], 200, 1)
    b = greads.make_pool(chroms, cfg["reads"], 200, 2)
    loc = [n.rsplit("_", 1)[0] for n, _ in a]
    assert loc == [n.rsplit("_", 1)[0] for n, _ in b]
    assert [n for n, _ in a] != [n for n, _ in b]


def test_mutation_rates():
    rng = np.random.default_rng(3)
    src = [genomes.uniform_bases(rng, 20_000) for _ in range(50)]
    out = greads.mutate_many(np.random.default_rng(4), src, (0.0, 0.0, 0.1))
    kept = np.mean([len(o) / 20_000 for o in out])
    assert abs(kept - 0.9) < 0.005
    out = greads.mutate_many(np.random.default_rng(4), src, (0.0, 0.1, 0.0))
    grown = np.mean([len(o) / 20_000 for o in out])
    assert abs(grown - 1.1) < 0.005
    out = greads.mutate_many(np.random.default_rng(4), src, (0.1, 0.0, 0.0))
    diff = np.mean([np.mean(o != s) for o, s in zip(out, src)])
    assert abs(diff - 0.1) < 0.005
