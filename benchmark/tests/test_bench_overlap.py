"""The overlap cell: its files and entries are found by name, its two new
readers read hand-made contexts (and nothing where the run recorded no
such span or counter), and a tiny overlap cell runs through the harness
on the CPU, traced, correct and with the new metrics read."""

import pytest

from benchmark import harness, overlap
from benchmark.tests import tiny
from benchmark.tests.conftest import ROOT

CELL = "ecoli_k12_pacbio.overlap"
NEW = ["device.idle.overlap", "gact_dp_roofline.overlap",
       "extend.decode_ms_per_read.overlap",
       "print.format_ms_per_read.overlap",
       "extend.dropped_column_share.overlap"]
# the map cell's layer metrics, each with an overlap twin on its reader
TWINS = ["seed.host_ms_per_read", "seed.self_ms_per_read",
         "filter.host_ms_per_read", "filter.self_ms_per_read",
         "print.host_ms_per_read", "host.turn_wait_ms_per_read",
         "extend.spec_hit_rate"]


def test_cell_files_and_entries_are_found():
    spec = harness.load_spec(ROOT)
    wl, traffic, config = harness.load_cell(spec, CELL)
    assert (wl["config"], wl["chips"]) == ("ecoli_k12_pacbio_denovo", 1)
    assert config["name"] == "ecoli_k12_pacbio_denovo"
    assert traffic["mode"] == "overlap"
    # 10x of MG1655's 4,641,652 bp in 10 kbp reads, each a query once a pass
    assert traffic["read_set"] == round(10 * 4641652 / 10000) == 4642
    assert (traffic["pool_reads"], traffic["trace_reads"],
            traffic["sample_reads"]) == (4642, 1536, 8)
    twins = [t + ".overlap" for t in TWINS]
    assert [m["name"] for m in harness.cell_metrics(spec, CELL, True)] == (
        ["index.build_s"] + NEW + twins)
    assert [m["name"] for m in harness.cell_metrics(spec, CELL, False)] == [
        "map_reads_per_s", "setup_s"]
    for m in harness.cell_metrics(spec, CELL, True):
        assert m["moves"] == ("setup_s" if m["name"] == "index.build_s"
                              else "map_reads_per_s")
        assert callable(harness.reader(m["name"]))
    # the map cell reports none of them
    map_names = {m["name"] for m in harness.cell_metrics(
        spec, "ecoli_k12_pacbio.map", True)}
    assert not map_names & set(NEW + twins)
    # each twin is its map metric with the overlap cell's name: same
    # reader, unit and layer
    entry = {m["name"]: m for m in spec["per_layer"]}
    for t in TWINS:
        a, b = entry[t + ".map"], entry[t + ".overlap"]
        assert {k: v for k, v in a.items() if k not in ("name", "workloads")} \
            == {k: v for k, v in b.items() if k not in ("name", "workloads")}
        assert harness.reader(t + ".map") is harness.reader(t + ".overlap")


def test_denovo_config_overlaps_the_map_configs_reads():
    """The de-novo deployment draws its read set from the map
    configuration's genome at the same PacBio profile; its entry names
    its own source and file."""
    spec = harness.load_spec(ROOT)
    entry = {c["name"]: c for c in spec["configs"]}
    denovo, mapping = (entry["ecoli_k12_pacbio_denovo"],
                       entry["ecoli_k12_pacbio"])
    assert denovo["source"] != mapping["source"]
    assert denovo["file"] != mapping["file"]
    _, _, a = harness.load_cell(spec, CELL)
    _, _, b = harness.load_cell(spec, "ecoli_k12_pacbio.map")
    assert (a["genome"], a["reads"]) == (b["genome"], b["reads"])
    assert a["reduced"] == denovo["reduced"] == mapping["reduced"]
    assert a["source"] == denovo["source"]
    assert "read_set" in a["assumed"]


def _ctx(rows, counters=None):
    c = {"num_reads": 10}
    c.update(counters or {})
    return {"stats": {"spans": {"spans": rows, "clock_ns": [0, 1]},
                      "counters": c},
            "first_reads": 5}


def test_print_format_is_self_time_of_the_later_batches():
    rows = [("print_format", 1, 0, 0, 900),        # the first batch: out
            ("print_format", 1, 1, 1000, 1600),
            ("wait_card", 1, 1, 1100, 1200),       # inside: subtracted
            ("print_format", 2, 2, 2000, 2300),
            ("wait_turn", 1, 1, 1700, 1800),       # outside: kept out
            ("print_select", 2, 2, 1900, 2000)]
    got = overlap.print_format_ms(_ctx(rows))
    assert got == pytest.approx((500 + 300) / 1e6 / 5)


@pytest.mark.parametrize("ctx", [
    {"stats": {"counters": {"num_reads": 10}}, "first_reads": 5},
    _ctx([("print", 1, 1, 0, 100), ("seed", 1, 1, 0, 50)]),
    _ctx([("print_format", 1, 1, 0, 100)], {"num_reads": 5}),
], ids=["no spans", "no print_format span", "no read after the first"])
def test_print_format_reads_nothing_without_its_spans(ctx):
    assert overlap.print_format_ms(ctx) is None


def test_dropped_column_share():
    ctx = _ctx([], {"mhap_columns_printed": 300,
                    "mhap_columns_dropped": 100})
    assert overlap.dropped_column_share(ctx) == pytest.approx(0.25)
    none = _ctx([], {"mhap_columns_printed": 0, "mhap_columns_dropped": 0})
    assert overlap.dropped_column_share(none) is None
    # a run without the counters (a map run, or a parent's)
    assert overlap.dropped_column_share(_ctx([])) is None
    assert overlap.dropped_column_share({"stats": {}}) is None


def test_tiny_overlap_cell_traced_on_the_cpu():
    """run_cell on a read set of 30 reads, traced: the check is correct,
    and the span and counter metrics are read (the device ones need a
    card's trace)."""
    spec = tiny.spec()
    for m in spec["per_layer"]:
        if m.get("workloads") == [CELL]:
            m["workloads"] = [CELL, "tiny"]
    res = harness.run_cell(spec, "tiny", 2**31 + 99, 1e9, True, "cpu",
                           cell=tiny.cell("overlap"), run_kwargs=tiny.RUN)
    assert res["correct"] and res["checks"]["reads_differ"]["value"] == 0
    # one pass of 8 queries, 4 a batch, the first batch warm
    assert res["run"]["reads_done"] == res["run"]["reads_compared"] == 4
    m = res["metrics"]
    assert m["print.format_ms_per_read.overlap"]["value"] > 0
    # every read's alignment to itself is extended and dropped
    assert 0 < m["extend.dropped_column_share.overlap"]["value"] < 1
    assert m["extend.decode_ms_per_read.overlap"]["value"] > 0
    assert "device.idle.overlap" not in m
    # the twins on the map cell's readers: the host and span ones read
    # numbers here (tiny.RUN's one batch in flight waits for no turn, and
    # its chains of 1 make no speculative hit)
    for t in TWINS[:5]:
        assert m[t + ".overlap"]["value"] > 0, t
    assert m["host.turn_wait_ms_per_read.overlap"]["value"] == 0
