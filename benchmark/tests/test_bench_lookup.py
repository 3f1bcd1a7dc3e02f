"""The harness finds a cell's configuration, traffic and metrics by name:
a later change adds a cell or a metric as new files only."""

import json
import os
import shutil

from benchmark import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def test_every_name_in_the_spec_has_its_files():
    spec = harness.load_spec(ROOT)
    for w in spec["workloads"]:
        wl, traffic, config = harness.load_cell(spec, w["name"])
        assert traffic["mode"] in ("map", "overlap")
        assert config["name"] == w["config"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]


def test_a_new_cell_and_metric_are_found(tmp_path):
    base = tmp_path / "benchmark"
    shutil.copytree(BENCH, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = harness.load_spec(ROOT)
    spec["workloads"].append({"name": "ecoli_k12_pacbio.dummy",
                              "config": "ecoli_k12_pacbio",
                              "traffic": "dummy", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "dummy.metric", "unit": "s",
                              "better": "lower", "source": "host_clock",
                              "layer": "x", "moves": "setup_s",
                              "workloads": ["ecoli_k12_pacbio.dummy"]})
    (base / "cells" / "ecoli_k12_pacbio.dummy.json").write_text(
        json.dumps({"mode": "map", "pool_reads": 128}))
    (base / "metrics" / "dummy.metric.py").write_text(
        "def read(ctx):\n    return ctx['setup_s'] * 2\n")
    wl, traffic, config = harness.load_cell(
        spec, "ecoli_k12_pacbio.dummy", str(base))
    assert traffic["pool_reads"] == 128
    assert config["name"] == "ecoli_k12_pacbio"
    names = [m["name"] for m in harness.cell_metrics(
        spec, "ecoli_k12_pacbio.dummy", True)]
    assert names == ["dummy.metric"]
    e2e = [m["name"] for m in harness.cell_metrics(
        spec, "ecoli_k12_pacbio.dummy", False)]
    assert e2e == ["setup_s"]
    assert harness.reader("dummy.metric", str(base))({"setup_s": 2}) == 4
