"""A cell small enough for the CPU: the port's twins run it in seconds."""

WL = {"name": "tiny", "config": "tiny", "traffic": "map", "chips": 1}
CONFIGS = {
    "uniform": {"genome": {"kind": "uniform", "seed": 5,
                           "chromosomes": [["c1", 40000], ["c2", 20000]]},
                "reads": {"loci_seed": 8, "length": 2000,
                          "error": [0.015, 0.0902, 0.0449]}},
    "repeat": {"genome": {"kind": "repeat", "seed": 6,
                          "chromosomes": [["r1", 300000]],
                          "repeat_fracs": {},
                          "gaps": {"telomere": 1000,
                                   "short_arms": {"r1": 40000},
                                   "scaffold_every": 100000,
                                   "scaffold_len": 100}},
               "reads": {"loci_seed": 9, "length": 5000,
                         "error": [0.165, 0.051, 0.084]}},
}
TRAFFIC = {
    "map": {"mode": "map", "pool_reads": 12, "trace_reads": 12,
            "sample_reads": 6},
    "overlap": {"mode": "overlap", "read_set": 30, "pool_reads": 8,
                "trace_reads": 8, "sample_reads": 6},
}
# run() at a batch the CPU aligns in a second or two
RUN = {"reads_per_batch": 4, "spec_k": 1, "pipeline_depth": 1}


def cell(mode="map", genome="uniform"):
    return (dict(WL, traffic=mode), TRAFFIC[mode], CONFIGS[genome])


def spec():
    from benchmark import harness
    from benchmark.tests.conftest import ROOT
    s = harness.load_spec(ROOT)
    s["workloads"].append(WL)
    return s
