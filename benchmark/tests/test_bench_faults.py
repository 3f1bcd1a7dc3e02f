"""A run of the harness on the CPU, with the timed path broken underneath,
comes out not correct; a sound one correct."""

import pytest

from benchmark import harness
from benchmark.tests import tiny


def _run(mode="map"):
    return harness.run_cell(tiny.spec(), "tiny", 2**31 + 99, 1e9, False,
                            "cpu", cell=tiny.cell(mode),
                            run_kwargs=tiny.RUN)


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"] and res["checks"]["reads_differ"]["value"] == 0
    assert list(res)[-1] == "checks"


def _alter_records(monkeypatch):
    from darwin_tpu_torch.pipeline import printer
    sam = printer.sam_lines

    def altered(*a, **k):
        lines = sam(*a, **k)
        if lines:
            f = lines[0].split("\t")
            f[3] = str(int(f[3]) + 1)
            lines[0] = "\t".join(f)
        return lines
    monkeypatch.setattr(printer, "sam_lines", altered)


def _drop_half(monkeypatch):
    from darwin_tpu_torch.pipeline import align
    batch = align.Aligner.align_batch

    def half(self, reads, counters=None):
        return batch(self, reads[:len(reads) // 2], counters)
    monkeypatch.setattr(align.Aligner, "align_batch", half)


def _no_extension(monkeypatch):
    from darwin_tpu_torch.pipeline import extend

    def unchanged(self, groups, reads, counters):
        return [[] for _ in groups]
    monkeypatch.setattr(extend.ExtensionManager, "run", unchanged)


@pytest.mark.parametrize("fault", [_alter_records, _drop_half,
                                   _no_extension])
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = _run()
    assert not res["correct"]
    assert res["checks"]["reads_differ"]["value"] >= 1
