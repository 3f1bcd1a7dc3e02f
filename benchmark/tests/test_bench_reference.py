"""The plain reference against the port's own CPU path, record for record,
on tiny cases of each mode: the test may import both, the reference
imports nothing of the port."""

import io
import os

import pytest

from benchmark import harness
from benchmark.gen import reads as greads
from benchmark.reference.darwin import Reference
from benchmark.tests import tiny


@pytest.mark.parametrize("mode,genome", [("map", "uniform"),
                                         ("map", "repeat"),
                                         ("overlap", "uniform")])
def test_reference_equals_port_cpu(tmp_path, mode, genome):
    from darwin_tpu_torch.pipeline.align import run
    _, traffic, config = tiny.cell(mode, genome)
    chroms, reads = harness.make_inputs(config, traffic, 2**31 + 11, 8)
    ref = tmp_path / "ref.fa"
    ref.write_bytes(greads.fasta_bytes(chroms))
    rd = tmp_path / "reads.fa"
    rd.write_bytes(greads.fasta_bytes(reads))
    out = io.StringIO()
    run(str(ref), str(rd), mode == "overlap", out=out, err=io.StringIO(),
        device="cpu", **tiny.RUN)
    lines = [l + "\n" for l in out.getvalue().split("\n")
             if l and not l.startswith("@")]
    got = harness.records_by_read([(0, lines)], [n for n, _ in reads],
                                  mode == "overlap")
    want = Reference(chroms, mode == "overlap", "cpu").align(reads)
    assert got == want
    # not vacuous: at 30 % error a read on a repeat may find no
    # alignment, and at this coverage a query no overlap; half do
    assert sum(1 for v in want.values() if v) >= len(reads) // 2


def test_control_differs():
    """8-bit lanes saturate the tile DP: its records differ."""
    _, traffic, config = tiny.cell()
    chroms, reads = harness.make_inputs(config, traffic, 7, 4)
    exact = Reference(chroms, False, "cpu").align(reads)
    low = Reference(chroms, False, "cpu", bits=8).align(reads)
    assert harness.check_records(low, exact)["differ"] >= 1
    same = Reference(chroms, False, "cpu", bits=16).align(reads)
    assert harness.check_records(same, exact)["differ"] == 0


@pytest.mark.card
def test_control_differs_on_card_at_cell_size():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import control
    spec = harness.load_spec(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))
    n, d = control.control(spec, "ecoli_k12_pacbio.map", 2**31 + 3)
    assert n > 0 and d >= 1
