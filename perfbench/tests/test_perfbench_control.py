"""On the card: each cell's control (the plain reference in TF32, one
precision below the configurations' float32, put in the program's place)
comes out not correct against the cell's limits, while the program on the
same inputs comes out correct. At the cells' own sizes, on one seed each (a
short window); ``perfbench/control.py`` reads a dozen seeds the same way."""

import pytest

from perfbench import harness

CELLS = [c["name"] for c in harness.manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, cuda_device):
    readings = harness.control(harness.manifest(), cell, 2**31 + 97, 1.0, cuda_device)
    limits = harness.limits_of(cell)
    assert all(readings["program"][n] <= limits[n] for n in limits), readings
    assert any(readings["control"][n] > limits[n] for n in limits), readings
