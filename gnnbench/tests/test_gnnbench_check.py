"""The plain references against the program on the CPU at small sizes,
and the check failing the control and each fault a training cell can
have, with the cells' own limits. (On the card, ``gnnbench.calibrate``
reads the same at the cells' full sizes.)"""

import pytest

from gnnbench import bench, calibrate, check, faults

SMALL = {"gat-arxiv.powerlaw": {"traffic": {"nodes": 400, "edges": 2400}},
         "rgcn-mag.full": {"traffic": {"scale": 400, "edges": {}}}}
SEED = 2 ** 31 + 17


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_program_matches_reference(cell):
    r = bench.run_cell(cell, SEED, 0.2, False, "cpu", overrides=SMALL[cell])
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails(cell):
    """The reference with TF32 matmuls, in the program's place."""
    limits = bench.Cell(bench.load_benchmark(), cell).limits
    for row in calibrate.readings(cell, [SEED], ["control"], "cpu",
                                  SMALL[cell]):
        correct, checks = check.judge(row, limits)
        assert not correct, checks


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_fault_fails(cell, fault):
    """A whole run with the program broken under its timed path."""
    r = bench.run_cell(cell, SEED, 0.2, False, "cpu", overrides=SMALL[cell],
                       fault=faults.FAULTS[fault])
    assert not r["correct"], r["checks"]
