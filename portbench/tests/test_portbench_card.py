"""The check's control and faults at each cell's own size, on the card.

    python -m pytest portbench/tests/test_portbench_card.py -q   (on the H100)

For three seeds a cell: the program's numbers within the cell's limits;
the control (the reference in the precision below the configured one, in
the program's place) outside at least one; for training cells each fault
(half the batch, the learning rate left undecayed) outside at least one
too. Skips without a card. The
``card`` marker names these tests (``-m card``); the repository's pytest
settings do not register it yet, so pytest warns of it.
"""
import pytest
import torch

from portbench import harness, judge
from portbench.readings import FAULTS, readings
from portbench.tests import tiny

SEEDS = (2147483901, 2147483902, 2147483903)
CELLS = [w["name"] for w in harness.benchmark_spec()["workloads"]]


@pytest.fixture
def card():
    """The card, or a skip: decided here, never while the module imports."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this check runs on the H100")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_the_limits(card, cell):
    limits = harness.workload_file(cell)["limits"]
    for seed in SEEDS:
        got = readings(cell, seed, "cuda")
        assert judge.verdict(got["program"], limits), (seed, got["program"])
        assert not judge.verdict(got["control"], limits), (seed, got["control"])
        for fault in FAULTS:
            if fault in got:
                assert not judge.verdict(got[fault], limits), (seed, fault, got[fault])


@pytest.mark.parametrize("cell", ["ml1m-train", "ml1m-serve"])
def test_readings_rehearse_on_the_cpu(cell):
    bench, workload, config = tiny.cell(cell)
    got = readings(cell, 5, "cpu", 1.5, bench=bench, workload=workload, config=config)
    assert set(got["program"]) == set(workload["limits"]) == set(got["control"])
    assert judge.verdict(got["program"], workload["limits"]), got["program"]
