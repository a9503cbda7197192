"""A run with the timed path broken underneath comes out not correct: once
for each fault a cell can have (one chip: no exchange between chips)."""
import pytest
import torch

from ocr_bench import faults, harness
from ocr_bench.tests import tiny

SERVE = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]
         if w["name"].startswith("serve")]
TRAIN = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]
         if w["name"].startswith("train")]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(cell):
    ctx, p = tiny.ctx(cell, seconds=2.0)
    return harness.run_cell(ctx, p)


@pytest.mark.parametrize("fault", faults.SERVING, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", SERVE)
def test_serving_fault_is_not_correct(cell, fault, monkeypatch):
    assert run(cell)["correct"]
    fault(monkeypatch)
    line = run(cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", faults.TRAINING, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", TRAIN)
def test_training_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    line = run(cell)
    assert not line["correct"], line["checks"]
