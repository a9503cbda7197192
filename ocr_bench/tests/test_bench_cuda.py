"""On the card (``-m cuda``): each cell runs for a few seconds at its own
size and comes out correct, and its control (the reference one precision
below the configuration's, in the program's place) comes out not correct
on three seeds.  Whether a card is present is decided inside the tests."""
import pytest
import torch

from ocr_bench import harness

CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def pieces(cell):
    return harness.find_cell(harness.load_json(harness.ROOT / "BENCHMARK.json"), cell)


def run(cell, seed, control=False):
    p = pieces(cell)
    ctx = harness.Ctx(p, seed, 4.0, False, "cuda", harness.process_start())
    ctx.control = control
    if p["config"].get("tf32") is not None:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(p["config"]["tf32"])
    return p, harness.driver_of(p).run(ctx)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell):
    card()
    ctx = harness.Ctx(pieces(cell), 2**31 + 77, 4.0, False, "cuda", harness.process_start())
    line = harness.run_cell(ctx, pieces(cell))
    assert line["correct"], line
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    card()
    for seed in (501, 502, 503):
        p, out = run(cell, seed, control=True)
        limits = p["limits"]
        assert all(out["numbers"][k] <= v for k, v in limits.items()), out["numbers"]
        control = out["control"].get("tf32", out["control"])  # training also reads a fault
        assert any(control[k] > v for k, v in limits.items() if k in control), control
