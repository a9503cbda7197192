"""The CRAFT training cell: its pieces found by name, its driver and check
end to end on the CPU at a tiny size (the spans' and the counter's readers
reading the program, the device's finding nothing), the reference's
operation count, and (``-m cuda``) the cell at its own size on the card."""
import pytest
import torch

from ocr_bench import harness
from ocr_bench.counts import craft_train as counts
from ocr_bench.tests import tiny

CELL = "train_craft_b16"
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NEW = ("craft_step_ms.train", "craft_forward_ms.train", "craft_ohem_ms.train", "craft_backward_ms.train",
       "craft_optimizer_ms.train", "craft_data_ms.train", "craft_upload_ms.train", "craft_upload_mb.train",
       "mfu.craft_train")
HOST = ("craft_data_ms.train", "craft_upload_ms.train", "craft_upload_mb.train")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_the_cells_pieces_are_found():
    p = harness.find_cell(BENCH, CELL)
    assert p["cell"]["chips"] == 1 and p["config"]["name"] == "craft_vgg16bn_train"
    assert p["config"]["precision"] == "float32" and p["config"]["tf32"] is False
    assert (p["traffic"]["batch"], p["traffic"]["height"], p["traffic"]["width"]) == (16, 640, 960)
    assert harness.driver_of(p).__name__.endswith("craft_loop")
    assert set(p["limits"]) == {"first_loss_gap", "window_loss_gap", "update_norm_gap", "grad_gap",
                                "window_grad_gap", "stats_gap", "hard_neg_gap"}
    assert [m["name"] for m in p["e2e"]] == ["train_samples_per_s", "setup_s"]
    assert {m["name"] for m in p["per_layer"]} == set(NEW) | {"idle_share.train"}


def test_the_operations_of_a_sample_are_the_reference_count():
    assert abs(counts.train_per_sample(640, 960) / 1e9 - 1309.2) < 0.1


def test_driver_and_check_end_to_end_with_the_faults():
    """Untraced, with the reference's faults read in the program's place:
    the program inside every limit, each fault outside one."""
    ctx, p = tiny.ctx(CELL, seed=2**31 + 5, seconds=2.0)
    ctx.control = True
    out = harness.driver_of(p).run(ctx)
    assert out["complete"], out["why_incomplete"]
    assert all(out["numbers"][k] <= v for k, v in p["limits"].items()), out["numbers"]
    assert out["e2e"]["train_samples_per_s"] > 0
    for name in ("half_batch", "positives_only"):
        c = out["control"][name]
        assert any(c[k] > v for k, v in p["limits"].items()), (name, c)


def test_a_traced_run_reads_the_programs_spans_and_counter():
    ctx, p = tiny.ctx(CELL, seed=2**31 + 6, seconds=2.0, trace=True)
    line = harness.run_cell(ctx, p)
    assert line["correct"], line["checks"]
    got = line["metrics"]
    assert set(got) == set(HOST), got  # the CPU has no device: the device metrics find nothing
    assert abs(got["craft_upload_mb.train"]["value"] - 4 * 2 * (64 * 96 * 3 + 2 * 32 * 48) / 1e6) < 1e-9


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_the_cell_runs_correct_on_the_card():
    card()
    p = harness.find_cell(BENCH, CELL)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    # the window has to reach the checked step, drawn among its first
    # check_within steps of about 1.7 s
    seconds = 2.0 * (p["traffic"]["check_within"] + 2)
    ctx = harness.Ctx(p, 2**31 + 91, seconds, False, "cuda", harness.process_start())
    line = harness.run_cell(ctx, p)
    assert line["correct"], line
    assert line["attempted"] > 0 and line["failed"] == 0
