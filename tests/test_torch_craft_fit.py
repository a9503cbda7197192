"""CRAFT training through ``train/craft.py``'s loop (``craft_batches`` and
``fit_craft``), held to the loop it replaced and to the benchmark's plain
reference (``ocr_bench/reference/craft_train.py``), at b2 and 64x96 on the
CPU with the benchmark's seeded weights: the losses bit for bit, the step
in float64 and float32, a planted fault failing the benchmark's check, and
the loop's spans and counter under the profiler."""
import copy
import json
import os

import numpy as np
import pytest
import torch

from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.train import craft
from lightly_ocr_tpu_torch.train import pseudo_labels as pl
from lightly_ocr_tpu_torch.train.train_step import TrainState
from lightly_ocr_tpu_torch.utils import profiling
from ocr_bench import check_craft_training, faults_craft, harness, weights
from ocr_bench.reference import craft as ref_craft
from ocr_bench.reference import craft_train as ref
from ocr_bench.tests.conftest import TINY_CRAFT

B, H, W = TINY_CRAFT["batch"], TINY_CRAFT["height"], TINY_CRAFT["width"]
CELL = "train_craft_b16"


@pytest.fixture(autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def replaced_loop(num_steps, batch, height, width, seed, records=None):
    """``train_craft``'s loop before ``fit_craft`` (one process): (losses,
    the model's state dict)."""
    rng = np.random.default_rng(seed)
    model, state = craft.init_craft_state(seed, 1e-3, "cpu")
    step_fn = craft.make_craft_train_step(model)
    data_iter = None
    if records is not None:
        data_iter = pl.batches_from_records(records, batch, height, width, rng, rows=slice(0, batch))
    losses = []
    for _ in range(num_steps):
        if data_iter is not None:
            data = next(data_iter)
        else:
            data = craft.synthesize_batch(rng, batch, height, width)
            data = {k: v[0:batch] for k, v in data.items()}
        state, metrics = step_fn(state, craft.batch_to(data, torch.device("cpu")))
        losses.append(metrics["loss"])
    return torch.stack(losses).tolist(), model.state_dict()


def word_records(path: str) -> str:
    rng = np.random.default_rng(5)
    samples = []
    for _ in range(3):
        gray = np.full((90, 150), 235.0) + rng.normal(0, 5, (90, 150))
        words = []
        for r, n in ((10, 5), (50, 3)):
            c = c0 = int(rng.integers(4, 20))
            for _ in range(n):
                cw = int(rng.integers(9, 16))
                gray[r: r + 22, c: c + cw] = rng.uniform(20, 80, (22, cw))
                c += cw + int(rng.integers(2, 8))
            words.append({"rect": [r - 2.5, c0 - 1.5, r + 24.3, c + 1.2], "text": "abcdefgh"[:n]})
        samples.append((np.repeat(np.clip(gray, 0, 255).astype(np.uint8)[..., None], 3, -1), words))
    pl.write_detection_records(path, iter(samples))
    return path


@pytest.mark.parametrize("source", ["synthetic", "records"])
def test_train_craft_gives_the_losses_of_the_loop_it_replaced(source, tmp_path):
    records = word_records(str(tmp_path / "det.lor")) if source == "records" else None
    want, want_sd = replaced_loop(3, B, H, W, seed=4, records=records)
    model, state, got = craft.train_craft(num_steps=3, batch=B, height=H, width=W, seed=4, device="cpu",
                                          log_every=0, records=records)
    assert got == want and state.step == 3
    for k, v in model.state_dict().items():
        assert torch.equal(v, want_sd[k]), k


def test_craft_batches_draw_as_synthesize_batch():
    """The synthetic source is ``synthesize_batch`` from the same generator,
    ``max_words`` passed through, ``rows`` a slice of each batch."""
    got = craft.craft_batches(np.random.default_rng(2), 3, H, W, rows=slice(1, 3), max_words=20)
    rng = np.random.default_rng(2)
    for _ in range(2):
        want = craft.synthesize_batch(rng, 3, H, W, 20)
        for k, v in next(got).items():
            np.testing.assert_array_equal(v, want[k][1:3], err_msg=k)


def test_cli_passes_max_words(capsys):
    assert craft.main(["--num-steps", "1", "--batch", "1", "--height", "32", "--width", "32",
                       "--max-words", "3", "--log-every", "1", "--device", "cpu"]) == 0
    assert "craft step 1/1 loss" in capsys.readouterr().out


def benchmark_state(seed: int, dtype):
    sd = weights.make(ref_craft.param_spec(), seed, "cpu")
    model = VGG_UNet()
    model.load_state_dict(sd, strict=True)
    model.to(dtype).train()
    state = TrainState(model, craft.make_craft_optimizer(model.parameters(), ref.LR))
    return sd, model, state


def port_state(model, optimizer) -> dict:
    """The port's state as the reference takes it, copied."""
    named = list(model.named_parameters())
    st = optimizer.state
    adam = {"step": int(st[named[0][1]]["step"]),
            "exp_avg": {k: st[p]["exp_avg"].clone() for k, p in named},
            "exp_avg_sq": {k: st[p]["exp_avg_sq"].clone() for k, p in named}} if st else None
    return {"params": {k: p.detach().clone() for k, p in named},
            "buffers": {k: v.clone() for k, v in model.named_buffers()}, "adam": adam}


def steps_against_reference(dtype, n=2, seed=3, follow=False):
    """The port's ``make_craft_train_step`` and the reference, ``n`` steps
    each from the benchmark's weights on the same batches, the reference on
    its own or (``follow``) each step from the port's state before it: for
    each step (the port's loss, maps, clipped gradients, raw norm,
    parameters and running statistics after; the reference's step and its
    start)."""
    sd, model, state = benchmark_state(seed, dtype)
    step = craft.make_craft_train_step(model, clip=ref.CLIP)
    maps = []
    hook = model.register_forward_hook(lambda _m, _a, out: maps.append(out[0].detach()))
    rng = np.random.default_rng(seed)
    rstate = ref.split({k: v.to(dtype) for k, v in sd.items()})
    out = []
    for _ in range(n):
        b = {k: torch.from_numpy(v).to(dtype) for k, v in craft.synthesize_batch(rng, B, H, W).items()}
        if follow:
            rstate = port_state(model, state.optimizer)
        state, metrics = step(state, b)
        with ref.precision(False):
            r = dict(ref.step(rstate, b), start=rstate)
        rstate = {"params": r["params"], "buffers": r["buffers"], "adam": r["adam"]}
        port = {"loss": float(metrics["loss"]), "maps": maps[-1], "batch": b,
                "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
                "raw_norm": float(metrics["grad_norm"]),
                "params": {k: p.detach().clone() for k, p in model.named_parameters()},
                "buffers": {k: v.clone() for k, v in model.named_buffers()}}
        out.append((port, r))
    hook.remove()
    return out


def masks(fn, m, b):
    return [fn(m[..., c], b[key])[1:] for c, key in ((0, "region"), (1, "affinity"))]


def test_step_matches_the_reference_in_float64():
    """Loss 1e-10 relative; every gradient and parameter within 1e-8
    relative L2, but the gradients that are 0 (the biases of the convs a
    BatchNorm follows), held under 1e-12 of the global norm; the OHEM masks
    equal; the running statistics within 1e-10."""
    for port, r in steps_against_reference(torch.float64):
        assert abs(port["loss"] - float(r["loss"])) <= 1e-10 * abs(float(r["loss"]))
        assert abs(port["raw_norm"] - float(r["raw_norm"])) <= 1e-10 * float(r["raw_norm"])
        total = float(torch.sqrt(sum((g ** 2).sum() for g in r["grads"].values())))
        zero = {k for k, g in r["grads"].items() if float(g.norm()) < 1e-12 * total}
        assert zero and all(k.endswith(".bias") for k in zero)
        for k, g in r["grads"].items():
            if k in zero:
                assert float(port["grads"][k].norm()) < 1e-12 * total, k
            else:
                assert ref.rel_l2(port["grads"][k], g) <= 1e-8, k
        for k, v in r["params"].items():
            assert ref.rel_l2(port["params"][k], v) <= 1e-8, k
        assert port["buffers"].keys() == r["buffers"].keys()
        for k, v in r["buffers"].items():
            assert ref.rel_l2(port["buffers"][k], v) <= 1e-10, k
        for (pp, pn), (rp, rn) in zip(masks(craft.ohem_masks, port["maps"], port["batch"]),
                                      masks(ref.ohem, r["maps"], port["batch"])):
            assert torch.equal(pp, rp) and torch.equal(pn, rn)


def test_step_matches_the_reference_in_float32():
    """float32, both on the CPU, two steps, the reference's second from the
    port's state (Adam's first updates are about ``lr * sign(g)``, so a
    gradient near zero that rounds the other way sends the two apart by a
    whole update): loss 1e-5 relative (the two sum the squared errors in
    another order).  Each gradient whose float32 reference lies within
    ``ROUNDING`` of a float64 reference from the same state (the check's
    rule; the others are round-off of a zero gradient) within 1e-4 plus
    twice that float32 reference's own gap to float64 (some BatchNorm
    leaves hold a gradient that float32 gives to a few parts in 1e3).  The
    running statistics within 1e-5 (sums over the batch in another order);
    hard negatives within 0.1% of the reference's (a pixel whose error sits
    on the threshold may fall either side)."""
    for port, r in steps_against_reference(torch.float32, follow=True):
        g64 = check_craft_training.float64_grads(r["start"], port["batch"])
        noisy = check_craft_training.rounding_leaves(r["grads"], g64)
        assert abs(port["loss"] - float(r["loss"])) <= 1e-5 * abs(float(r["loss"]))
        for k in set(r["grads"]) - noisy:
            assert ref.rel_l2(port["grads"][k], r["grads"][k]) <= 1e-4 + 2 * ref.rel_l2(r["grads"][k], g64[k]), k
        for k, v in r["buffers"].items():
            assert ref.rel_l2(port["buffers"][k], v) <= 1e-5, k
        hard = sum(int(m[1].sum()) for m in masks(craft.ohem_masks, port["maps"], port["batch"]))
        assert abs(hard - r["hard_neg"]) <= 1e-3 * r["hard_neg"]


def tiny_cell(seed=11):
    p = copy.deepcopy(harness.find_cell(harness.load_json(harness.ROOT / "BENCHMARK.json"), CELL))
    p["traffic"].update(TINY_CRAFT)
    return harness.Ctx(p, seed, 1.5, False, "cpu", harness.process_start()), p


def test_a_step_over_half_its_batch_fails_the_check(monkeypatch):
    """The benchmark's run of the cell at a CPU's size is correct; with the
    port's step planted with a loss over half of its batch it is not."""
    ctx, p = tiny_cell()
    assert harness.run_cell(ctx, p)["correct"]
    faults_craft.half_batch_mean(monkeypatch)
    ctx, p = tiny_cell()
    line = harness.run_cell(ctx, p)
    assert not line["correct"]
    bad = {k for k, c in line["checks"].items() if c["value"] > c["limit"]}
    assert {"window_loss_gap", "grad_gap", "window_grad_gap"} <= bad, line["checks"]


def test_spans_and_counter_of_a_run(tmp_path):
    """Under the profiler: a ``train.step`` a step holding one
    ``train.forward``, ``craft.ohem``, ``train.backward`` and
    ``train.optimizer``; a ``craft.data`` and ``craft.upload`` a step
    outside it; two ``train.sync`` at each log point and none elsewhere;
    ``craft.upload_bytes`` the bytes of each batch."""
    model, state = craft.init_craft_state(1, device="cpu")
    step = craft.make_craft_train_step(model)
    batches = craft.craft_batches(np.random.default_rng(1), B, H, W)
    logged = []
    since = profiling.time.perf_counter()
    with profiling.trace(str(tmp_path), cuda=False):
        craft.fit_craft(state, step, batches, torch.device("cpu"), log_every=2, log_fn=logged.append,
                        num_steps=4)
    with open(os.path.join(tmp_path, profiling.TRACE_FILE)) as f:
        evs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "user_annotation"]

    def spans(name):
        return sorted((e for e in evs if e["name"] == name), key=lambda e: e["ts"])

    def inside(s, outer):
        return any(o["ts"] <= s["ts"] and s["ts"] + s["dur"] <= o["ts"] + o["dur"] for o in outer)

    steps = spans("train.step")
    assert len(steps) == 4 and len(logged) == 2
    for name in ("train.forward", "craft.ohem", "train.backward", "train.optimizer"):
        assert len(spans(name)) == 4 and all(inside(s, steps) for s in spans(name)), name
    for name in ("craft.data", "craft.upload"):
        assert len(spans(name)) == 4 and not any(inside(s, steps) for s in spans(name)), name
    syncs = spans("train.sync")
    assert len(syncs) == 4
    assert all(steps[1]["ts"] < s["ts"] < spans("craft.data")[2]["ts"] for s in syncs[:2])
    assert all(steps[3]["ts"] < s["ts"] for s in syncs[2:])
    nbytes = 4 * B * (H * W * 3 + 2 * (H // 2) * (W // 2))
    assert profiling.counter_values("craft.upload_bytes", since) == [nbytes] * 4


def test_no_craft_span_is_recorded_without_a_profiler(monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function

    def recording(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", recording)
    model, state = craft.init_craft_state(1, device="cpu")
    losses = craft.fit_craft(state, craft.make_craft_train_step(model), craft.craft_batches(
        np.random.default_rng(1), B, H, W), torch.device("cpu"), log_every=1, log_fn=lambda _: None, num_steps=1)
    assert len(losses) == 1 and state.step == 1
    assert [n for n in opened if n.startswith(("craft.", "train."))] == []
