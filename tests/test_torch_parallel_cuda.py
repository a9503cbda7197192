"""Data parallelism and export on the card.

Marked ``cuda``; skips without a CUDA device.  Imports nothing of JAX (the
CPU side is held to the JAX package in ``test_torch_parallel.py``,
``test_torch_train.py``, ``test_torch_craft.py`` and
``test_torch_export.py``), so it runs on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py

* ``BatchedOCR(mesh=...)`` with a replica on ``cuda:1`` where the machine
  has a second card (else two replicas on ``cuda:0``), a tiny model in
  bf16 (the seam tail kernel's dtype): the unsharded call's boxes on
  ``cuda:0`` and its confidences within 2e-2 (cuDNN may pick other
  algorithms for the half batch), and the kernels #1 (seam tail) and #2
  (CC) launched once per replica; the same on an empty build directory,
  where the replicas' threads miss the kernels' libraries together and
  build each once;
* two ranks on the card (NCCL over two cards where there are two; gloo on
  one card, which NCCL refuses to share) take the float64 CRAFT step (slice1
  frozen) of one process on the card: loss and gradient norm within
  1e-10, every tensor within 1e-8 relative L2 (the zero-gradient conv
  biases aside, as ``test_torch_craft.py``);
* two gloo ranks on ``cuda:0`` as a 1x2 mesh (a model axis) take the
  float64 CRNN step (TPS + Attention) of one process on the card, as
  ``torch_dp_workers.assert_same_step`` holds it (1e-12 relative L2);
* ``export_crnn`` (TPS + Attention) and ``export_craft`` on ``cuda``: the
  reloaded programs give the eager modules' outputs within 1e-5.
"""
import numpy as np
import pytest
import torch

import torch_dp_workers
from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.export import export_craft, export_crnn, load_exported, save_exported
from lightly_ocr_tpu_torch.models.crnn import CRNNet
from lightly_ocr_tpu_torch.models.layers import init_module, init_train_params
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.ops import cc, native, seam_tail
from lightly_ocr_tpu_torch.parallel import make_mesh
from lightly_ocr_tpu_torch.parallel.launch import spawn
from lightly_ocr_tpu_torch.serving.batch import BatchedOCR
from lightly_ocr_tpu_torch.train import craft

pytestmark = pytest.mark.cuda

TINY = dict(prediction="Attention", transform="TPS", output_channel=64, hidden_size=32,
            num_fiducial=8, max_boxes=4, character="abcdefghij", batch_max_len=8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _devices(n: int = 2) -> list:
    """``cuda:0`` and ``cuda:1`` where there are two cards, else ``cuda:0``
    twice."""
    return [torch.device("cuda", i if torch.cuda.device_count() >= n else 0) for i in range(n)]


def _mesh_case():
    cfg = Config(**TINY, low_text=0.0, text_threshold=0.0, link_threshold=0.0)
    g = torch.Generator().manual_seed(0)
    det = init_module(VGG_UNet(), g).state_dict()
    rec = init_module(CRNNet(cfg), g).state_dict()
    rng = np.random.default_rng(0)
    B, H, W = 4, 96, 64
    args = (torch.from_numpy(rng.standard_normal((B, H, W, 3)).astype(np.float32)).cuda(),
            torch.from_numpy((rng.random((B, H, W)) * 255).astype(np.float32)).cuda(),
            torch.ones(B, device="cuda"), torch.tensor([[H, W]] * B, dtype=torch.float32, device="cuda"))
    return cfg, det, rec, args


def _check_sharded(got, want):
    for k in want:
        assert got[k].device == torch.device("cuda", 0), k
    assert want["valid"][:, 0].all()  # every threshold 0: one box, the whole image
    assert torch.equal(got["valid"], want["valid"]) and torch.equal(got["rects"], want["rects"])
    torch.testing.assert_close(got["confidence"], want["confidence"], rtol=0, atol=2e-2)


def test_mesh_replicas_on_the_card(cuda_device):
    cfg, det, rec, args = _mesh_case()
    devices = _devices()
    sharded = BatchedOCR(cfg, det, rec, 4, torch.bfloat16, mesh=make_mesh(2, 1, devices))
    assert [r.device for r in sharded.replicas] == devices
    plain = BatchedOCR(cfg, det, rec, 4, torch.bfloat16, device="cuda:0")
    want = plain(*args)
    seam_tail.seam_tail.launches = cc.label_components.launches = 0
    got = sharded(*args)
    sharded.close()
    assert seam_tail.seam_tail.launches == cc.label_components.launches == 2
    _check_sharded(got, want)


def test_first_mesh_dispatch_on_an_empty_build_dir(cuda_device, monkeypatch, tmp_path):
    cfg, det, rec, args = _mesh_case()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_libs", {})
    builds = []
    real_build = native._build
    monkeypatch.setattr(native, "_build", lambda names: builds.extend(
        n for n in names if not native.library_path(n).exists()) or real_build(names))
    sharded = BatchedOCR(cfg, det, rec, 4, torch.bfloat16, mesh=make_mesh(2, 1, _devices()))
    got = sharded(*args)
    sharded.close()
    assert sorted(builds) == sorted(set(builds)) and {"seam_tail", "cc"} <= set(builds)
    want = BatchedOCR(cfg, det, rec, 4, torch.bfloat16, device="cuda:0")(*args)
    _check_sharded(got, want)


def test_two_ranks_on_the_card_take_the_one_process_step(cuda_device):
    rng = np.random.default_rng(11)
    sd = init_train_params(VGG_UNet(), torch.Generator().manual_seed(0)).state_dict()
    batch = {k: torch.from_numpy(v).double() for k, v in craft.synthesize_batch(rng, 2, 64, 64).items()}
    cases = {"craft": ("craft", {"init": sd, "batch": batch, "freeze": ("slice1",)})}
    alone = torch_dp_workers.run_cases(cases, torch.device("cuda", 0))["craft"]
    got = spawn(torch_dp_workers.run_cases, (cases,), _devices())["craft"]
    np.testing.assert_allclose(got["loss"], alone["loss"], rtol=1e-10)
    np.testing.assert_allclose(got["grad_norm"], alone["grad_norm"], rtol=1e-10)
    zero = {n for n, g in alone["grads"].items() if g.norm() < 1e-12 * alone["grad_norm"]}
    for part in ("grads", "state"):
        for k, v in alone[part].items():
            if k not in zero:
                assert torch_dp_workers.rel_l2(got[part][k].cpu(), v.cpu()) < 1e-8, (part, k)


def _cpu(result: dict) -> dict:
    return {k: {n: t.cpu() if torch.is_tensor(t) else t for n, t in v.items()} if isinstance(v, dict) else v
            for k, v in result.items()}


def test_model_axis_on_the_card_takes_the_one_process_step(cuda_device):
    cfg = Config(**TINY, height=32, width=64)
    rng = np.random.default_rng(12)
    sd = init_train_params(CRNNet(cfg), torch.Generator().manual_seed(0)).state_dict()
    batch = {"images": torch.from_numpy(rng.uniform(-1, 1, (4, 32, 64, 1))),
             "text": torch.from_numpy(rng.integers(2, 12, (4, cfg.batch_max_len + 2))),
             "lengths": torch.full((4,), 5)}
    cases = {"crnn": ("crnn", {"cfg": cfg, "init": sd, "batch": batch})}
    alone = torch_dp_workers.run_cases(cases, torch.device("cuda", 0))["crnn"]
    mesh = make_mesh(1, 2, [torch.device("cuda", 0)] * 2)
    got = spawn(torch_dp_workers.run_cases, (cases,), mesh)["crnn"]
    torch_dp_workers.assert_same_step(_cpu(got), _cpu(alone))


@pytest.mark.parametrize("which", ["crnn", "craft"])
def test_export_on_the_card(cuda_device, tmp_path, which):
    x_crnn = torch.randn(2, 32, 100, 1, device="cuda")
    x_craft = torch.randn(1, 64, 64, 3, device="cuda")
    if which == "crnn":
        cfg = Config(**TINY)
        exported, example = export_crnn(cfg, batch=2, device="cuda")
        net, x = CRNNet(cfg), x_crnn
    else:
        exported, example = export_craft(batch=1, height=64, width=64, device="cuda")
        net, x = VGG_UNet(), x_craft
    assert example[0].is_cuda
    path = str(tmp_path / f"{which}.pt2")
    save_exported(exported, path)
    with torch.no_grad():
        got = load_exported(path).module()(x)
        init_train_params(net, torch.Generator().manual_seed(0))
        want = net.cuda().eval()(x)
    got, want = (got[0], want[0]) if which == "craft" else (got, want)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
