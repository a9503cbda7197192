"""The model axis (tensor parallelism) of the PyTorch port (CPU, gloo).

One spawn of two ranks on a 1x2 mesh runs every case of
:func:`torch_dp_workers.run_cases` with the weights sharded by
``param_sharding_rules``:

* the sharded CRNN forward (CTC without a rectifier, Attention with TPS)
  against the JAX ``CRNNet.apply`` on the same weights, at the tolerance
  of ``tests/test_multichip.py::test_tp_forward_matches_replicated``
  (rtol 2e-4, atol 2e-5; the JAX side is the replicated forward, which
  that test holds equal to the JAX tensor-parallel one);
* the float64 CRNN (Attention, TPS) and CRAFT (slice1 frozen) steps
  against one process's step of the port (``test_two_rank_step_matches_jax``
  holds that one to JAX): loss, ``grad_norm`` and every tensor of the
  updated state within 1e-12 relative L2;
* every tensor that the rules split held as its ``1/model`` slice of dim
  0 on each rank, every other tensor whole (asserted on each rank by the
  workers, and on rank 0's shapes here).

A 2x2 mesh of four ranks takes the CRNN step; the CRNN trainer on a 1x2
mesh writes one set of logs and whole checkpoints, which resume on one
process and back on 1x2.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_workers
from lightly_ocr_tpu.config import Config as JConfig
from lightly_ocr_tpu.models.crnn import CRNNet as JCRNNet
from lightly_ocr_tpu.utils.torch_import import import_torch_state_dict
from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.models.crnn import CRNNet
from lightly_ocr_tpu_torch.models.layers import init_module, init_train_params
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.parallel import make_mesh, param_sharding_rules
from lightly_ocr_tpu_torch.parallel.launch import spawn
from lightly_ocr_tpu_torch.train import craft

SMALL = dict(output_channel=64, hidden_size=32, num_fiducial=8, character="abcdefghij",
             batch_max_len=8)
FORWARD = {"ctc": dict(prediction="CTC", transform="None"),
           "attention": dict(prediction="Attention", transform="TPS")}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _forward_case(kind: str) -> tuple[dict, np.ndarray]:
    """(the port's forward case, the JAX forward on the same weights):
    seeded weights of the port (BatchNorm statistics and biases away from
    their init), carried to the JAX package by its importer."""
    cfg = Config(**SMALL, **FORWARD[kind])
    x = np.random.default_rng(3).uniform(-1, 1, (4, cfg.height, cfg.width, 1)).astype(np.float32)
    sd = init_module(CRNNet(cfg), torch.Generator().manual_seed(0)).state_dict()
    jnet = JCRNNet(JConfig(**SMALL, **FORWARD[kind]))
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.key(0), jnp.asarray(x[:1]), None, False))
    v = import_torch_state_dict(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes),
                                {k: t.numpy() for k, t in sd.items()})
    ref = np.asarray(jax.jit(lambda v, x: jnet.apply(v, x, None, False))(v, jnp.asarray(x)))
    return {"cfg": cfg, "init": sd, "images": torch.from_numpy(x)}, ref


def _crnn_case(batch: int = 4) -> dict:
    cfg = Config(**SMALL, prediction="Attention", transform="TPS", height=32, width=64)
    rng = np.random.default_rng(0)
    return {"cfg": cfg,
            "init": init_train_params(CRNNet(cfg), torch.Generator().manual_seed(0)).state_dict(),
            "batch": {"images": torch.from_numpy(rng.uniform(-1, 1, (batch, 32, 64, 1))),
                      "text": torch.from_numpy(rng.integers(2, 12, (batch, cfg.batch_max_len + 2))),
                      "lengths": torch.full((batch,), 5)}}


def _craft_case() -> dict:
    rng = np.random.default_rng(2)
    return {"init": init_train_params(VGG_UNet(), torch.Generator().manual_seed(1)).state_dict(),
            "batch": {k: torch.from_numpy(v).double()
                      for k, v in craft.synthesize_batch(rng, 2, 32, 32).items()},
            "freeze": ("slice1",)}


@pytest.fixture(scope="module")
def two_ranks():
    """Every case on a 1x2 mesh of CPU ranks (one spawn), the JAX
    forwards, and one process's steps."""
    cases, jax_out = {}, {}
    for kind in FORWARD:
        cases[kind], jax_out[kind] = _forward_case(kind)
    cases = {k: ("forward", v) for k, v in cases.items()}
    cases["crnn"] = ("crnn", _crnn_case())
    cases["craft"] = ("craft", _craft_case())
    got = spawn(torch_dp_workers.run_cases, (cases,), make_mesh(1, 2, ["cpu", "cpu"]))
    steps = {k: cases[k] for k in ("crnn", "craft")}
    alone = torch_dp_workers.run_cases(steps, torch.device("cpu"))
    return {"cases": cases, "got": got, "jax": jax_out, "alone": alone}


@pytest.mark.parametrize("kind", list(FORWARD))
def test_sharded_forward_matches_jax(two_ranks, kind):
    got, ref = two_ranks["got"][kind].numpy(), two_ranks["jax"][kind]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kind", ["crnn", "craft"])
def test_sharded_step_matches_one_process(two_ranks, kind):
    got, want = two_ranks["got"][kind], two_ranks["alone"][kind]
    torch_dp_workers.assert_same_step(got, want)
    assert got["collectives"] > 0 and want["collectives"] == 0


@pytest.mark.parametrize("kind", ["crnn", "craft"])
def test_sharded_tensors_are_slices(two_ranks, kind):
    """Rank 0 holds ``1/2`` of dim 0 of each tensor the rules split, and
    the whole of every other one (biases, BatchNorm, the narrow heads)."""
    full = two_ranks["cases"][kind][1]["init"]
    rules = param_sharding_rules(full, make_mesh(1, 2, ["cpu", "cpu"]))
    shapes = two_ranks["got"][kind]["local_shapes"]
    assert shapes.keys() == full.keys()
    split = 0
    for k, v in full.items():
        want = (v.shape[0] // 2, *v.shape[1:]) if rules[k] == 0 else tuple(v.shape)
        assert shapes[k] == want, k
        split += rules[k] == 0
        if k.endswith("bias") or "running_" in k or ".bn" in k:
            assert rules[k] is None, k
    assert split > 0


def test_crnn_step_over_a_2x2_mesh():
    """Four ranks: the batch over two data indices, the weights over two
    model indices; the float64 step of one process."""
    case = {"crnn": ("crnn", _crnn_case())}
    got = spawn(torch_dp_workers.run_cases, (case,), make_mesh(2, 2, ["cpu"] * 4))
    alone = torch_dp_workers.run_cases(case, torch.device("cpu"))
    torch_dp_workers.assert_same_step(got["crnn"], alone["crnn"])


def test_trainer_on_a_model_axis_checkpoints_whole_and_resumes_both_ways(tmp_path):
    """The CRNN trainer on a 1x2 mesh: 4 steps, a checkpoint every 2, one
    set of logs; each checkpoint holds the full state (the keys and shapes
    of a one-process run); one process resumes it to step 6, and the 1x2
    mesh resumes that one-process checkpoint to step 8."""
    from lightly_ocr_tpu.data import generator as jgen
    from lightly_ocr_tpu_torch.train.trainer import train_rank
    from lightly_ocr_tpu_torch.utils import checkpoint as ckpt

    train, val = str(tmp_path / "t.lor"), str(tmp_path / "v.lor")
    jgen.synthesize_words(train, n=16, charset="abcdefghij", max_len=5, seed=1)
    jgen.synthesize_words(val, n=4, charset="abcdefghij", max_len=5, seed=2)
    log_dir = tmp_path / "ma"
    cfg = Config(output_channel=32, hidden_size=16, batch_max_len=8, character="abcdefghij",
                 prediction="CTC", transform="None", batch_size=4, adam=False, workers=1,
                 train_root=train, val_root=val, val_interval=2, save_interval=2, max_iter=1,
                 num_iters=4, log_dir=str(log_dir), mesh_model=2)
    mesh = make_mesh(1, 2, ["cpu", "cpu"])
    spawn(train_rank, (cfg,), mesh)
    root = str(log_dir / "checkpoints")
    assert sorted(os.listdir(root)) == ["2", "4"]
    text = (log_dir / "log_train.txt").read_text()
    assert text.count("[2/4] train_loss:") == 1 and text.count("[4/4] train_loss:") == 1
    assert (log_dir / "log_dataset.txt").read_text().count("dataset_root:") == 1

    def assert_whole(step: int) -> None:
        saved, _ = ckpt.load_state_file(root, step)
        one = CRNNet(cfg)
        want = {k: tuple(v.shape) for k, v in one.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in saved["model"].items()} == want
        params = [tuple(p.shape) for p in one.parameters()]
        state = saved["optimizer"]["state"]
        assert sorted(state) == list(range(len(params)))
        for i, shape in enumerate(params):
            for name in ("square_avg", "acc_delta"):
                assert tuple(state[i][name].shape) == shape, (i, name)
        assert all(torch.isfinite(v).all() for v in saved["model"].values())
        assert saved["step"] == step

    assert_whole(4)
    one = cfg.replace(saved_model_path=root, num_iters=6, mesh_model=1)
    train_rank(one, device=torch.device("cpu"))
    assert_whole(6)
    back = cfg.replace(saved_model_path=root, num_iters=8)
    spawn(train_rank, (back,), mesh)
    assert sorted(os.listdir(root)) == ["2", "4", "6", "8"]
    assert_whole(8)
    assert json.loads((log_dir / "best.json").read_text())["step"] in (2, 4, 6, 8)
