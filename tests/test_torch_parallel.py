"""Data parallelism of the PyTorch port vs the JAX package (CPU).

* ``make_mesh``: the JAX function's sizes and errors on the same inputs;
* ``param_sharding_rules``: the dimension each of the JAX rules splits,
  tensor for tensor, on the same model's tensors;
* ``BatchedOCR(mesh=...)`` over two CPU replicas (one thread each), and
  over a 2x2 mesh with a model axis, equals the unsharded port call exactly
  (the same per-sample arithmetic), and the
  JAX ``BatchedOCR`` over a two-device mesh of conftest's eight CPU
  devices: valid boxes equal, rects within 1 px, decoded indices equal and
  confidences within 1e-4 (float32; both run the plain detector, the JAX
  package's plan off its accelerator);
* a gloo group of one process takes the single-device step bit for bit;
  ``train_craft`` over two gloo ranks takes the first step of one process
  (float32, 1e-5 relative) and writes one checkpoint;
* the CRNN trainer over two gloo ranks writes its logs and checkpoints
  once and resumes.

The steps over two ranks against the JAX package's float64 step are in
``test_torch_train.py`` and ``test_torch_craft.py`` (they share those
files' JAX compiles).
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dp_workers
from lightly_ocr_tpu.config import Config as JConfig
from lightly_ocr_tpu.models.crnn import CRNNet as JCRNNet
from lightly_ocr_tpu.models.vgg_unet import VGG_UNet as JVGG_UNet
from lightly_ocr_tpu.parallel.mesh import make_mesh as jmake_mesh
from lightly_ocr_tpu.parallel.mesh import param_sharding_rules as jrules
from lightly_ocr_tpu.serving.batch import BatchedOCR as JBatchedOCR
from lightly_ocr_tpu.utils.torch_import import import_torch_state_dict
from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.models.crnn import CRNNet
from lightly_ocr_tpu_torch.models.layers import init_module, init_train_params
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.parallel import make_mesh, param_sharding_rules, shard_batch
from lightly_ocr_tpu_torch.parallel.launch import backend_for, spawn
from lightly_ocr_tpu_torch.serving.batch import BatchedOCR
from lightly_ocr_tpu_torch.train import craft

TINY = dict(prediction="Attention", transform="TPS", sequence="biLSTM", output_channel=64,
            hidden_size=32, num_fiducial=8, max_boxes=4, character="abcdefghij", batch_max_len=8)
H, W, B = 96, 64, 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs (several test processes
    share the machine's cores under pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the mesh and its rules ---------------------------------------------------

@pytest.mark.parametrize("n,data,model", [(8, -1, 1), (8, 4, 2), (8, -1, 4), (4, 2, 2), (1, -1, 1),
                                          (8, 3, 1), (8, -1, 3), (8, 2, 1), (4, -1, 0), (2, 4, 1)])
def test_make_mesh_matches_jax(n, data, model):
    try:
        want = dict(jmake_mesh(data, model, jax.devices()[:n]).shape)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("(", r"\(").replace(")", r"\)")):
            make_mesh(data, model, ["cpu"] * n)
        return
    mesh = make_mesh(data, model, ["cpu"] * n)
    assert mesh.shape == want
    assert len(mesh.data_devices) == want["data"]


def test_make_mesh_wants_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def jax_template(module, *args):
    """The JAX package's variables tree of ``module``, zeros of the traced
    shapes (no compile)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args))
    return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)


def to_jax(template, state_dict: dict) -> dict:
    """The port's weights as the JAX package's variables (its importer)."""
    return import_torch_state_dict(template, {k: v.numpy() for k, v in state_dict.items()})


@pytest.mark.parametrize("model", [1, 2, 4])
def test_param_sharding_rules_match_jax(model):
    """On the tiny TPS + Attention CRNN: the JAX rule's split axis
    (``P(None, 'model')`` of an ``[in, out]`` kernel, the last axis of an
    HWIO kernel, ``P('model', None)`` of an LSTM weight) is the port's
    dimension 0 of the same tensor, and a replicated leaf is ``None``."""
    cfg = JConfig(**TINY)
    params = jax_template(JCRNNet(cfg), jnp.zeros((2, 32, 100, 1)),
                          jnp.zeros((2, cfg.num_steps), jnp.int32), True)["params"]
    specs = jrules(params, jmake_mesh(-1, model, jax.devices()))
    leaves = jax.tree_util.tree_flatten_with_path(specs)[0]
    sd = {k: v for k, v in CRNNet(Config(**TINY)).state_dict().items() if "running_" not in k}
    got = param_sharding_rules(sd, make_mesh(-1, model, ["cpu"] * 8))
    assert len(leaves) == len(got)
    split = 0
    for path, s in leaves:
        names = [p.key for p in path]
        leaf = {"kernel": "weight", "scale": "weight"}.get(names[-1], names[-1])
        key = ".".join([*names[:-1], leaf])
        want = None if all(a is None for a in s.spec) else 0
        assert got[key] == want, (key, s.spec)
        split += want is not None
    assert (split > 0) == (model > 1)


def test_shard_batch():
    mesh = make_mesh(2, 1, ["cpu", "cpu"])
    x = {"a": torch.arange(8.0).reshape(4, 2), "b": [torch.arange(4)]}
    parts = shard_batch(x, mesh)
    assert torch.equal(parts[1]["a"], x["a"][2:]) and torch.equal(parts[0]["b"][0], torch.arange(2))
    with pytest.raises(ValueError, match="does not evenly divide 3"):
        shard_batch(torch.zeros(3), mesh)
    with pytest.raises(ValueError, match="disagree"):
        shard_batch({"a": torch.zeros(2), "b": torch.zeros(4)}, mesh)


# -- BatchedOCR over a mesh -----------------------------------------------------

@pytest.fixture(scope="module")
def serving():
    """Seeded tiny weights of the port, carried to the JAX package by its
    importer, and a batch of 4 canvases; thresholds from quantiles of the
    maps so that boxes fire."""
    rng = np.random.default_rng(0)
    canv = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    gray = (rng.standard_normal((B, H, W)) * 40 + 128).astype(np.float32)
    g = torch.Generator().manual_seed(0)
    det = init_module(VGG_UNet(), g).state_dict()
    rec = init_module(CRNNet(Config(**TINY)), g).state_dict()
    dv = to_jax(jax_template(JVGG_UNet(), jnp.zeros((1, H, W, 3))), det)
    rv = to_jax(jax_template(JCRNNet(JConfig(**TINY)), jnp.zeros((2, 32, 100, 1)), None, False), rec)
    net = VGG_UNet()
    net.load_state_dict(det)
    with torch.no_grad():
        y = net.eval()(torch.from_numpy(canv))[0].numpy()
    thresholds = dict(low_text=float(np.quantile(y[..., 0], 0.8)),
                      text_threshold=float(np.quantile(y[..., 0], 0.95)),
                      link_threshold=float(np.quantile(y[..., 1], 0.97)))
    return {"canv": canv, "gray": gray, "dv": dv, "rv": rv, "det": det, "rec": rec,
            "thresholds": thresholds}


def _args(s):
    inv = torch.ones(B)
    ext = torch.tensor([[H, W]] * B, dtype=torch.float32)
    return torch.from_numpy(s["canv"]), torch.from_numpy(s["gray"]), inv, ext


@pytest.mark.parametrize("stages,dtype", [("tail,s2d", torch.float32), ("tail,s2d", torch.bfloat16),
                                          ("none", torch.float32)])
def test_mesh_equals_unsharded(serving, stages, dtype):
    cfg = Config(**TINY, **serving["thresholds"], fused_stages=stages)
    mesh = make_mesh(2, 1, ["cpu", "cpu"])
    sharded = BatchedOCR(cfg, serving["det"], serving["rec"], 4, dtype, device="cpu", mesh=mesh)
    plain = BatchedOCR(cfg, serving["det"], serving["rec"], 4, dtype, device="cpu")
    assert len(sharded.replicas) == 2 and sharded.replicas[1].det_net is not sharded.det_net
    got, want = sharded(*_args(serving)), plain(*_args(serving))
    sharded.close()
    assert want["valid"].any()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_mesh_equals_jax_batched_ocr(serving):
    """Both meshes of two devices, float32, the plain detector."""
    cfg = dict(**TINY, **serving["thresholds"])
    jocr = JBatchedOCR(JConfig(**cfg), serving["dv"], serving["rv"], boxes_per_image=4,
                       dtype=jnp.float32, mesh=jmake_mesh(2, 1, jax.devices()[:2]))
    want = jax.tree.map(np.asarray, jocr(jnp.asarray(serving["canv"]), jnp.asarray(serving["gray"])))
    ocr = BatchedOCR(Config(**cfg, fused_stages="none"), serving["det"], serving["rec"], 4,
                     torch.float32, device="cpu", mesh=make_mesh(2, 1, ["cpu", "cpu"]))
    got = {k: v.numpy() for k, v in ocr(*_args(serving)).items()}
    ocr.close()
    valid = want["valid"]
    assert valid.any()
    np.testing.assert_array_equal(got["valid"], valid)
    assert np.abs(got["rects"] - want["rects"]).max() <= 1.0
    np.testing.assert_array_equal(got["pred_idx"][valid], want["pred_idx"][valid])
    np.testing.assert_allclose(got["confidence"][valid], want["confidence"][valid], atol=1e-4)


def test_mesh_run_images_and_refusals(serving):
    """``run_images`` over a mesh pads each group to a multiple of the data
    axis (3 images -> 4 rows) and answers as the unsharded program; a batch
    the data axis does not divide raises; a 2x2 mesh (a model axis, whose
    devices repeat the rows of their data index in the JAX program) keeps
    one replica a data index and equals the unsharded program."""
    cfg = Config(**TINY, **serving["thresholds"], canvas_size=128, bucket_granularity=32)
    g = torch.Generator().manual_seed(0)
    det = init_module(VGG_UNet(), g).state_dict()
    rec = init_module(CRNNet(cfg), g).state_dict()
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 255, (70 + 8 * i, 60, 3)).astype(np.uint8) for i in range(3)]
    sharded = BatchedOCR(cfg, det, rec, 4, torch.float32, device="cpu",
                         mesh=make_mesh(2, 1, ["cpu", "cpu"]))
    plain = BatchedOCR(cfg, det, rec, 4, torch.float32, device="cpu")
    assert sharded.run_images(images) == plain.run_images(images)
    with pytest.raises(ValueError, match="does not evenly divide 3"):
        sharded(*(a[:3] for a in _args(serving)))
    sharded.close()
    model_axis = BatchedOCR(cfg, det, rec, 4, torch.float32, device="cpu",
                            mesh=make_mesh(2, 2, ["cpu"] * 4))
    assert len(model_axis.replicas) == 2
    got, want = model_axis(*_args(serving)), plain(*_args(serving))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert model_axis.run_images(images) == plain.run_images(images)
    model_axis.close()
    assert model_axis.pool is None


# -- processes -------------------------------------------------------------------

def test_backend_choice():
    assert backend_for([torch.device("cpu")] * 2) == "gloo"
    assert backend_for([torch.device("cuda", 0)] * 2) == "gloo"  # NCCL refuses two ranks a card
    assert backend_for([torch.device("cuda", 0), torch.device("cuda", 1)]) == "nccl"


def test_world_size_one_is_the_single_device_step_bit_for_bit():
    """A gloo group of one process runs its gradient and loss all-reduces
    and the single-device code: the CTC step and the CRAFT step (slice1
    frozen) give the same numbers bit for bit."""
    cfg = Config(**{**TINY, "prediction": "CTC", "transform": "None"}, height=32, width=64, adam=True,
                 lr=1e-3)
    sd = init_train_params(CRNNet(cfg), torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(2)
    batch = {"images": torch.from_numpy(rng.standard_normal((2, 32, 64, 1))),
             "labels": torch.tensor([[1, 2, 3, 0], [4, 5, 0, 0]]), "lengths": torch.tensor([3, 2])}
    csd = init_train_params(VGG_UNet(), torch.Generator().manual_seed(1)).state_dict()
    cb = {k: torch.from_numpy(v).double() for k, v in craft.synthesize_batch(rng, 2, 32, 32).items()}
    cases = {"ctc": ("crnn", {"cfg": cfg, "init": sd, "batch": batch}),
             "craft": ("craft", {"init": csd, "batch": cb, "freeze": ("slice1",)})}
    one = spawn(torch_dp_workers.run_cases, (cases,), ["cpu"])
    alone = torch_dp_workers.run_cases(cases, torch.device("cpu"))
    for name in cases:
        assert one[name]["loss"] == alone[name]["loss"], name
        assert one[name]["grad_norm"] == alone[name]["grad_norm"], name
        for k, v in alone[name]["state"].items():
            assert torch.equal(one[name]["state"][k], v), (name, k)


def test_train_craft_data_parallel_matches_one_process(tmp_path):
    """``train_craft(group=...)`` over two ranks: each takes its half of the
    same seeded global batches; the first loss equals one process's on the
    whole batch (float32, 1e-5 relative; later ones drift apart in float32,
    where the global BatchNorm takes flax's E[x^2] - E[x]^2 and one process
    torch's two-pass variance), and rank 0 alone writes the checkpoint."""
    kw = dict(num_steps=2, batch=2, height=32, width=32, log_every=0)
    alone = craft.train_craft(**kw, device="cpu")[2]
    got = spawn(torch_dp_workers.craft_training, ({**kw, "checkpoint_dir": str(tmp_path / "two")},),
                ["cpu", "cpu"])
    assert len(got) == 2 and np.isfinite(got).all()
    np.testing.assert_allclose(got[0], alone[0], rtol=1e-5)
    assert os.listdir(tmp_path / "two") == ["2"]


def test_trainer_over_two_ranks_logs_once_and_resumes(tmp_path):
    """The CRNN trainer's ranks (``train_rank`` under ``spawn``): 4 steps
    with a checkpoint every 2, one set of logs and checkpoints (rank 0's),
    each checkpoint the full state; a second run resumes from them to step
    6."""
    from lightly_ocr_tpu.data import generator as jgen
    from lightly_ocr_tpu_torch.train.trainer import train_rank
    from lightly_ocr_tpu_torch.utils import checkpoint as ckpt

    train, val = str(tmp_path / "t.lor"), str(tmp_path / "v.lor")
    jgen.synthesize_words(train, n=16, charset="abcdefghij", max_len=5, seed=1)
    jgen.synthesize_words(val, n=4, charset="abcdefghij", max_len=5, seed=2)
    base = dict(output_channel=32, hidden_size=16, batch_max_len=8, character="abcdefghij",
                prediction="CTC", transform="None", batch_size=4, adam=True, lr=1e-3, workers=1,
                train_root=train, val_root=val, val_interval=2, save_interval=2, max_iter=1)
    cfg = Config(**base, num_iters=4, log_dir=str(tmp_path / "dp"))
    spawn(train_rank, (cfg,), ["cpu", "cpu"])
    assert sorted(os.listdir(tmp_path / "dp" / "checkpoints")) == ["2", "4"]
    text = (tmp_path / "dp" / "log_train.txt").read_text()
    assert text.count("[2/4] train_loss:") == 1 and text.count("[4/4] train_loss:") == 1
    resumed = cfg.replace(saved_model_path=str(tmp_path / "dp" / "checkpoints"), num_iters=6)
    spawn(train_rank, (resumed,), ["cpu", "cpu"])
    assert sorted(os.listdir(tmp_path / "dp" / "checkpoints")) == ["2", "4", "6"]
    dp, step = ckpt.load_state_file(str(tmp_path / "dp" / "checkpoints"), 6)
    assert step == dp["step"] == 6
    assert dp["model"].keys() == CRNNet(cfg).state_dict().keys()
    assert all(torch.isfinite(v).all() for v in dp["model"].values())
    assert json.loads((tmp_path / "dp" / "best.json").read_text())["step"] in (2, 4, 6)
