"""The port's public names: every name that an ``__init__`` of the JAX
package exports has its counterpart in the port's package of the same
name, and the functions this surface added equal the JAX package's.

The JAX lists are read with ``ast`` from ``lightly_ocr_tpu/**/__init__.py``
(nothing of the JAX package is imported for them).  A counterpart is the
same name, or the port's name of ``RENAMED`` (ROADMAP.md, "Counterparts
that are not files of the same name").
"""
import ast
import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_ocr_tpu import config as jconfig
from lightly_ocr_tpu.ops import crop as jcrop
from lightly_ocr_tpu.ops.grid_sample import affine_grid as jaffine_grid
from lightly_ocr_tpu.ops.grid_sample import grid_sample as jgrid_sample
from lightly_ocr_tpu.ops import image as jimage
from lightly_ocr_tpu_torch import config
from lightly_ocr_tpu_torch.ops import crop, image
from lightly_ocr_tpu_torch.ops.grid_sample import affine_grid, grid_sample

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "lightly_ocr_tpu"
# JAX package name -> the port's name for the same thing
RENAMED = {"shard_variables": "shard_module", "batch_sharding": "shard_batch"}


def jax_exports() -> list[tuple[str, str]]:
    """(package relative to the top, name) for every name the JAX package's
    ``__init__`` files import, and so export."""
    out = []
    for init in sorted(JAX_PKG.rglob("__init__.py")):
        rel = init.parent.relative_to(JAX_PKG).as_posix()
        pkg = "" if rel == "." else rel.replace("/", ".")
        for node in ast.parse(init.read_text()).body:
            if isinstance(node, ast.ImportFrom) and node.module.startswith("lightly_ocr_tpu"):
                out += [(pkg, a.asname or a.name) for a in node.names]
    return out


EXPORTS = jax_exports()


def test_the_jax_lists_were_read():
    pkgs = {p for p, _ in EXPORTS}
    assert {"", "models", "ops", "data", "parallel", "serving", "text", "train", "utils"} <= pkgs
    assert ("models", "init_crnn") in EXPORTS and ("ops", "grid_sample") in EXPORTS


@pytest.mark.parametrize("pkg,name", EXPORTS, ids=[f"{p or 'top'}.{n}" for p, n in EXPORTS])
def test_counterpart_is_exported(pkg, name):
    mod = importlib.import_module("lightly_ocr_tpu_torch" + (f".{pkg}" if pkg else ""))
    assert hasattr(mod, RENAMED.get(name, name)), f"{pkg}.{name}"


def test_public_names_import_without_jax():
    """Every counterpart imports where JAX, the JAX package, pyyaml and PIL
    cannot (the card's installation), and leaves no JAX module loaded."""
    blocked = ["jax", "jaxlib", "flax", "optax", "orbax", "yaml", "PIL", "cv2", "flask", "lmdb",
               "lightly_ocr_tpu"]
    lines = [f"for name in {blocked!r}:", "    sys.modules[name] = None",
             "from lightly_ocr_tpu_torch import Config, load_config"]
    lines += [f"from lightly_ocr_tpu_torch{'.' + p if p else ''} import {RENAMED.get(n, n)}"
              for p, n in EXPORTS]
    lines += ["assert not any(m == 'jax' or m.startswith('jax.') for m, v in sys.modules.items() if v)",
              "print('imported')"]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", "import sys\n" + "\n".join(lines)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


# -- the functions of this surface against the JAX package's ---------------------

RTOL = 2e-5  # float32 round-off, relative to the largest value


def close(got, want, rtol=RTOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got.astype(np.float64) - want).max()) <= rtol * scale


def rects(rng, k, h, w):
    """[k, 4] (row0, col0, row1, col1) inside an h x w image, float32."""
    y0 = rng.uniform(0, h - 4, k)
    x0 = rng.uniform(0, w - 4, k)
    return np.stack([y0, x0, y0 + rng.uniform(2, h - y0), x0 + rng.uniform(2, w - x0)], 1).astype(np.float32)


def test_adjust_box_coordinates_matches_jax():
    boxes = np.random.default_rng(0).uniform(0, 200, (5, 4, 2)).astype(np.float32)
    close(image.adjust_box_coordinates(torch.from_numpy(boxes), 1.7, 0.6),
          jimage.adjust_box_coordinates(jnp.asarray(boxes), 1.7, 0.6))
    close(image.adjust_box_coordinates(boxes, 0.5, 2.0, ratio_net=1.0),
          jimage.adjust_box_coordinates(jnp.asarray(boxes), 0.5, 2.0, ratio_net=1.0))


@pytest.mark.parametrize("kernel", ["triangle", "cubic"])
def test_crop_resize_matmul_matches_jax(kernel):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (48, 80)).astype(np.float32)
    r = rects(rng, 6, 48, 80)
    close(crop.crop_resize_matmul(torch.from_numpy(img), torch.from_numpy(r), 16, 40, kernel),
          jcrop.crop_resize_matmul(jnp.asarray(img), jnp.asarray(r), 16, 40, kernel))


@pytest.mark.parametrize("supersample", [1, 2, 3])
def test_crop_resize_batch_matches_jax(supersample):
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (40, 64)).astype(np.float32)
    r = rects(rng, 5, 40, 64)
    close(crop.crop_resize_batch(torch.from_numpy(img), torch.from_numpy(r), 16, 32, supersample),
          jcrop.crop_resize_batch(jnp.asarray(img), jnp.asarray(r), 16, 32, supersample))
    close(crop.crop_resize_normalize_batch(torch.from_numpy(img), torch.from_numpy(r), 16, 32, supersample),
          jcrop.crop_resize_normalize_batch(jnp.asarray(img), jnp.asarray(r), 16, 32, supersample))


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_matches_jax(padding_mode, mode, align_corners):
    rng = np.random.default_rng(3)
    img = rng.standard_normal((2, 9, 13, 3)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 5, 7, 2)).astype(np.float32)
    got = grid_sample(torch.from_numpy(img), torch.from_numpy(grid), padding_mode, align_corners, mode)
    want = jgrid_sample(jnp.asarray(img), jnp.asarray(grid), padding_mode, align_corners, mode)
    if mode == "nearest":  # a coordinate within round-off of .5 may round either way
        assert float(np.mean(got.numpy() == np.asarray(want))) >= 0.97
    else:
        close(got, want)


def test_grid_sample_promotes_bf16_as_jax_and_refuses_bad_input():
    rng = np.random.default_rng(4)
    img = rng.standard_normal((1, 6, 8, 2)).astype(np.float32)
    grid = rng.uniform(-1, 1, (1, 3, 4, 2)).astype(np.float32)
    got = grid_sample(torch.from_numpy(img).bfloat16(), torch.from_numpy(grid).bfloat16())
    want = jgrid_sample(jnp.asarray(img, jnp.bfloat16), jnp.asarray(grid, jnp.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    close(got, want)
    with pytest.raises(ValueError):
        grid_sample(torch.zeros(1, 4, 4), torch.zeros(1, 2, 2, 2))
    with pytest.raises(ValueError):
        grid_sample(torch.zeros(1, 4, 4, 1), torch.zeros(1, 2, 2, 2), padding_mode="reflection")


def test_affine_grid_matches_jax():
    theta = np.random.default_rng(5).standard_normal((3, 2, 3)).astype(np.float32)
    close(affine_grid(torch.from_numpy(theta), 7, 11), jaffine_grid(jnp.asarray(theta), 7, 11))


@pytest.mark.parametrize("with_yaml", [True, False])
def test_save_config_round_trips(tmp_path, monkeypatch, with_yaml):
    """``save_config`` writes YAML (JSON where pyyaml is missing, as on the
    card) and ``load_config`` reads it back; the JAX package reads the
    YAML file too."""
    if not with_yaml:
        monkeypatch.setitem(sys.modules, "yaml", None)
    cfg = config.Config(prediction="CTC", transform="None", hidden_size=128, character="0123456789",
                        fused_stages="tail,stem", mesh_model=2, lr=0.25)
    path = tmp_path / "c.yml"
    config.save_config(cfg, str(path))
    assert config.load_config(str(path)) == cfg
    if with_yaml:
        assert dataclasses.asdict(jconfig.load_config(str(path))) == dataclasses.asdict(cfg)
    else:
        assert path.read_text().lstrip().startswith("{")
