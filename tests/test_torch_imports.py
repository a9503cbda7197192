"""The PyTorch port imports nothing the card's installation lacks.

The card has torch, triton, numpy, scipy, einops, pytest and hypothesis,
and no jax, flax, orbax, pyyaml or PIL.  Every module of the port, and
``chip_smoke.py`` with the modules it imports, must import in a process
where those names (and the JAX package) are blocked.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "lightly_ocr_tpu_torch"
BLOCKED = ["jax", "jaxlib", "flax", "optax", "orbax", "yaml", "PIL", "cv2", "flask",
           "lmdb", "lightly_ocr_tpu"]

_GUARD = """
import sys
for name in {blocked!r}:
    sys.modules[name] = None
import importlib, pkgutil
import lightly_ocr_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(lightly_ocr_tpu_torch.__path__,
                                              "lightly_ocr_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
for m in ("engines", "pipeline", "ops.poly", "ops.ctc", "serving.server", "serving.ingress",
          "serving.upload", "train.trainer", "train.train_step", "data.records", "data.loader",
          "data.generator", "data.lmdb_compat", "utils.checkpoint", "utils.metrics", "train.craft",
          "train.pseudo_labels", "compat"):
    assert "lightly_ocr_tpu_torch." + m in mods, m
import chip_smoke
from lightly_ocr_tpu_torch.serving.server import (BatchedServeModel, InferenceWorker, create_app,
                                                  main, run_server)
from lightly_ocr_tpu_torch.serving.ingress import create_ingress_app
from lightly_ocr_tpu_torch.serving.upload import decode_upload
from lightly_ocr_tpu_torch.ops.ctc import ctc_beam_search_decode
from lightly_ocr_tpu_torch.models.decode import load_lm_prior
from lightly_ocr_tpu_torch.train.trainer import Trainer, build_loaders, main
from lightly_ocr_tpu_torch.data.loader import DataLoader, resize_bicubic_uint8
from lightly_ocr_tpu_torch.data.records import RecordDataset, decode_image
from lightly_ocr_tpu_torch.data.generator import synthesize_words
from lightly_ocr_tpu_torch.data.records import encode_png
from lightly_ocr_tpu_torch.train.craft import init_craft_state, main, train_craft
from lightly_ocr_tpu_torch.train.pseudo_labels import batches_from_records, write_detection_records
from lightly_ocr_tpu_torch.compat import getDetBoxes, resizeAspectRatio, CRAFT, loadImage
assert "jax" not in sys.modules or sys.modules["jax"] is None
print("imported", len(mods))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env.pop("JAX_PLATFORMS", None)
    return env


def test_port_imports_with_jax_yaml_pil_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _GUARD.format(blocked=BLOCKED)],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=240,
    )
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


def test_no_jax_or_jax_package_import_lines():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|lightly_ocr_tpu(\.|\s|$))")
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [f"{f}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1) if pat.match(line)]
    assert not bad


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_a_card_or_the_program(where, tmp_path):
    """No CUDA device here: the script exits non-zero and prints no result,
    in the checkout and as a lone copy."""
    cwd = ROOT
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
        cwd = tmp_path
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
