"""``torch.export`` of the port vs its eager modules and the JAX package's
StableHLO export (CPU).

The tiny recognizers of ``tests/test_export.py`` (CTC with TPS, the op that
broke the reference's ONNX export; and Attention with TPS, whose greedy
loop unrolls) and the plain ``VGG_UNet`` at 64x64, on weights from the JAX
init carried across by ``weights.py``: the port's program, saved and
loaded, gives its eager module's output within 1e-6, and the JAX export's
restored ``.call`` on the same input within 1e-4 (float32; the detector's
scores relative to their largest value).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightly_ocr_tpu.config import Config as JConfig
from lightly_ocr_tpu.export import export_craft as jexport_craft
from lightly_ocr_tpu.export import export_crnn as jexport_crnn
from lightly_ocr_tpu.export import load_exported as jload
from lightly_ocr_tpu.export import save_exported as jsave
from lightly_ocr_tpu.models.crnn import CRNNet as JCRNNet
from lightly_ocr_tpu.models.vgg_unet import VGG_UNet as JVGG_UNet
from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.export import export_craft, export_crnn, load_exported, main, save_exported
from lightly_ocr_tpu_torch.models.crnn import CRNNet
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.weights import state_dict_from_variables

TINY = dict(transform="TPS", output_channel=64, hidden_size=32, width=64, num_fiducial=8,
            character="abcdef")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_roundtrip(exported, path, x):
    jsave(exported, path)
    out = jload(path).call(jnp.asarray(x))
    return np.asarray(out[0] if isinstance(out, (tuple, list)) else out)


@pytest.mark.parametrize("head,shape", [("CTC", (2, 17, 7)), ("Attention", (2, 26, 8))])
def test_crnn_export_roundtrip(tmp_path, head, shape):
    jcfg, cfg = JConfig(**TINY, prediction=head), Config(**TINY, prediction=head)
    v = jax.tree.map(np.asarray, jax.jit(lambda r: JCRNNet(jcfg).init(
        r, jnp.zeros((2, 32, 64, 1)), None, False))(jax.random.key(0)))
    x = np.random.default_rng(0).standard_normal((2, 32, 64, 1)).astype(np.float32)

    exported, example = export_crnn(cfg, state_dict_from_variables(v), batch=2, device="cpu")
    assert example[0].shape == (2, 32, 64, 1)
    save_exported(exported, str(tmp_path / "crnn.pt2"))
    restored = load_exported(str(tmp_path / "crnn.pt2"))
    with torch.no_grad():
        got = restored.module()(torch.from_numpy(x)).numpy()
        net = CRNNet(cfg)
        net.load_state_dict(state_dict_from_variables(v), strict=True)
        eager = net.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == shape
    np.testing.assert_allclose(got, eager, atol=1e-6, rtol=1e-6)

    jexp, _ = jexport_crnn(jcfg, v, batch=2)
    want = _jax_roundtrip(jexp, str(tmp_path / "crnn.shlo"), x)
    assert want.shape == shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_craft_export_roundtrip(tmp_path):
    v = jax.tree.map(np.asarray, jax.jit(JVGG_UNet().init)(jax.random.key(0), jnp.zeros((1, 64, 64, 3))))
    x = np.random.default_rng(1).standard_normal((1, 64, 64, 3)).astype(np.float32)
    sd = state_dict_from_variables(v)
    exported, _ = export_craft(state_dict=sd, batch=1, height=64, width=64, device="cpu")
    save_exported(exported, str(tmp_path / "craft.pt2"))
    with torch.no_grad():
        got = load_exported(str(tmp_path / "craft.pt2")).module()(torch.from_numpy(x))[0].numpy()
        net = VGG_UNet()
        net.load_state_dict(sd, strict=True)
        eager = net.eval()(torch.from_numpy(x))[0].numpy()
    assert got.shape == (1, 32, 32, 2)
    np.testing.assert_allclose(got, eager, atol=1e-6, rtol=1e-6)
    jexp, _ = jexport_craft(variables=v, batch=1, height=64, width=64)
    want = _jax_roundtrip(jexp, str(tmp_path / "craft.shlo"), x)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_cli_prints_the_jax_line(tmp_path, capsys):
    """``python -m lightly_ocr_tpu_torch.export`` saves, reloads, runs the
    program and prints the JAX CLI's line; the default device is the card."""
    out = str(tmp_path / "m" / "craft.pt2")
    assert main(["CRAFT", out, "--height", "64", "--width", "64", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip()
    assert line.startswith(f"exported CRAFT -> {out} (") and line.endswith("bytes), output (1, 32, 32, 2)")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["CRAFT", out])
