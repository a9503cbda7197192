"""Weight bridge of the PyTorch port: JAX variables -> torch state dict.

The JAX exporter (``utils/torch_import.py::export_torch_state_dict``) and the
port's own copy of its key rule must agree key for key and value for value,
and the result must load into the port's modules with ``strict=True``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_ocr_tpu.config import Config as JConfig
from lightly_ocr_tpu.models.crnn import CRNNet as JCRNNet
from lightly_ocr_tpu.models.vgg_unet import VGG_UNet as JVGG_UNet
from lightly_ocr_tpu.utils.torch_import import export_torch_state_dict
from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.models.crnn import CRNNet
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.weights import state_dict_from_variables

_SMALL = dict(output_channel=64, hidden_size=32, character="abcdefghij",
              batch_max_len=8)


def _detector_vars():
    return JVGG_UNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))


def _recognizer_vars(**kw):
    cfg = JConfig(**{**_SMALL, **kw})
    v = JCRNNet(cfg).init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 100, 1)),
                          None, False)
    return cfg, v


@pytest.mark.parametrize("which", ["detector", "recognizer_tps", "recognizer_plain"])
def test_exporter_output_loads_strict(which):
    if which == "detector":
        v, module = _detector_vars(), VGG_UNet()
    else:
        kw = {"transform": "TPS" if which == "recognizer_tps" else "None"}
        _, v = _recognizer_vars(**kw)
        module = CRNNet(Config(**{**_SMALL, **kw}))
    exported = export_torch_state_dict(v)
    ours = state_dict_from_variables(jax.tree.map(np.asarray, v))
    assert exported.keys() == ours.keys()
    for k, arr in exported.items():
        np.testing.assert_array_equal(ours[k].numpy(), arr, err_msg=k)
    # the exporter's numpy output, as tensors, loads strictly
    module.load_state_dict({k: torch.tensor(np.asarray(a)) for k, a in exported.items()},
                           strict=True)
    assert set(module.state_dict()) == set(exported)


def test_layout_rules():
    """OIHW conv kernels, [out, in] dense kernels, BN stats renamed, LSTM
    tensors copied unchanged (torch layout, gate order i, f, g, o)."""
    cfg, v = _recognizer_vars()
    sd = state_dict_from_variables(jax.tree.map(np.asarray, v))
    p, bs = v["params"], v["batch_stats"]
    k = np.asarray(p["FeatureExtraction"]["ConvNet"]["conv0_1"]["kernel"])
    np.testing.assert_array_equal(
        sd["FeatureExtraction.ConvNet.conv0_1.weight"].numpy(), k.transpose(3, 2, 0, 1))
    d = np.asarray(p["Prediction"]["generator"]["kernel"])
    np.testing.assert_array_equal(sd["Prediction.generator.weight"].numpy(), d.T)
    m = np.asarray(bs["FeatureExtraction"]["ConvNet"]["bn0_1"]["var"])
    np.testing.assert_array_equal(
        sd["FeatureExtraction.ConvNet.bn0_1.running_var"].numpy(), m)
    w = np.asarray(p["SequenceModeling"]["0"]["rnn"]["weight_ih_l0"])
    np.testing.assert_array_equal(sd["SequenceModeling.0.rnn.weight_ih_l0"].numpy(), w)
    w = np.asarray(p["Prediction"]["attention_cell"]["rnn"]["weight_hh"])
    np.testing.assert_array_equal(sd["Prediction.attention_cell.rnn.weight_hh"].numpy(), w)
