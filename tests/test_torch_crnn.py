"""CRNN recognizer of the PyTorch port vs ``CRNNet.apply`` (float32, CPU).

Attention head, greedy decode, with and without the TPS rectifier; BN
statistics, biases and the TPS fiducial head are perturbed by seeded noise
so that every layer, the warp and the decode feedback are exercised.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_ocr_tpu.config import Config as JConfig
from lightly_ocr_tpu.models.crnn import CRNNet as JCRNNet
from lightly_ocr_tpu.models.decode import decode_preds as jdecode
from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.models.crnn import CRNNet
from lightly_ocr_tpu_torch.models.decode import decode_preds
from lightly_ocr_tpu_torch.weights import state_dict_from_variables

_SMALL = dict(output_channel=64, hidden_size=32, character="abcdefghij",
              batch_max_len=8)


def perturbed_recognizer(transform, seed=0):
    jcfg = JConfig(transform=transform, **_SMALL)
    v = JCRNNet(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 100, 1)), None, False)
    v = jax.tree.map(np.asarray, v)
    rng = np.random.default_rng(seed)

    def walk(tree, path=()):
        out = {}
        for k, x in tree.items():
            if isinstance(x, dict):
                out[k] = walk(x, path + (k,))
            elif k == "mean" or (k == "bias" and "localization_fc2" not in path):
                out[k] = (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)
            elif k in ("scale", "var"):
                out[k] = (x * rng.uniform(0.8, 1.2, x.shape)).astype(np.float32)
            elif k == "kernel" and "localization_fc2" in path:
                out[k] = (0.05 * rng.standard_normal(x.shape)).astype(np.float32)
            else:
                out[k] = x
        return out

    return jcfg, walk(v)


@pytest.mark.parametrize("transform", ["TPS", "None"])
def test_crnn_matches_jax_f32(transform):
    jcfg, v = perturbed_recognizer(transform)
    net = CRNNet(Config(transform=transform, **_SMALL))
    net.load_state_dict(state_dict_from_variables(v), strict=True)
    x = np.random.default_rng(1).uniform(-1, 1, (4, 32, 100, 1)).astype(np.float32)
    ref = np.asarray(JCRNNet(jcfg).apply(v, jnp.asarray(x), None, False))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x))
    assert got.shape == ref.shape == (4, jcfg.num_steps, jcfg.derived_num_classes)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)

    idx, conf = decode_preds(got, Config(transform=transform, **_SMALL))
    jidx, jconf = jdecode(jnp.asarray(ref), jcfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), rtol=1e-5, atol=1e-7)


def test_decode_confidence_rules():
    """Product of step maxima strictly before the first EOS; 0 without EOS."""
    cfg = Config(**_SMALL)
    C = cfg.derived_num_classes
    preds = torch.full((2, 4, C), -5.0)
    preds[0, 0, 3] = preds[0, 1, 4] = preds[0, 2, 1] = preds[0, 3, 5] = 5.0  # x y EOS z
    preds[1, :, 2] = 5.0  # never EOS
    idx, conf = decode_preds(preds, cfg)
    p = torch.softmax(preds[0, 0], 0).max()
    torch.testing.assert_close(conf[0], p * p)
    assert conf[1].item() == 0.0
    assert idx[0].tolist() == [3, 4, 1, 5]
