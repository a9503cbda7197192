"""The beam decodes on the card vs the same decodes on the CPU.

Marked ``cuda``; skips without a CUDA device.  Imports nothing of JAX (the
CPU side is held to the JAX package in ``test_torch_beam.py``), so it runs
on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_beam_cuda.py

The top beam's labels must be equal and its score within 1e-4, float32 with
TF32 off.  The card's ``scatter_add`` sums in another order than the CPU's,
so scores agree to round-off, not bit for bit.
"""
import numpy as np
import pytest
import torch

from lightly_ocr_tpu_torch.models.attention import Attention
from lightly_ocr_tpu_torch.models.layers import init_module
from lightly_ocr_tpu_torch.ops.ctc import ctc_beam_search_decode

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("W,C,with_lm", [(8, 38, True), (8, 38, False), (4, 11, True), (9, 2, False)],
                         ids=["w8_lm", "w8", "w4_lm", "w9_wider_than_classes"])
def test_ctc_beam_card_equals_cpu(cuda_device, W, C, with_lm):
    rng = np.random.default_rng(W + C)
    logits = torch.from_numpy((4.0 * rng.standard_normal((64, 26, C))).astype(np.float32))
    lm = torch.from_numpy(rng.standard_normal((C, C)).astype(np.float32)) if with_lm else None
    ref = ctc_beam_search_decode(logits, beam_width=W, lm=lm)
    got = ctc_beam_search_decode(logits.to(cuda_device), beam_width=W,
                                 lm=None if lm is None else lm.to(cuda_device))
    labels, lengths, scores = (a.cpu() for a in got)
    assert torch.equal(labels[:, 0], ref[0][:, 0]) and torch.equal(lengths[:, 0], ref[1][:, 0])
    torch.testing.assert_close(scores[:, 0], ref[2][:, 0], rtol=0, atol=1e-4)


@pytest.mark.parametrize("W,with_lm", [(8, True), (1, False)], ids=["w8_lm", "w1"])
def test_attention_beam_card_equals_cpu(cuda_device, W, with_lm):
    C = 38
    g = torch.Generator().manual_seed(W)
    net = init_module(Attention(64, 64, C, 26), g).eval()
    with torch.no_grad():
        net.generator.bias[1] -= 3.0  # EOS less likely: beams of some length
    feats = torch.randn(32, 26, 64, generator=g)
    lm = torch.randn(C, C, generator=g) if with_lm else None
    with torch.no_grad():
        ref = net(feats, W, lm)
        got = net.to(cuda_device)(feats.to(cuda_device), W, None if lm is None else lm.to(cuda_device))
    assert (ref[0][:, 0, 0] != 1).any()  # not every top beam stops at once
    assert torch.equal(got[0][:, 0].cpu(), ref[0][:, 0])
    torch.testing.assert_close(got[1][:, 0].cpu(), ref[1][:, 0], rtol=0, atol=1e-4)
