"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode; their plain versions are held against the JAX
package in ``test_torch_seam_tail.py`` and ``test_torch_cc.py``).  This
file imports nothing of JAX, so it runs on the card's machine, which has
no JAX, without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from lightly_ocr_tpu_torch.models.layers import init_module
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.ops import cc
from lightly_ocr_tpu_torch.ops import seam_tail as st

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(2, 48, 32), (1, 30, 50), (3, 2, 2)])
def test_seam_tail_kernel_matches_plain(cuda_device, shape):
    """Even H2, W2 of any size, including a single 2x2 map (every pixel
    an edge pixel); tolerance relative to the scores, as in chip_smoke."""
    B, H2, W2 = shape
    net = init_module(VGG_UNet(), torch.Generator().manual_seed(1))
    p = st.tail_params(net, torch.bfloat16)
    p = type(p)(*(a.to(cuda_device) for a in p))
    g = torch.Generator().manual_seed(0)
    ya = torch.randn(B, H2 // 2, W2 // 2, 64, generator=g).to(cuda_device)
    t = torch.randn(B, H2, W2, 128, generator=g).to(cuda_device, torch.bfloat16)
    n = st.seam_tail.launches
    got = st.seam_tail(ya, t, p)
    torch.cuda.synchronize()
    assert st.seam_tail.launches == n + 1
    ref = st.seam_tail_plain(ya, t, p)
    assert got.shape == ref.shape == (B, H2, 2, W2)
    assert (got - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()


def test_seam_tail_kernel_rejects_bad_input(cuda_device):
    net = init_module(VGG_UNet(), torch.Generator().manual_seed(1))
    p = st.tail_params(net, torch.bfloat16)
    p = type(p)(*(a.to(cuda_device) for a in p))
    ya = torch.zeros(1, 4, 4, 64, device=cuda_device)
    with pytest.raises(ValueError):
        st.seam_tail(ya, torch.zeros(1, 8, 8, 128, device=cuda_device), p)  # f32 t
    with pytest.raises(ValueError):
        st.seam_tail(ya, torch.zeros(1, 8, 9, 128, device=cuda_device,
                                     dtype=torch.bfloat16), p)  # odd width


@pytest.mark.parametrize("case", ["random", "dense", "spiral", "comb", "batch", "empty"])
def test_cc_kernel_matches_plain(cuda_device, case):
    r = np.random.default_rng(7)
    mask = {
        "random": r.random((1, 96, 80)) > 0.45,
        "dense": r.random((2, 480, 320)) > 0.3,
        "spiral": cc.spiral_mask(480, 320)[None],
        "comb": cc.comb_mask(128, 256)[None],
        "batch": r.random((4, 48, 64)) > 0.5,
        "empty": np.zeros((2, 16, 16), bool),
    }[case]
    fg = torch.from_numpy(mask).to(cuda_device)
    n = cc.label_components.launches
    got = cc.label_components(fg)
    torch.cuda.synchronize()
    assert cc.label_components.launches == n + 1
    assert torch.equal(got, cc.label_components_plain(fg))
    assert cc.labels_converged(fg, got)
