"""The port's reference-name surface (``lightly_ocr_tpu_torch.compat``) vs
the JAX package's (``lightly_ocr_tpu.compat``, ``tests/test_compat.py``):
every name imports, and the numpy adapters give the same answers on the
same inputs."""
import types

import numpy as np
import pytest

from lightly_ocr_tpu import compat as jcompat
from lightly_ocr_tpu_torch import compat


def _public(mod) -> list[str]:
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and n != "annotations" and not isinstance(v, types.ModuleType))


# the reference's public names (tests/test_compat.py)
REFERENCE = ["CRAFT", "CRNN", "prepModel", "getText", "serveModel", "calcTime", "copyStateDict",
             "compare_rects", "VGG_UNet", "CRNNet", "TPS_STN", "Attention", "BidirectionalLSTM",
             "ResNet50v2", "UpConv", "vgg16_bn", "resizeAspectRatio", "normalizeMeanVariance",
             "denormalizeMeanVariance", "getDetBoxes", "adjustResultCoordinates", "CTCLabelConverter",
             "AttnLabelConverter", "Averager", "edit_distance", "AlignCollate", "RandomSequentialSampler",
             "LMDBDataset", "loadImage", "anno2list", "DatasetGenerator", "checkImgValid"]


def test_every_reference_name_imports():
    names = _public(jcompat)
    assert set(REFERENCE) <= set(names)
    missing = [n for n in names if not hasattr(compat, n)]
    assert not missing
    for n in ("CRAFT", "CRNN", "VGG_UNet", "CRNNet", "AlignCollate", "LMDBDataset"):
        assert getattr(compat, n).__module__.startswith("lightly_ocr_tpu_torch."), n
    assert compat.vgg16_bn.__name__ == "VggBackbone"
    assert compat.LMDBDataset.__name__ == "RecordDataset"
    assert compat.DatasetGenerator.__name__ == "build_records"


@pytest.mark.parametrize("shape,square,mag", [((100, 80, 3), 1280, 1.5), ((37, 91, 3), 64, 1.0),
                                              ((300, 200, 3), 160, 2.0)])
def test_resize_aspect_ratio_matches_jax(shape, square, mag):
    img = np.random.default_rng(sum(shape)).integers(0, 255, shape).astype(np.float32)
    canvas, ratio, heat = compat.resizeAspectRatio(img, square, mag_ratio=mag)
    jcanvas, jratio, jheat = jcompat.resizeAspectRatio(img, square, mag_ratio=mag)
    assert canvas.shape == jcanvas.shape and canvas.dtype == np.float32
    assert ratio == jratio and heat == jheat
    np.testing.assert_allclose(canvas, jcanvas, atol=1e-3)


def test_normalize_round_trip_matches_jax():
    img = np.random.default_rng(1).integers(0, 255, (8, 9, 3)).astype(np.float32)
    normed = compat.normalizeMeanVariance(img)
    assert isinstance(normed, np.ndarray)
    np.testing.assert_allclose(normed, jcompat.normalizeMeanVariance(img), rtol=1e-6, atol=1e-6)
    back = compat.denormalizeMeanVariance(normed)
    assert back.dtype == np.uint8
    np.testing.assert_array_equal(back, jcompat.denormalizeMeanVariance(normed))
    np.testing.assert_allclose(back, img, atol=1.0)


@pytest.mark.parametrize("poly", [False, True])
def test_get_det_boxes_matches_jax(poly):
    """Two words (one curved) on a 60x90 map: the same boxes (to 1e-3
    heatmap pixels), the same polygons, and adjustResultCoordinates the
    same."""
    t = np.zeros((60, 90), np.float32)
    t[10:25, 10:50] = 0.9
    yy, xx = np.mgrid[:60, :90]
    t[(np.abs(yy - (45 - 0.004 * (xx - 55) ** 2)) < 5) & (xx > 30) & (xx < 85)] = 0.95
    link = np.zeros_like(t)
    boxes, polys = compat.getDetBoxes(t, link, 0.7, 0.4, 0.4, poly=poly)
    jboxes, jpolys = jcompat.getDetBoxes(t, link, 0.7, 0.4, 0.4, poly=poly)
    assert len(boxes) == len(jboxes) == 2
    for a, b in zip(boxes, jboxes):
        np.testing.assert_allclose(a, b, atol=1e-3)
    assert [p is None for p in polys] == [p is None for p in jpolys]
    assert not poly or any(p is not None for p in polys)
    for a, b in zip(polys, jpolys):
        if a is not None:
            np.testing.assert_allclose(a, b, atol=1e-3)
    adj = compat.adjustResultCoordinates(boxes, 0.5, 0.25)
    for a, b in zip(adj, jcompat.adjustResultCoordinates(jboxes, 0.5, 0.25)):
        np.testing.assert_allclose(a, b, atol=1e-3)
    assert compat.adjustResultCoordinates([None], 1, 1) == [None]


def test_copy_state_dict_and_load_image(tmp_path):
    sd = {"module.a.weight": 1, "module.b.bias": 2}
    assert compat.copyStateDict(sd) == jcompat.copyStateDict(sd) == {"a.weight": 1, "b.bias": 2}
    assert compat.copyStateDict({"a": 1}) == {"a": 1}
    from lightly_ocr_tpu_torch.data.records import encode_png

    img = np.random.default_rng(2).integers(0, 255, (7, 5, 3)).astype(np.uint8)
    path = tmp_path / "r.png"
    path.write_bytes(encode_png(img))
    np.testing.assert_array_equal(compat.loadImage(str(path)), jcompat.loadImage(str(path)))
    np.testing.assert_array_equal(compat.loadImage(str(path)), img)
