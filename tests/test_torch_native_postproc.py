"""The port's host post-processing library vs the JAX package's bindings.

``lightly_ocr_tpu_torch/csrc/postproc.cc`` built with ``g++`` into the
port's build cache, on the cases of ``tests/test_native.py``: labels and
boxes identical to the JAX package's ``native_postproc`` (its
``native/libpostproc.so``), the components the partition of ``cv2``'s, and
the boxes within IoU 0.97 of the port's on-device ``get_det_boxes`` (as
``test_native.py`` holds the JAX pair).
"""
import os
import shutil
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from lightly_ocr_tpu import native_postproc as jnative
from lightly_ocr_tpu_torch import native_postproc
from lightly_ocr_tpu_torch.ops import native
from lightly_ocr_tpu_torch.ops.cc import label_components
from lightly_ocr_tpu_torch.ops.detection import get_det_boxes

sys.path.insert(0, os.path.dirname(__file__))
from test_detection import box_iou, synthetic_maps  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def built():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH")
    assert native_postproc.available()
    assert jnative.available()


def test_built_from_the_ports_source():
    lib = native.library_path("postproc")
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert native.source("postproc").name == "postproc.cc"
    assert native.source("postproc").parent.name == "csrc"


@pytest.mark.parametrize("shape,density", [((80, 100), 0.7), ((37, 53), 0.5), ((1, 9), 0.4), ((16, 16), 1.1)])
def test_label_components_equal_jax(rng, shape, density):
    mask = (rng.random(shape) > density).astype(np.uint8)
    n, labels = native_postproc.label_components(mask)
    jn, jlabels = jnative.label_components(mask)
    assert n == jn
    np.testing.assert_array_equal(labels, jlabels)


def test_label_components_partition_is_cv2s(rng):
    cv2 = pytest.importorskip("cv2")
    mask = (rng.random((80, 100)) > 0.7).astype(np.uint8)
    n_ref, ref = cv2.connectedComponents(mask, connectivity=4)
    n_ours, ours = native_postproc.label_components(mask)
    assert n_ours == n_ref
    fg = mask.astype(bool)
    pairs = set(zip(ref[fg].tolist(), ours[fg].tolist()))
    assert len(pairs) == n_ref - 1 and len({p[1] for p in pairs}) == n_ref - 1


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("thresholds", [(0.7, 0.4, 0.4), (0.5, 0.3, 0.2)])
def test_det_boxes_equal_jax(seed, thresholds):
    textmap, linkmap = synthetic_maps(np.random.default_rng(seed))
    got = native_postproc.det_boxes(textmap, linkmap, *thresholds)
    want = jnative.det_boxes(textmap, linkmap, *thresholds)
    assert got.shape == want.shape and len(got) > 0
    np.testing.assert_array_equal(got, want)
    few = native_postproc.det_boxes(textmap, linkmap, *thresholds, max_boxes=2)
    np.testing.assert_array_equal(few, jnative.det_boxes(textmap, linkmap, *thresholds, max_boxes=2))


def test_det_boxes_empty_and_shape_validation():
    z = np.zeros((32, 32), np.float32)
    assert native_postproc.det_boxes(z, z).shape == (0, 4, 2)
    with pytest.raises(ValueError):
        native_postproc.det_boxes(np.zeros((4, 4), np.float32), np.zeros((5, 5), np.float32))


def test_matches_the_ports_device_version(rng):
    """The host route and the port's ``get_det_boxes`` (CC and box
    extraction as the card runs them, here in their plain versions) agree
    on box geometry."""
    textmap, linkmap = synthetic_maps(rng)
    host = native_postproc.det_boxes(textmap, linkmap, 0.7, 0.4, 0.4)
    t, lk = torch.from_numpy(textmap)[None], torch.from_numpy(linkmap)[None]
    labels = label_components(((t > 0.4) | (lk > 0.4)).contiguous())
    boxes, valid = get_det_boxes(t, lk, labels, text_threshold=0.7, link_threshold=0.4, low_text=0.4,
                                 max_boxes=32)
    dev = boxes[0][valid[0]].numpy()
    assert len(host) == len(dev) > 0
    for nb, db in zip(sorted(host.tolist(), key=lambda b: (b[0][1], b[0][0])),
                      sorted(dev.tolist(), key=lambda b: (b[0][1], b[0][0]))):
        assert box_iou(np.asarray(nb), np.asarray(db)) >= 0.97


def test_unavailable_without_a_compiler(monkeypatch, tmp_path):
    """No ``g++`` and no built library: ``NativeUnavailable``, not a
    fallback."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setenv("CXX", "no-such-compiler")
    assert not native_postproc.available()
    with pytest.raises(native_postproc.NativeUnavailable, match="g\\+\\+|no-such-compiler|not found"):
        native_postproc.load_library()


def test_cold_load_from_many_threads(monkeypatch, tmp_path):
    """Threads that miss the library together on an empty build directory
    (the replicas of a mesh, each on its own thread) build it once and all
    get the same loaded library."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_libs", {})
    builds = []
    real_build = native._build
    monkeypatch.setattr(native, "_build", lambda names: builds.append(
        [n for n in names if not native.library_path(n).exists()]) or real_build(names))
    barrier = threading.Barrier(4)

    def cold_load():
        barrier.wait()
        return native_postproc.load_library()

    with ThreadPoolExecutor(4) as pool:
        libs = list(pool.map(lambda _: cold_load(), range(4)))
    assert all(lib is libs[0] for lib in libs)
    assert [b for b in builds if b] == [["postproc"]]
    assert [p.name for p in tmp_path.iterdir()] == [native.library_path("postproc").name]
    mask = np.zeros((4, 4), np.uint8)
    mask[1:3, 1:3] = 1
    assert native_postproc.label_components(mask)[0] == 2
