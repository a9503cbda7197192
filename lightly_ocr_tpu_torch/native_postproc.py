"""ctypes bindings of the host post-processing library (port of
``lightly_ocr_tpu/native_postproc.py``).

``csrc/postproc.cc`` (the port's copy of the JAX package's
``native/postproc.cc``) is the exact host-side counterpart of the
reference's OpenCV box extraction (``det_utils.py:35-94``); see its header
comment.  The on-device route (:mod:`.ops.detection`, the CC kernel) is the
serving path; this is the bit-faithful host route and oracle beside it, and
the piece a CPU-only deployment uses.

The shared library is built on first use with ``g++ -O3 -fPIC -std=c++17
-shared`` through :mod:`.ops.native`'s hash-keyed cache
(``build/torch_kernels/``); :class:`NativeUnavailable` says why when no
``g++`` or no build is to be had.
"""
from __future__ import annotations

import ctypes

import numpy as np

from lightly_ocr_tpu_torch.ops import native

_F = ctypes.POINTER(ctypes.c_float)
_SIG = {
    "lor_det_boxes": [_F, _F, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                      ctypes.c_float, _F, ctypes.c_int],
    "lor_label_components": [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int32)],
}


class NativeUnavailable(RuntimeError):
    pass


def load_library() -> ctypes.CDLL:
    """The built library (``g++`` on first use); raises
    :class:`NativeUnavailable` where it cannot be built."""
    try:
        return native.load("postproc", _SIG)
    except (RuntimeError, OSError) as e:
        raise NativeUnavailable(f"libpostproc could not be built or loaded: {e}") from e


def available() -> bool:
    try:
        load_library()
        return True
    except NativeUnavailable:
        return False


def det_boxes(
    textmap: np.ndarray,
    linkmap: np.ndarray,
    text_threshold: float = 0.7,
    link_threshold: float = 0.4,
    low_text: float = 0.4,
    max_boxes: int = 256,
) -> np.ndarray:
    """-> [N, 4, 2] float32 boxes (heatmap coords, clockwise from the
    min-sum corner)."""
    lib = load_library()
    textmap = np.ascontiguousarray(textmap, dtype=np.float32)
    linkmap = np.ascontiguousarray(linkmap, dtype=np.float32)
    if textmap.shape != linkmap.shape or textmap.ndim != 2:
        raise ValueError("textmap/linkmap must be equal-shape 2D arrays")
    H, W = textmap.shape
    out = np.zeros((max_boxes, 8), np.float32)
    n = lib.lor_det_boxes(textmap.ctypes.data_as(_F), linkmap.ctypes.data_as(_F), H, W,
                          float(text_threshold), float(link_threshold), float(low_text),
                          out.ctypes.data_as(_F), int(max_boxes))
    return out[:n].reshape(n, 4, 2)


def label_components(mask: np.ndarray) -> tuple[int, np.ndarray]:
    """``cv2.connectedComponents(connectivity=4)`` parity: (n_labels, labels)."""
    lib = load_library()
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    if mask.ndim != 2:
        raise ValueError("mask must be a 2D array")
    H, W = mask.shape
    labels = np.zeros((H, W), np.int32)
    n = lib.lor_label_components(mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), H, W,
                                 labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return n, labels
