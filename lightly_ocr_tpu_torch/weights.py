"""JAX ``variables`` tree -> the port's PyTorch ``state_dict``.

The port's modules carry the reference torch names (``basenet.slice1.0``,
``Prediction.attention_cell.rnn``, ...), and so does the JAX package's flax
tree, so the mapping is mechanical.  This is the port's own copy of the key
rule of ``lightly_ocr_tpu/utils/torch_import.py::export_torch_state_dict``
(that module imports jax and flax):

* ``params/a/b/kernel`` 4D HWIO -> ``a.b.weight`` OIHW;
  2D ``[in, out]`` -> ``[out, in]``;
* BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, and
  ``batch_stats/.../mean``/``var`` -> ``running_mean``/``running_var``;
* LSTM tensors (``weight_ih_l0``, ...) are stored in torch layout and gate
  order (i, f, g, o) on both sides and copy through.

The input is nested dicts of arrays (numpy, or anything ``np.asarray``
takes); no JAX import is needed to read it.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_LEAF = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_variables(variables: Mapping[str, Any]) -> dict:
    """Nested ``{collection: {module: ... {leaf: array}}}`` -> ``{key: Tensor}``."""
    out = {}
    for path, value in _flatten(variables):
        _, *module_path, leaf = path
        arr = np.asarray(value, np.float32)
        if leaf == "kernel":
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
        key = ".".join([*module_path, _LEAF.get(leaf, leaf)])
        out[key] = torch.tensor(arr)
    return out
