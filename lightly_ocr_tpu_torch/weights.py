"""Weights of the port: reference ``.pth`` files, and the JAX ``variables``
tree -> the port's PyTorch ``state_dict``.

:func:`load_state_dict_file` reads a reference-format checkpoint
(``CRAFT.pth``/``CRNN.pth``, e.g. as ``export_torch_checkpoints.py`` writes
them) for a strict ``load_state_dict``: a DataParallel ``module.`` prefix is
stripped as the JAX importer does (``utils/torch_import.py:49-54``,
reference ``ocr/net.py:24-34``), and so are the bookkeeping entries that
the port recomputes rather than loads (BatchNorm ``num_batches_tracked``;
the TPS grid constants ``inv_delta_C``/``P_hat``), which the JAX importer
also ignores.  Every other key must match.

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


def state_dict_from_variables(variables: Mapping[str, Any], dtype=np.float32) -> dict:
    """Nested ``{collection: {module: ... {leaf: array}}}`` -> ``{key: Tensor}``
    of ``dtype`` (float32, or float64 to carry a float64 tree whole)."""
    out = {}
    for path, value in _flatten(variables):
        _, *module_path, leaf = path
        arr = np.asarray(value, dtype)
        if leaf == "kernel":
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
        key = ".".join([*module_path, _LEAF.get(leaf, leaf)])
        out[key] = torch.tensor(arr)
    return out


_RECOMPUTED = ("num_batches_tracked", "inv_delta_C", "P_hat")


def strip_module_prefix(state_dict: Mapping[str, Any]) -> dict:
    """Remove DataParallel ``module.`` key prefixes if present (the rule of
    the JAX importer: judged on the first key)."""
    keys = list(state_dict)
    if keys and keys[0].startswith("module"):
        return {k.split(".", 1)[1]: v for k, v in state_dict.items()}
    return dict(state_dict)


def load_state_dict_file(path: str) -> dict:
    """A ``.pth`` state dict -> ``{key: float32 Tensor}`` on the CPU, read
    with ``torch.load(weights_only=True)``, ready for ``strict=True``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: torch.as_tensor(v).float() for k, v in strip_module_prefix(sd).items()
            if not k.endswith(_RECOMPUTED)}
