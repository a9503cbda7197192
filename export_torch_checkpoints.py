#!/usr/bin/env python3
"""Convert the committed demo checkpoints into reference-format ``.pth`` files.

    python export_torch_checkpoints.py [--out build/pth]

Restores ``save_models/demo_craft_bf16`` and ``save_models/demo_crnn_bf16``
(orbax, written by ``scripts/train_demo.py``) with the JAX package, and
writes ``CRAFT.pth`` and ``CRNN.pth`` (reference torch key names and
layouts, float32, via ``utils/torch_import.py::export_torch_state_dict``)
into ``--out``.  The PyTorch port then reads them with no JAX installed:

    python -m lightly_ocr_tpu_torch.pipeline --img receipt.png \\
        --config demo.yml --device cpu

where ``demo.yml`` is the config this script prints: the demo recognizer is
a CTC head without TPS, and the demo serves receipts at native scale.  The
script needs JAX, flax and orbax (the JAX package's installation); the
output directory is git-ignored and no ``.pth`` is committed.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
# the demo's serving fields (scripts/train_demo.py::_demo_cfg)
DEMO = dict(prediction="CTC", transform="None", magnify_ratio=1.0,
            bucket_granularity=32, max_boxes=64)


def _restore(path: str, module, args) -> dict:
    """A demo checkpoint as float32 numpy variables, restored into a zeros
    template of ``module``'s tree."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lightly_ocr_tpu.utils.checkpoint import restore_checkpoint

    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args))
    tmpl = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    state, _ = restore_checkpoint(path, {"params": tmpl["params"],
                                         "batch_stats": tmpl["batch_stats"]})
    return jax.tree.map(lambda a: np.asarray(a, np.float32), dict(state))


def demo_variables(models: str):
    """(the demo ``Config`` of the JAX package, {``CRAFT.pth``: detector
    variables, ``CRNN.pth``: recognizer variables}) from ``models``."""
    import jax.numpy as jnp

    from lightly_ocr_tpu.config import load_config
    from lightly_ocr_tpu.models.crnn import CRNNet
    from lightly_ocr_tpu.models.vgg_unet import VGG_UNet

    cfg = load_config(os.path.join(ROOT, "config.yml")).replace(**DEMO)
    return cfg, {
        "CRAFT.pth": _restore(os.path.join(models, "demo_craft_bf16"), VGG_UNet(),
                              (jnp.zeros((1, 64, 64, 3)),)),
        "CRNN.pth": _restore(os.path.join(models, "demo_crnn_bf16"), CRNNet(cfg), (
            jnp.zeros((1, cfg.height, cfg.width, cfg.derived_input_channel)),
            jnp.zeros((1, cfg.num_steps), jnp.int32), False)),
    }


def export(out: str, models: str = os.path.join(ROOT, "save_models")):
    """Write ``CRAFT.pth`` and ``CRNN.pth`` of the demo checkpoints in
    ``models`` into ``out``; returns :func:`demo_variables`' pair."""
    import numpy as np
    import torch

    from lightly_ocr_tpu.utils.torch_import import export_torch_state_dict

    cfg, variables = demo_variables(models)
    os.makedirs(out, exist_ok=True)
    for name, v in variables.items():
        sd = {k: torch.tensor(np.asarray(a)) for k, a in export_torch_state_dict(v).items()}
        torch.save(sd, os.path.join(out, name))
        print(f"wrote {os.path.join(out, name)}: {len(sd)} tensors", file=sys.stderr)
    return cfg, variables


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "pth"),
                        help="directory for CRAFT.pth and CRNN.pth")
    parser.add_argument("--models", default=os.path.join(ROOT, "save_models"),
                        help="directory holding demo_craft_bf16 and demo_crnn_bf16")
    opt = parser.parse_args(argv)

    import yaml

    cfg, _ = export(opt.out, opt.models)
    print(f"# config for the demo checkpoints (pretrained: {opt.out})", file=sys.stderr)
    print(yaml.safe_dump({**cfg.to_dict(), "pretrained": opt.out}, sort_keys=False), end="")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
