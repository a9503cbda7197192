"""Typed configuration of the PyTorch port (a copy of the JAX package's).

The same frozen dataclass, field for field, as ``lightly_ocr_tpu/config.py``
so one YAML file configures either package.  As in the JAX package,
``fused_stages`` and ``fused_impl`` pick the serving plan of
``serving/batch.py::BatchedOCR`` (overridden by ``LIGHTLY_OCR_ENABLE_FUSED``
and ``LIGHTLY_OCR_FUSED_IMPL``); ``mesh_data`` (-1 = every visible device
that the model axis leaves) and ``mesh_model`` are the CRNN trainer's mesh:
``mesh_data`` processes split the batch, and ``mesh_model`` ones a data
index split the weights (tensor parallelism).  ``monolith`` and ``cpool_pool``
choose among compiled XLA programs in the JAX package; the port runs one
eager program that computes every form, so they are validated and have no
effect.  ``compute_dtype``, ``param_dtype``, ``num_gpu`` and ``onnx_path``
are kept for file compatibility: the port takes the serving dtype as an
argument.
``yaml`` is imported inside :func:`load_config` and :func:`save_config`
only, so the package imports without it; without it, a config file is
read and written as JSON.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Mapping

# Tokens used by the attention label converter.
GO_TOKEN = "[GO]"
EOS_TOKEN = "[s]"
BLANK_TOKEN = "[blank]"

DEFAULT_CHARSET = "0123456789abcdefghijklmnopqrstuvwxyz"


@dataclass(frozen=True)
class Config:
    # --- paths (reference config.yml:1-6) ---
    onnx_path: str = "converted_models"
    pretrained: str = "save_models"
    log_dir: str = "logs"
    train_root: str = "data/train"
    val_root: str = "data/val"

    # --- run cfgs (config.yml:8-22) ---
    seeds: int = 4420
    workers: int = 2
    num_gpu: int = 1
    batch_size: int = 64
    num_iters: int = 30000
    val_interval: int = 1000
    save_interval: int = 1000
    lr: float = 0.01
    adam: bool = False
    beta1: float = 0.9
    rho: float = 0.95
    eps: float = 1.0e-8
    grad_clip: float = 5.0
    train_remat: bool = False
    grad_accum: int = 1

    # --- fine tune / data (config.yml:24-39) ---
    random_sample: bool = True
    keep_ratio: bool = True
    batch_max_len: int = 25
    num_epochs: int = 25
    height: int = 32
    width: int = 100
    rgb: bool = False
    num_fiducial: int = 20
    input_channel: int = 1
    output_channel: int = 512
    hidden_size: int = 256
    num_classes: int = 38  # informational; derived property below is canonical
    character: str = DEFAULT_CHARSET
    filtering: bool = True

    # --- model topology (config.yml:41-46) ---
    transform: str = "TPS"  # {"None", "TPS"}
    backbone: str = "ResNet"  # {"ResNet"}
    sequence: str = "biLSTM"  # {"None", "biLSTM"}
    prediction: str = "Attention"  # {"CTC", "Attention"}
    pipeline: str = "CRAFT-CRNN"

    # --- resume (referenced-but-missing keys in the reference) ---
    saved_model_path: str = ""
    fine_tune: bool = False
    max_iter: int = 100

    # --- additions of the JAX package (no reference counterpart) ---
    mesh_data: int = -1
    mesh_model: int = 1  # ranks a data index that split the weights (tensor parallelism)
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    quant_int8: bool = False
    # Detector canvases round up to buckets so distinct receipt sizes
    # share shapes (see ops/image.py).
    canvas_size: int = 1280
    magnify_ratio: float = 1.5
    bucket_granularity: int = 64
    # Original-resolution gray images are zero-padded up to a multiple of
    # this; true extents travel beside them, so box clipping stays exact.
    gray_granularity: int = 256
    text_threshold: float = 0.7
    link_threshold: float = 0.4
    low_text: float = 0.4
    enable_poly: bool = False
    max_boxes: int = 256  # static cap on detected boxes per image
    cc_max_iters: int = 16
    ctc_decode: str = "greedy"  # {"greedy", "beam"}
    attn_decode: str = "greedy"  # {"greedy", "beam"}
    beam_width: int = 8
    fused_stages: str = "tail,s2d"
    fused_impl: str = "pallas"
    monolith: bool = True
    cpool_pool: str = "strided"
    serving_depth: int = 4
    ctc_lm_path: str = ""

    def __post_init__(self):
        if self.transform not in ("None", "TPS"):
            raise ValueError(f"transform must be None|TPS, got {self.transform!r}")
        if self.backbone not in ("ResNet",):
            raise ValueError(f"backbone must be ResNet, got {self.backbone!r}")
        if self.sequence not in ("None", "biLSTM"):
            raise ValueError(f"sequence must be None|biLSTM, got {self.sequence!r}")
        if self.prediction not in ("CTC", "Attention"):
            raise ValueError(
                f"prediction must be CTC|Attention, got {self.prediction!r}"
            )
        if self.pipeline != "CRAFT-CRNN":
            raise ValueError(f"pipeline must be CRAFT-CRNN, got {self.pipeline!r}")
        if self.height <= 0 or self.width <= 0 or self.batch_max_len <= 0:
            raise ValueError("height/width/batch_max_len must be positive")
        if self.ctc_decode not in ("greedy", "beam"):
            raise ValueError(
                f"ctc_decode must be greedy|beam, got {self.ctc_decode!r}"
            )
        if self.attn_decode not in ("greedy", "beam"):
            raise ValueError(
                f"attn_decode must be greedy|beam, got {self.attn_decode!r}"
            )
        if self.beam_width <= 0:
            raise ValueError("beam_width must be positive")
        if self.fused_impl not in ("pallas", "rowpack"):
            raise ValueError(
                f"fused_impl must be pallas|rowpack, got {self.fused_impl!r}"
            )
        if self.cpool_pool not in ("reshape", "strided"):
            raise ValueError(
                f"cpool_pool must be reshape|strided, got {self.cpool_pool!r}"
            )
        known = {"tail", "stem", "cpool", "cpool2", "s2d"}
        stages = {
            t.strip()
            for t in self.fused_stages.split(",")
            if t.strip() and t.strip().lower() not in ("none", "off", "0")
        }
        if stages - known:
            raise ValueError(
                f"fused_stages contains unknown stages {sorted(stages - known)}"
                f" (known: {sorted(known)})"
            )

    # --- derived (canonical replacements for crnn.py:69-74 mutation) ---
    @property
    def derived_input_channel(self) -> int:
        return 3 if self.rgb else self.input_channel

    @property
    def derived_num_classes(self) -> int:
        """len(converter.character): CTC = charset+blank, Attn = charset+GO+EOS."""
        if self.prediction == "CTC":
            return len(self.character) + 1
        return len(self.character) + 2

    @property
    def num_steps(self) -> int:
        """Attention decode steps = batch_max_len + 1 (attention.py:28)."""
        return self.batch_max_len + 1

    @property
    def derived_fused_stages(self) -> frozenset:
        """``fused_stages`` parsed to a set ("none"/"off"/"0" -> empty)."""
        return frozenset(
            t.strip()
            for t in self.fused_stages.split(",")
            if t.strip() and t.strip().lower() not in ("none", "off", "0")
        )

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Config":
        names = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in d.items() if k in names}
        return cls(**known)


def load_config(path: str | None = None) -> Config:
    """Load a reference-format YAML config; missing keys get defaults.
    Where ``yaml`` is not installed (the card's installation), the file is
    read as JSON, which is YAML too: write the config as JSON there."""
    if path is None:
        return Config()
    with open(os.path.expanduser(path), "r") as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        try:
            data = json.loads(text) if text.strip() else {}
        except json.JSONDecodeError as e:
            raise ValueError(
                f"{path}: pyyaml is not installed, and the file is not JSON "
                "(JSON is YAML too: write the config as JSON here)") from e
    else:
        data = yaml.safe_load(text) or {}
    return Config.from_dict(data)


def save_config(cfg: Config, path: str) -> None:
    """Write ``cfg`` as YAML, as the JAX package does; where ``yaml`` is not
    installed, as JSON (which :func:`load_config` reads either way)."""
    try:
        import yaml
    except ImportError:
        yaml = None
    with open(os.path.expanduser(path), "w") as f:
        if yaml is None:
            json.dump(cfg.to_dict(), f, indent=2)
        else:
            yaml.safe_dump(cfg.to_dict(), f, sort_keys=False)
