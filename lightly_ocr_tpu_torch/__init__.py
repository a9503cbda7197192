"""lightly-ocr-tpu-torch: the PyTorch/CUDA port of ``lightly_ocr_tpu``.

A second package beside the JAX one.  It imports ``torch`` and never JAX,
flax or any module of ``lightly_ocr_tpu``; the kernels that the JAX package
writes in Pallas are CUDA C++ sources under ``csrc/``, built with ``nvcc``
on first use and loaded with ``ctypes`` (see :mod:`.ops.native`).

Entry points run on the card (``device="cuda"``) unless the caller asks for
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
version.
"""

__version__ = "0.1.0"

from lightly_ocr_tpu_torch.config import Config, load_config  # noqa: F401
