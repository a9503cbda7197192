"""Label converters (copied from the JAX package; framework-free)."""
from lightly_ocr_tpu_torch.text.converters import (  # noqa: F401
    AttnLabelConverter,
    CTCLabelConverter,
    build_converter,
)
