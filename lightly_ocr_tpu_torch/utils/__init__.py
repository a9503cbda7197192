"""Training utilities of the port: checkpoints and metrics."""
from lightly_ocr_tpu_torch.utils.metrics import (  # noqa: F401
    Averager,
    edit_distance,
    exact_match_accuracy,
    normalized_edit_distance,
)
