"""serving of the PyTorch port."""
from lightly_ocr_tpu_torch.serving.server import create_app, run_server  # noqa: F401
