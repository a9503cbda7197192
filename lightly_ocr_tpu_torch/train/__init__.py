"""Training of the port: the CRNN recognizer (train steps and the trainer)
and the CRAFT detector (``craft``, with ``pseudo_labels`` for word-box
records)."""
from lightly_ocr_tpu_torch.train.train_step import (  # noqa: F401
    TrainState,
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
