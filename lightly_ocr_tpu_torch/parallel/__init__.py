"""Data parallelism of the port (counterpart of ``lightly_ocr_tpu/parallel``)."""
from lightly_ocr_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    initialize_distributed,
    make_mesh,
    param_sharding_rules,
    refuse_model_axis,
    replicated,
    shard_batch,
)
