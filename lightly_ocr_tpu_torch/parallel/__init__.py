"""Data and tensor parallelism of the port (counterpart of
``lightly_ocr_tpu/parallel``)."""
from lightly_ocr_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshGroups,
    initialize_distributed,
    make_mesh,
    mesh_groups,
    new_mesh_groups,
    param_sharding_rules,
    replicated,
    shard_batch,
)
from lightly_ocr_tpu_torch.parallel.tensor import shard_module  # noqa: F401
