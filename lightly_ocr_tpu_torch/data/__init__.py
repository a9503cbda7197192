"""Training data of the port: LOR1 records, the loader, the generators."""
from lightly_ocr_tpu_torch.data.loader import (  # noqa: F401
    AlignCollate,
    DataLoader,
    RandomSequentialSampler,
    ShuffleSampler,
    align_collate,
)
from lightly_ocr_tpu_torch.data.records import (  # noqa: F401
    RecordDataset,
    RecordWriter,
    open_dataset,
)
