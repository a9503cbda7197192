"""ops of the PyTorch port."""
from lightly_ocr_tpu_torch.ops.grid_sample import affine_grid, grid_sample  # noqa: F401
from lightly_ocr_tpu_torch.ops.image import (  # noqa: F401
    ResizePlan,
    adjust_box_coordinates,
    denormalize_mean_variance,
    make_detector_input,
    normalize_mean_variance,
    pick_canvas_bucket,
    plan_aspect_resize,
    resize_bilinear,
    resize_normalize,
    rgb_to_gray,
)
