"""models of the PyTorch port."""
from lightly_ocr_tpu_torch.models.attention import Attention  # noqa: F401
from lightly_ocr_tpu_torch.models.crnn import CRNNet, init_crnn  # noqa: F401
from lightly_ocr_tpu_torch.models.lstm import BidirectionalLSTM, SeqModeling  # noqa: F401
from lightly_ocr_tpu_torch.models.resnet import ResNet50v2  # noqa: F401
from lightly_ocr_tpu_torch.models.tps import TPS_STN  # noqa: F401
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet  # noqa: F401
