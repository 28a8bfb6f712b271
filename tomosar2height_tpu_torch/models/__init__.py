"""Network components (torch.nn, NHWC at the public interfaces, mask-aware)."""

from tomosar2height_tpu_torch.models.blocks import ResnetBlockFC, init_weights  # noqa: F401
from tomosar2height_tpu_torch.models.alto import AltoUNet  # noqa: F401
from tomosar2height_tpu_torch.models.unet import UNet  # noqa: F401
from tomosar2height_tpu_torch.models.pointnet import LocalPoolPointnet  # noqa: F401
from tomosar2height_tpu_torch.models.decoder import ConvDecoder, PixelwiseDecoder  # noqa: F401
from tomosar2height_tpu_torch.models.model import TomoSAR2Height, build_model  # noqa: F401
