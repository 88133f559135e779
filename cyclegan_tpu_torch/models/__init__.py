from cyclegan_tpu_torch.models.registry import create_model
from cyclegan_tpu_torch.models.resnet import (
    ResNetGenerator,
    SimpleDiscriminator,
)
from cyclegan_tpu_torch.models.unet import StridedUNet, UNetGenerator

__all__ = ["ResNetGenerator", "SimpleDiscriminator", "StridedUNet",
           "UNetGenerator", "create_model"]
