from cyclegan_tpu_torch.models.registry import create_model
from cyclegan_tpu_torch.models.resnet import (
    ResNetGenerator,
    SimpleDiscriminator,
)
from cyclegan_tpu_torch.models.unet import UNetGenerator

__all__ = ["ResNetGenerator", "SimpleDiscriminator", "UNetGenerator",
           "create_model"]
