from cyclegan_tpu_torch.models.registry import create_model
from cyclegan_tpu_torch.models.unet import UNetGenerator

__all__ = ["UNetGenerator", "create_model"]
