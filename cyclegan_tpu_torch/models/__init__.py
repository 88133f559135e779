from cyclegan_tpu_torch.models.registry import create_model
from cyclegan_tpu_torch.models.resnet import (
    ResNetGenerator,
    SimpleDiscriminator,
)
from cyclegan_tpu_torch.models.ugatit import (
    UGATITDiscriminator,
    UGATITGenerator,
    generated_image,
)
from cyclegan_tpu_torch.models.unet import StridedUNet, UNetGenerator

__all__ = ["ResNetGenerator", "SimpleDiscriminator", "StridedUNet",
           "UGATITDiscriminator", "UGATITGenerator", "UNetGenerator",
           "create_model", "generated_image",
           "spatial_unsupported_transposes"]


def spatial_unsupported_transposes(model_config):
    """The conv-transpose kernels of ``model_config`` that cannot run
    H-sharded, as ``[(net, kernel), ...]``: the pooled U-Net's up kernels
    ``kernels[:0:-1]`` where its expansion is not ``upsample``, the
    strided U-Net's and its final k4; the ResNet's k3 upsamples pass and
    the PatchGAN has none. The rule is ``ops.conv.
    spatial_transpose_supported`` at stride 2 (k3/k4/k7/k8 pass, k5/k6
    do not)."""
    from cyclegan_tpu_torch.ops.conv import spatial_transpose_supported

    bad = []
    for net in ("generator", "discriminator"):
        cfg = model_config.get(net) if hasattr(model_config, "get") else None
        if cfg is None:
            continue
        net_type = cfg.get("type", "")
        kernels = list(cfg.get("kernels", []))
        if net_type == "strided_unet":
            up_kernels = kernels[:0:-1] + [4]
        elif (net_type == "unet_generator"
              and cfg.get("expansion", "upsample") != "upsample"):
            up_kernels = kernels[:0:-1]
        else:
            continue
        bad.extend((net, int(k)) for k in up_kernels
                   if not spatial_transpose_supported(int(k), 2))
    return bad
