"""What the benchmark makes from ``--seed`` and hands to both the program
and the reference: the four networks' weights and the uint8 images.

Weights: every conv kernel N(0, 0.02), drawn in one call on the device
from a ``torch.Generator`` seeded with the run's seed (the CycleGAN
initializer; the U-Net's 1x1 head, glorot-uniform in the program's own
init, takes it too); biases and norm offsets zeros, norm scales ones.

Images: smooth colour fields, a few cosines per channel over a shared
random base plus a little noise, so that they compress as photos do and
their instance-norm statistics are not those of white noise; each image
with its own detail (at most 1 to 16 cycles a side), contrast, brightness
and colour cast, as the photos of a collection differ. Images that differ
this much make a step that takes the mean over part of its batch read
differently from one that takes it over all. Drawn in one call per pool
on the device, then kept on the host.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import nets

NETWORKS = ("g_AB", "g_BA", "d_A", "d_B")
WEIGHT_STD = 0.02
N_WAVES = 6
STREAMS = {"weights": 1, "images": 2, "jitter": 3, "sample": 5}


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed per use of the run's seed, so that weights, images,
    jitter and the sample of answers draw from unrelated streams."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + STREAMS[stream]
             * 0xBF58476D1CE4E5B9) % (1 << 64)
    mixed ^= mixed >> 31
    return mixed % (1 << 63)


def shapes(cfg: dict) -> Dict[str, Dict[str, tuple]]:
    return {n: nets.shapes_of(cfg["generator" if n.startswith("g")
                                  else "discriminator"]) for n in NETWORKS}


def make_weights(cfg: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{network: {name: f32 tensor on ``device``}} from ``seed``."""
    spec = shapes(cfg)
    kernels = [(n, k, s) for n in NETWORKS for k, s in spec[n].items()
               if k.endswith(".w")]
    total = sum(math.prod(s) for _, _, s in kernels)
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device) * WEIGHT_STD
    out: Dict[str, Dict[str, torch.Tensor]] = {n: {} for n in NETWORKS}
    for (n, k, s), part in zip(kernels, flat.split(
            [math.prod(s) for _, _, s in kernels])):
        out[n][k] = part.view(s)
    for n in NETWORKS:
        for k, s in spec[n].items():
            if k.endswith(".gamma"):
                out[n][k] = torch.ones(s, device=device)
            elif not k.endswith(".w"):
                out[n][k] = torch.zeros(s, device=device)
    return out


def smooth_images(count: int, size: int, seed: int, device) -> torch.Tensor:
    """``count`` uint8 NHWC images of ``size`` x ``size``, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, "images"))
    coef = torch.rand((count, 4, N_WAVES, 4), generator=gen, device=device)
    look = torch.rand((count, 6), generator=gen, device=device)
    noise = torch.randn((count, size, size, 3), generator=gen, device=device)
    grid = torch.arange(size, device=device, dtype=torch.float32) / size
    # per image: a base field shared by the channels and one per channel,
    # each a sum of cosines of random frequency (1 to the image's top),
    # phase, tilt
    top = (1 + 15 * look[:, 5])[:, None, None]  # 1-16 cycles at most
    fx = 1 + (top - 1) * coef[..., 0]
    fy = 1 + (top - 1) * coef[..., 1]
    phase = 2 * math.pi * coef[..., 2]
    amp = 0.5 + coef[..., 3]
    # cos(A + B) = cos A cos B - sin A sin B, A along H, B along W
    a = 2 * math.pi * fy[..., None] * grid + phase[..., None]
    b = 2 * math.pi * fx[..., None] * grid
    amp = amp[..., None]
    fields = (torch.einsum("nfwh,nfwv->nfhv", amp * torch.cos(a), torch.cos(b))
              - torch.einsum("nfwh,nfwv->nfhv", amp * torch.sin(a),
                             torch.sin(b))) / N_WAVES
    base = fields[:, :1]
    colour = 0.6 * base + 0.4 * fields[:, 1:]  # (count, 3, size, size)
    contrast = 60.0 + 300.0 * look[:, :1]        # 60-360 levels
    brightness = 127.5 + 175.0 * (look[:, 1:2] - 0.5)  # 40-215
    cast = 0.6 + 0.8 * look[:, 2:5]             # per channel
    pixels = (brightness[:, None, None, :]
              + (contrast * cast)[:, None, None, :]
              * colour.permute(0, 2, 3, 1) + 4.0 * noise)
    return pixels.round().clamp(0, 255).to(torch.uint8)
