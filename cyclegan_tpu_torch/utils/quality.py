"""FID-class quality metrics (cyclegan_tpu/utils/quality.py).

Real FID needs the Inception-v3 weights, which the repository does not
hold, so the FID/KID machinery takes a pluggable feature extractor:

- ``extractor=None`` (the default): a fixed, seeded, randomly initialized
  conv stack, a documented proxy that tracks distribution drift between
  image sets and is comparable across runs (its absolute scale is not
  Inception-FID's). Its weights are the JAX package's for the same seed
  (``utils/jax_random.py`` draws them as ``jax.random`` does), so the
  port's ``fid_proxy`` is comparable with the JAX package's too;
- a callable ``(N, H, W, 3) -> (N, D)``, such as
  ``utils.extractor.load_extractor`` on an exported InceptionV3: then the
  statistics are FID and KID.

The sliced Wasserstein distance (SWD) on raw pixel patches is a second,
pretrained-free statistic. The statistics are the JAX package's numpy
code, in float64 on the host; the extractor runs in torch on its device
(the serving session's), f32 with the library convolution's TF32 off.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from cyclegan_tpu_torch.utils import jax_random
from cyclegan_tpu_torch.utils.extractor import (
    conv2d_tf,
    resize_square,
    to_unit_range,
)


# ---------------------------------------------------------------------------
# feature extractors
# ---------------------------------------------------------------------------

def random_feature_weights(dim: int = 256, seed: int = 0):
    """The random stack's weights as the JAX package draws them: four
    3x3 HWIO kernels (He-scaled normals) and the [512, dim] projection,
    float32 numpy."""
    keys = jax_random.split(jax_random.prng_key(seed), 6)
    channels = [3, 32, 64, 128, 256]
    kernels = []
    for i in range(4):
        fan_in = 3 * 3 * channels[i]
        kernels.append(jax_random.normal(
            keys[i], (3, 3, channels[i], channels[i + 1]))
            * np.float32(np.sqrt(2.0 / fan_in)))
    proj = (jax_random.normal(keys[4], (2 * channels[-1], dim))
            / np.float32(np.sqrt(2 * channels[-1])))
    return kernels, proj


def make_random_feature_extractor(dim: int = 256, seed: int = 0,
                                  image_size: int = 64,
                                  device="cuda") -> Callable:
    """A fixed random conv stack: 4x (3x3 conv, stride 2, TF 'SAME', then
    LeakyReLU 0.2), global mean and max pools, a random projection to
    ``dim``. Deterministic in ``seed``.

    Inputs: uint8 or [-1, 1] float (N, H, W, 3), resized bilinearly to
    ``image_size`` first so the metric does not depend on the resolution.
    Runs on ``device`` (cuda by default); returns float64 numpy."""
    kernels, proj = random_feature_weights(dim, seed)
    kernels = [torch.as_tensor(k, device=device) for k in kernels]

    @torch.inference_mode()
    def extractor(images) -> np.ndarray:
        x = to_unit_range(torch.as_tensor(np.asarray(images), device=device))
        x = resize_square(x.permute(0, 3, 1, 2), image_size)
        for k in kernels:
            x = torch.nn.functional.leaky_relu(
                conv2d_tf(x, k, (2, 2), "SAME"), 0.2)
        feats = torch.cat([x.mean(dim=(2, 3)), x.amax(dim=(2, 3))], dim=-1)
        # the [N, 512] x [512, dim] projection in f32 on the host
        return (feats.cpu().numpy() @ proj).astype(np.float64)

    return extractor


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """FID formula: ||mu_a - mu_b||^2 + Tr(Ca + Cb - 2 (Ca Cb)^{1/2}).

    The matrix square root's trace is Tr((Ca^{1/2} Cb Ca^{1/2})^{1/2}),
    from eigen decompositions, clipping tiny negative eigenvalues."""
    feats_a = np.asarray(feats_a, np.float64)
    feats_b = np.asarray(feats_b, np.float64)
    mu_a, mu_b = feats_a.mean(0), feats_b.mean(0)
    ca = np.cov(feats_a, rowvar=False)
    cb = np.cov(feats_b, rowvar=False)
    diff = mu_a - mu_b

    wa, va = np.linalg.eigh(ca)
    wa = np.clip(wa, 0, None)
    sqrt_ca = (va * np.sqrt(wa)) @ va.T
    inner = sqrt_ca @ cb @ sqrt_ca
    wi = np.linalg.eigvalsh(inner)
    tr_sqrt = np.sum(np.sqrt(np.clip(wi, 0, None)))
    return float(diff @ diff + np.trace(ca) + np.trace(cb) - 2.0 * tr_sqrt)


def kernel_inception_distance(feats_a: np.ndarray, feats_b: np.ndarray,
                              degree: int = 3) -> float:
    """KID: the unbiased squared MMD with the polynomial kernel
    (x.y/d + 1)^degree (Binkowski et al., 2018)."""
    x = np.asarray(feats_a, np.float64)
    y = np.asarray(feats_b, np.float64)
    d = x.shape[1]

    def k(u, v):
        return (u @ v.T / d + 1.0) ** degree

    m, n = len(x), len(y)
    kxx = k(x, x)
    kyy = k(y, y)
    kxy = k(x, y)
    sum_xx = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
    sum_yy = (kyy.sum() - np.trace(kyy)) / (n * (n - 1))
    sum_xy = kxy.mean()
    return float(sum_xx + sum_yy - 2.0 * sum_xy)


def sliced_wasserstein(images_a: np.ndarray, images_b: np.ndarray,
                       n_projections: int = 256, patch: int = 7,
                       n_patches: int = 2048, seed: int = 0) -> float:
    """SWD over random pixel patches (Karras et al., 2018): patch vectors
    projected onto random directions, 1-D Wasserstein distances
    averaged."""
    rng = np.random.default_rng(seed)

    def to_float(x):
        x = np.asarray(x, np.float64)
        if x.max() > 2.0:
            x = x / 127.5 - 1.0
        return x

    def sample_patches(x):
        n, h, w, c = x.shape
        idx_n = rng.integers(0, n, n_patches)
        idx_h = rng.integers(0, h - patch + 1, n_patches)
        idx_w = rng.integers(0, w - patch + 1, n_patches)
        out = np.empty((n_patches, patch * patch * c))
        for i, (ni, hi, wi) in enumerate(zip(idx_n, idx_h, idx_w)):
            out[i] = x[ni, hi:hi + patch, wi:wi + patch].ravel()
        out -= out.mean(axis=1, keepdims=True)
        sd = out.std(axis=1, keepdims=True)
        return out / np.maximum(sd, 1e-8)

    pa = sample_patches(to_float(images_a))
    pb = sample_patches(to_float(images_b))
    dirs = rng.normal(size=(pa.shape[1], n_projections))
    dirs /= np.linalg.norm(dirs, axis=0, keepdims=True)
    proj_a = np.sort(pa @ dirs, axis=0)
    proj_b = np.sort(pb @ dirs, axis=0)
    return float(np.mean(np.abs(proj_a - proj_b)))


def compute_quality(images_a: np.ndarray, images_b: np.ndarray,
                    extractor: Optional[Callable] = None, seed: int = 0,
                    device="cuda") -> dict:
    """The three statistics between two image sets. ``extractor=None``
    takes the random-feature stack on ``device`` (proxy mode: the keys are
    ``fid_proxy`` and ``kid_proxy``); with a pretrained extractor they are
    ``fid`` and ``kid``."""
    proxy = extractor is None
    if proxy:
        extractor = make_random_feature_extractor(seed=seed, device=device)
    fa = extractor(images_a)
    fb = extractor(images_b)
    suffix = "_proxy" if proxy else ""
    return {
        f"fid{suffix}": round(frechet_distance(fa, fb), 4),
        f"kid{suffix}": round(kernel_inception_distance(fa, fb), 6),
        "swd": round(sliced_wasserstein(images_a, images_b, seed=seed), 4),
        "n_a": int(len(np.asarray(images_a))),
        "n_b": int(len(np.asarray(images_b))),
    }
