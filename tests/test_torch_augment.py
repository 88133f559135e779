"""The port's input pipeline against the JAX package's, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.data import augment as jax_augment
from cyclegan_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from cyclegan_tpu_torch.data import augment
from cyclegan_tpu_torch.ops import resize_bilinear


@pytest.mark.parametrize("size,out", [(256, 306), (32, 82), (20, 13)])
def test_resize_bilinear_matches_jax(size, out):
    """Half-pixel centres, antialias off, edges included (the upscale of
    the jitter, 256 -> 306, and a downscale)."""
    x = np.random.default_rng(size).uniform(
        -1, 1, (1, size, size, 3)).astype(np.float32)
    want = np.asarray(jax_resize_bilinear(jnp.asarray(x), out, out))
    got = resize_bilinear(torch.from_numpy(x), out, out).numpy()
    assert got.shape == want.shape == (1, out, out, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_resize_bilinear_keeps_floats_and_promotes_uint8():
    x = torch.zeros(1, 4, 4, 3, dtype=torch.uint8)
    assert resize_bilinear(x, 6, 6).dtype == torch.float32
    assert resize_bilinear(x.to(torch.bfloat16), 6, 6).dtype == \
        torch.bfloat16


def _jax_offsets_and_flips(rng, batch):
    """The crop offsets and flips random_jitter_batch draws from ``rng``
    (cyclegan_tpu/data/augment.py ``_crop_and_flip``)."""
    offsets, flips = [], []
    for key in jax.random.split(rng, batch):
        crop_rng, flip_rng = jax.random.split(key)
        offsets.append(np.asarray(jax.random.randint(
            crop_rng, (2,), 0, jax_augment.JITTER_PAD + 1)))
        flips.append(bool(jax.random.bernoulli(flip_rng)))
    return torch.tensor(np.stack(offsets)), torch.tensor(flips)


def test_jitter_matches_jax_at_its_offsets_and_flips():
    images = np.random.default_rng(3).integers(
        0, 256, (4, 32, 32, 3), dtype=np.uint8)
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jax_augment.random_jitter_batch(
        rng, jnp.asarray(images), 32))
    offsets, flips = _jax_offsets_and_flips(rng, 4)
    assert flips.any() and not flips.all()  # both branches are exercised
    got = augment.jitter_batch(torch.from_numpy(images), 32, offsets, flips)
    assert got.dtype == torch.float32 and got.shape == (4, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


def test_random_jitter_is_seeded_and_in_range():
    images = torch.zeros(8, 16, 16, 3, dtype=torch.uint8)
    offsets, flips = augment.draw_jitter(torch.Generator().manual_seed(0), 8)
    again, flips_again = augment.draw_jitter(
        torch.Generator().manual_seed(0), 8)
    assert torch.equal(offsets, again) and torch.equal(flips, flips_again)
    assert offsets.shape == (8, 2) and flips.dtype == torch.bool
    assert int(offsets.min()) >= 0
    assert int(offsets.max()) <= augment.JITTER_PAD
    out = augment.random_jitter_batch(torch.Generator().manual_seed(1),
                                      images, 16)
    assert out.shape == (8, 16, 16, 3)
    assert torch.all(out == -1.0)


def test_prepare_eval_batch_normalizes_only():
    images = np.random.default_rng(4).integers(
        0, 256, (2, 8, 8, 3), dtype=np.uint8)
    want = np.asarray(jax_augment.prepare_eval_batch(jnp.asarray(images)))
    got = augment.prepare_eval_batch(torch.from_numpy(images))
    # x / 127.5 - 1 against XLA's rewrite of the division: 1 ulp at 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.4e-7)
    floats = torch.rand(1, 4, 4, 3)
    assert augment.prepare_eval_batch(floats) is floats
