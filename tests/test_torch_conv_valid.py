"""``conv2d(padding="VALID")`` against the JAX package's, on the CPU, in
both layouts, strides 1 and 2, with and without a bias: the library
convolution of both packages in f32, within 1e-5."""

import jax
import numpy as np
import pytest
import torch

from cyclegan_tpu.ops import conv2d as jax_conv2d
from cyclegan_tpu_torch.ops import conv2d, layout


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("nhcw", [False, True])
def test_valid_conv_matches_jax(nhcw, stride, bias):
    rng = np.random.default_rng(stride + 2 * bias)
    x = rng.normal(size=(2, 13, 11, 5)).astype(np.float32)
    w = rng.normal(size=(3, 3, 5, 4)).astype(np.float32)
    b = rng.normal(size=4).astype(np.float32) if bias else None
    want = jax.jit(lambda x, w, b: jax_conv2d(x, w, b, stride=stride,
                                              padding="VALID"))(x, w, b)
    tx = torch.from_numpy(x)
    with layout.nhcw(nhcw):
        y = conv2d(layout.to_nhcw(tx) if nhcw else tx, torch.from_numpy(w),
                   None if b is None else torch.from_numpy(b), stride,
                   "VALID")
        y = layout.from_nhcw(y) if nhcw else y
    assert y.shape == want.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_other_padding_raises():
    with pytest.raises(ValueError, match="'SAME' or 'VALID'"):
        conv2d(torch.zeros(1, 4, 4, 1), torch.zeros(1, 1, 1, 1),
               padding="FULL")
