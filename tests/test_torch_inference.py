"""The port's InferenceSession against the JAX package's, on the CPU.

converged256 (the default recipe's shipped weights) at 256x256, batch 1,
both directions, in f32: the outputs are uint8, and the two f32 paths may
round a pixel on either side of a half, so they may differ by 1.
"""

import numpy as np
import pytest
import torch

from cyclegan_tpu.apps.inference import InferenceSession as JaxSession
from cyclegan_tpu_torch.apps.inference import InferenceSession

MODEL_DIR = "model_instances/converged256"


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (1, 256, 256, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def sessions():
    # the port's NHCW serving path (plain versions of its kernels) against
    # JAX's f32 session; tests/test_torch_serving_apps.py takes both layouts
    return (InferenceSession(MODEL_DIR, "float32", tpu_layout=True,
                             device="cpu"),
            JaxSession(MODEL_DIR, "float32"))


@pytest.mark.parametrize("direction", ["a2b", "b2a"])
def test_stylize_f32_matches_jax(sessions, image, direction):
    port, ref = sessions
    got = port.stylize(image, direction)
    want = ref.stylize(image, direction)
    assert got.dtype == np.uint8 and got.shape == want.shape == image.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_only_generators_are_built(sessions):
    """The session builds the two generators it serves with and, as the
    JAX session does, the two discriminators (for evaluation), all frozen;
    only the generators stylize."""
    port, ref = sessions
    assert sorted(port.models) == sorted(ref.models) == [
        "d_A", "d_B", "g_AB", "g_BA"]
    assert not any(p.requires_grad for m in port.models.values()
                   for p in m.parameters())


def test_bf16_session_casts_params_and_serves(image):
    session = InferenceSession(MODEL_DIR, "bfloat16", device="cpu")
    for model in session.models.values():
        assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    out = session.stylize(image, "a2b")
    assert out.dtype == np.uint8 and out.shape == image.shape


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceSession(MODEL_DIR)


def test_unknown_compute_dtype_raises():
    with pytest.raises(ValueError):
        InferenceSession(MODEL_DIR, "float16", device="cpu")
