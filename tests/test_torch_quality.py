"""The port's FID-class metrics and extractor interpreter against the JAX
package's, on the CPU.

- ``utils/jax_random.py`` against ``jax.random`` (threefry2x32,
  partitionable): keys and raw bits bit-exact; normals within 1e-6, as
  XLA's f32 erfinv polynomial may fuse a step the numpy one rounds (one
  f32 ulp at |z| < 8 is at most 9.5e-7).
- The random-feature extractor: the same weights as JAX's for the seed,
  features within 1e-4 relative to their largest magnitude (f32 convs in
  another order); its antialiased bilinear resize against
  ``jax.image.resize`` within 1e-6 (f32 sums in another order).
- The statistics are the same float64 numpy code: equal within 1e-9.
- The ``.npz`` extractor interpreter on a toy graph with every layer type,
  against JAX's ``build_forward`` within 1e-4 relative.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.utils import extractor as jax_extractor
from cyclegan_tpu.utils import quality as jax_quality
from cyclegan_tpu_torch.utils import extractor, jax_random, quality


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_threefry_matches_jax_random(seed):
    key = jax_random.prng_key(seed)
    ref = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(key, np.asarray(ref))
    keys = jax_random.split(key, 6)
    ref_keys = jax.random.split(ref, 6)
    np.testing.assert_array_equal(keys, np.asarray(ref_keys))
    np.testing.assert_array_equal(jax_random.split(keys[3], 3),
                                  np.asarray(jax.random.split(ref_keys[3], 3)))
    np.testing.assert_array_equal(
        jax_random.bits(keys[1], (4, 5, 7)),
        np.asarray(jax.random.bits(ref_keys[1], (4, 5, 7))))
    got = jax_random.normal(keys[0], (3, 3, 32, 64))
    want = np.asarray(jax.random.normal(ref_keys[0], (3, 3, 32, 64)))
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6


def test_erfinv_edges():
    x = np.array([-1.0, 0.0, 1.0, 0.5, -0.999999], np.float32)
    got = jax_random.erfinv_f32(x)
    want = np.asarray(jax.scipy.special.erfinv(jnp.asarray(x)))
    assert np.isneginf(got[0]) and np.isposinf(got[2]) and got[1] == 0
    assert np.abs(got[3:] - want[3:]).max() <= 1e-6


@pytest.mark.parametrize("size", [256, 512, 16])
def test_resize_matches_jax_image_resize(size):
    """Antialiased when it shrinks (256 -> 64, 512 -> 64, the edges
    included), plain bilinear when it grows (16 -> 64)."""
    rng = np.random.default_rng(size)
    x = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 64, 64, 3),
                                       "bilinear"))
    got = extractor.resize_square(torch.from_numpy(x).permute(0, 3, 1, 2),
                                  64).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= 1e-6


def test_random_weights_are_jaxs():
    kernels, proj = quality.random_feature_weights(dim=32, seed=3)
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    want = jax.random.normal(keys[2], (3, 3, 64, 128), jnp.float32) \
        * np.sqrt(2.0 / (9 * 64))
    assert np.abs(kernels[2] - np.asarray(want)).max() <= 1e-6
    want_proj = jax.random.normal(keys[4], (512, 32), jnp.float32) \
        / np.sqrt(512)
    assert np.abs(proj - np.asarray(want_proj)).max() <= 1e-6


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_random_features_match_jax(kind):
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    if kind == "float":
        images = images.astype(np.float32) / 127.5 - 1.0
    got = quality.make_random_feature_extractor(dim=64, seed=1,
                                                device="cpu")(images)
    want = jax_quality.make_random_feature_extractor(dim=64,
                                                     seed=1)(images)
    assert got.dtype == np.float64 and got.shape == (6, 64)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_statistics_equal_jaxs():
    rng = np.random.default_rng(6)
    fa = rng.normal(size=(40, 16))
    fb = rng.normal(0.3, 1.2, size=(50, 16))
    ia = rng.integers(0, 256, (5, 16, 16, 3), dtype=np.uint8)
    ib = rng.integers(0, 200, (5, 16, 16, 3), dtype=np.uint8)
    pairs = [
        (quality.frechet_distance(fa, fb),
         jax_quality.frechet_distance(fa, fb)),
        (quality.kernel_inception_distance(fa, fb),
         jax_quality.kernel_inception_distance(fa, fb)),
        (quality.sliced_wasserstein(ia, ib, seed=3),
         jax_quality.sliced_wasserstein(ia, ib, seed=3)),
    ]
    for got, want in pairs:
        assert abs(got - want) <= 1e-9 * max(1.0, abs(want))


def test_compute_quality_matches_jax():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-40, 40, a.shape), 0,
                255).astype(np.uint8)
    got = quality.compute_quality(a, b, seed=2, device="cpu")
    want = jax_quality.compute_quality(a, b, seed=2)
    assert sorted(got) == sorted(want) == [
        "fid_proxy", "kid_proxy", "n_a", "n_b", "swd"]
    assert got["swd"] == want["swd"] and got["n_a"] == want["n_a"] == 8
    for key in ("fid_proxy", "kid_proxy"):
        assert abs(got[key] - want[key]) <= 1e-3 * abs(want[key]) + 1e-5
    feats = rng.normal(size=(8, 4))
    real = quality.compute_quality(a, b, extractor=lambda x: feats[:len(x)],
                                   seed=2)
    assert sorted(real) == ["fid", "kid", "n_a", "n_b", "swd"]


def _toy_graph():
    """Every layer type: a SAME and a VALID conv (bias, relu), a batch
    norm with and without gamma/beta, an activation, max and average pools
    in both paddings (SAME average pools count only in-bounds elements), a
    channel concat and the global average."""
    layers = [
        {"name": "in", "type": "input", "inputs": []},
        {"name": "c1", "type": "conv2d", "inputs": ["in"],
         "strides": [2, 2], "padding": "same", "use_bias": True,
         "activation": "relu"},
        {"name": "bn1", "type": "batchnorm", "inputs": ["c1"],
         "epsilon": 1e-3},
        {"name": "c2", "type": "conv2d", "inputs": ["bn1"],
         "strides": [1, 1], "padding": "valid", "use_bias": False},
        {"name": "bn2", "type": "batchnorm", "inputs": ["c2"],
         "epsilon": 1e-3},
        {"name": "act", "type": "activation", "inputs": ["bn2"],
         "activation": "relu"},
        {"name": "mp", "type": "maxpool2d", "inputs": ["act"],
         "pool_size": [3, 3], "strides": [2, 2], "padding": "same"},
        {"name": "ap", "type": "avgpool2d", "inputs": ["act"],
         "pool_size": [3, 3], "strides": [2, 2], "padding": "same"},
        {"name": "mpv", "type": "maxpool2d", "inputs": ["act"],
         "pool_size": [2, 2], "strides": [2, 2], "padding": "valid"},
        {"name": "apv", "type": "avgpool2d", "inputs": ["act"],
         "pool_size": [2, 2], "strides": [2, 2], "padding": "valid"},
        {"name": "cat", "type": "concat", "inputs": ["mp", "ap", "mpv",
                                                     "apv"]},
        {"name": "gap", "type": "globalavgpool", "inputs": ["cat"]},
    ]
    rng = np.random.default_rng(8)
    weights = {
        "c1/kernel": rng.normal(0, 0.3, (3, 3, 3, 8)),
        "c1/bias": rng.normal(0, 0.1, (8,)),
        "bn1/moving_mean": rng.normal(0, 0.1, (8,)),
        "bn1/moving_variance": rng.uniform(0.5, 1.5, (8,)),
        "bn1/gamma": rng.uniform(0.5, 1.5, (8,)),
        "bn1/beta": rng.normal(0, 0.1, (8,)),
        "c2/kernel": rng.normal(0, 0.3, (3, 3, 8, 6)),
        "bn2/moving_mean": rng.normal(0, 0.1, (6,)),
        "bn2/moving_variance": rng.uniform(0.5, 1.5, (6,)),
    }
    weights = {k: v.astype(np.float32) for k, v in weights.items()}
    graph = {"format_version": 1, "image_size": 23,
             "preprocess": "inception", "input": "in", "output": "gap",
             "layers": layers}
    return graph, weights


@pytest.mark.parametrize("output", ["gap", "cat"])
def test_interpreter_matches_jax(output):
    graph, weights = _toy_graph()
    graph["output"] = output
    rng = np.random.default_rng(9)
    x = rng.integers(0, 256, (3, 30, 30, 3), dtype=np.uint8)
    got = extractor.build_forward(graph, weights, "cpu")(
        torch.from_numpy(x)).numpy()
    want = np.asarray(jax_extractor.build_forward(graph, weights)(
        jnp.asarray(x)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_load_extractor_matches_jax_and_rejects_bad_files(tmp_path):
    graph, weights = _toy_graph()
    path = tmp_path / "toy.npz"
    np.savez(path, __graph__=np.asarray(json.dumps(graph)), **weights)
    x = np.random.default_rng(10).integers(0, 256, (2, 23, 23, 3),
                                           dtype=np.uint8)
    fn = extractor.load_extractor(path, device="cpu")
    got = fn(x)
    want = jax_extractor.load_extractor(path)(x)
    assert got.dtype == np.float64 and fn.graph == graph
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()

    np.savez(tmp_path / "nograph.npz", w=np.zeros(2))
    bad = dict(graph, format_version=2)
    np.savez(tmp_path / "v2.npz", __graph__=np.asarray(json.dumps(bad)))
    odd = dict(graph, layers=graph["layers"] + [
        {"name": "sm", "type": "softmax", "inputs": ["gap"]}])
    np.savez(tmp_path / "odd.npz", __graph__=np.asarray(json.dumps(odd)),
             **weights)
    lost = dict(graph, output="nowhere")
    np.savez(tmp_path / "lost.npz", __graph__=np.asarray(json.dumps(lost)),
             **weights)
    for name in ("nograph", "v2", "odd", "lost"):
        file = tmp_path / f"{name}.npz"
        with pytest.raises(ValueError) as want_err:
            jax_extractor.load_extractor(file)
        with pytest.raises(ValueError) as got_err:
            extractor.load_extractor(file, device="cpu")
        assert str(got_err.value) == str(want_err.value)
