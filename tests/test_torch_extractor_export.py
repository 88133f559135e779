"""The port's ``export_keras_extractor`` against the JAX package's, on
``tests/test_extractor.py``'s toy Inception-like Keras model (every
supported layer type, batch norm statistics randomized): the same graph
JSON and the same arrays, bit for bit, and the port's ``load_extractor``
on its own file within 1e-3 of the Keras forward (the JAX test's bound).
The port's module never imports TensorFlow: the model comes from the
caller.
"""

import json

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from cyclegan_tpu_torch.utils.extractor import (  # noqa: E402
    export_keras_extractor,
    load_extractor,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def toy():
    from tests.test_extractor import _randomize_bn_stats, _toy_inception_like

    model = _toy_inception_like()
    _randomize_bn_stats(model, 1)
    return model


@pytest.fixture(scope="module")
def exports(toy, tmp_path_factory):
    from cyclegan_tpu.utils.extractor import \
        export_keras_extractor as jax_export

    out = tmp_path_factory.mktemp("extractor")
    return (export_keras_extractor(toy, out / "port.npz", image_size=64),
            jax_export(toy, out / "jax.npz", image_size=64))


def test_export_equals_the_jax_exporters(exports):
    port, jax_file = exports
    with np.load(port) as got, np.load(jax_file) as want:
        assert sorted(got.files) == sorted(want.files)
        assert json.loads(str(got["__graph__"])) == json.loads(
            str(want["__graph__"]))
        for key in want.files:
            if key != "__graph__":
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=key)


def test_port_extractor_matches_keras(toy, exports):
    extractor = load_extractor(exports[0], device="cpu")
    x = np.random.default_rng(2).uniform(-1, 1, (4, 64, 64, 3)).astype(
        np.float32)
    theirs = toy(x, training=False).numpy()
    ours = extractor(x)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, atol=1e-3, rtol=1e-3)


def test_export_refuses_an_unsupported_layer(tmp_path):
    inp = tf.keras.Input((8, 8, 3))
    model = tf.keras.Model(inp, tf.keras.layers.Dense(2)(inp))
    with pytest.raises(ValueError, match="unsupported Keras layer"):
        export_keras_extractor(model, tmp_path / "bad.npz")
