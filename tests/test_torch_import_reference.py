"""The port's reference importer (``apps/import_reference.py``) and its
TensorFlow-free bundle reader (``utils/tensor_bundle.py``) against
TensorFlow and the JAX package's importer, on the CPU.

The artifact is built as ``tests/test_import_reference.py`` builds it: the
default recipe's TF models at 32x32 (``build_tf_models``), each written as
a SavedModel variables bundle with the key space of a TF-2.7 save
(``write_reference_savedmodel(tf27_extras=True)``: optimizer-slot
mirrors, hyperparameters, save counter, Keras bookkeeping, the object
graph), Adam ``.npy`` slots (``write_adam_npy``, iterations 1234), samples
and configs. Checks: the reader's arrays equal ``tf.train.load_checkpoint``'s
exactly, for every layer key and on a bundle of several data blocks; the
skipped keys are classified as the JAX reader classifies them; the two
``ValueError``s and a compressed block raise; the port's
``checkpoint.npz`` equals the JAX importer's leaf for leaf, bit for bit
(Adam slots, ``step`` and ``rng`` included), and each package loads the
other's; the import serves through the port's ``InferenceSession`` (f32)
within 1e-4 of the JAX session's generator outputs (below); it resumes
one step in the port's trainer; a process where TensorFlow cannot be
imported imports it; ``chip_smoke.write_bundle``'s bundles read back in
TensorFlow.

The generator outputs are held within 1e-4 of JAX's, not 1e-5: on this
network each f32 forward is itself 1.1-1.5e-5 from the port's f64 forward
of the same weights (measured on the CPU), so two f32 implementations
differ by 2-5e-5 with the thread count and the layout.
"""

import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from cyclegan_tpu_torch.apps import \
    import_reference as port_import  # noqa: E402
from cyclegan_tpu_torch.utils.tensor_bundle import TensorBundle  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
NETWORKS = ("g_AB", "g_BA", "d_A", "d_B")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference_artifact(tmp_path_factory):
    """The JAX test's fabricated reference folder and its TF models."""
    from tests.test_import_reference import reference_artifact as build

    return build.__wrapped__(tmp_path_factory)


@pytest.fixture(scope="module")
def imports(reference_artifact, tmp_path_factory):
    """(the port's import folder via its CLI, the JAX importer's)."""
    from cyclegan_tpu.apps.import_reference import import_reference_model

    folder = reference_artifact[0]
    out = tmp_path_factory.mktemp("imports")
    assert port_import.main(["--model_dir", str(folder), "--output",
                             str(out / "port"), "--device", "cpu"]) == 0
    import_reference_model(folder, out / "jax")
    return out / "port", out / "jax"


def _bundle(folder, name):
    return folder / name / "variables" / "variables"


def test_reader_equals_tensorflow_on_every_layer_key(reference_artifact):
    folder = reference_artifact[0]
    for name in NETWORKS:
        bundle = TensorBundle(_bundle(folder, name))
        reader = tf.train.load_checkpoint(str(_bundle(folder, name)))
        shapes = reader.get_variable_to_shape_map()
        assert set(bundle.entries) == set(shapes)
        layer_keys = [k for k in shapes
                      if port_import._LAYER_KEY.match(k)]
        assert layer_keys
        for key in layer_keys:
            got, want = bundle.tensor(key), reader.get_tensor(key)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=key)
        for key, shape in shapes.items():
            assert list(bundle.entries[key].shape) == list(shape), key


def test_reader_equals_tensorflow_across_data_blocks(tmp_path):
    """6000 keys fill two data blocks of TensorFlow's table; float32,
    float64 and float16 tensors."""
    names = [f"layer_with_weights-{i}/kernel/.ATTRIBUTES/VARIABLE_VALUE"
             for i in range(6000)]
    values = [np.float32(i) for i in range(6000)]
    names += ["d", "h"]
    values += [np.arange(3, dtype=np.float64), np.ones(2, np.float16)]
    prefix = tmp_path / "v"
    tf.raw_ops.SaveV2(prefix=str(prefix), tensor_names=names,
                      shape_and_slices=[""] * len(names),
                      tensors=[tf.constant(v) for v in values])
    bundle = TensorBundle(prefix)
    reader = tf.train.load_checkpoint(str(prefix))
    for key in names:
        got, want = bundle.tensor(key), reader.get_tensor(key)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=key)


def _skipped_kinds(reader_fn, logger, caplog, path):
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=logger):
        layers = reader_fn(path)
    return layers, sorted(r.getMessage().split(": ", 1)[1]
                          for r in caplog.records if "skipped" in
                          r.getMessage())


def test_skipped_keys_classified_as_jax(reference_artifact, tmp_path,
                                        caplog):
    from cyclegan_tpu.apps import import_reference as jax_import

    unknown = tmp_path / "m"
    names = ["layer_with_weights-0/kernel/.ATTRIBUTES/VARIABLE_VALUE",
             "layer_with_weights-0/kernel/extra/.ATTRIBUTES/VARIABLE_VALUE",
             "some_future_tf_feature/state/.ATTRIBUTES/VARIABLE_VALUE"]
    (unknown / "variables").mkdir(parents=True)
    tf.raw_ops.SaveV2(prefix=str(unknown / "variables" / "variables"),
                      tensor_names=names, shape_and_slices=[""] * 3,
                      tensors=[tf.constant(np.ones((1, 1), np.float32))] * 3)
    for path in (reference_artifact[0] / "g_AB", unknown):
        got_layers, got = _skipped_kinds(
            port_import.read_savedmodel_layers, port_import.__name__,
            caplog, path)
        want_layers, want = _skipped_kinds(
            jax_import.read_savedmodel_layers, jax_import.__name__, caplog,
            path)
        assert got == want and got
        assert len(got_layers) == len(want_layers)
        for g, w in zip(got_layers, want_layers):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("names, match", [
    (["layer_with_weights-0/kernel/.ATTRIBUTES/VARIABLE_VALUE",
      "layer_with_weights-2/kernel/.ATTRIBUTES/VARIABLE_VALUE"],
     "not contiguous"),
    (["save_counter/.ATTRIBUTES/VARIABLE_VALUE"], "no layer_with_weights"),
])
def test_reader_value_errors(tmp_path, names, match):
    prefix = tmp_path / "m" / "variables" / "variables"
    prefix.parent.mkdir(parents=True)
    tf.raw_ops.SaveV2(prefix=str(prefix), tensor_names=names,
                      shape_and_slices=[""] * len(names),
                      tensors=[tf.constant(np.ones((1, 1), np.float32))]
                      * len(names))
    with pytest.raises(ValueError, match=match):
        port_import.read_savedmodel_layers(tmp_path / "m")


def test_compressed_block_raises(reference_artifact, tmp_path):
    """The data block's type byte set to 1 (snappy) is refused."""
    import shutil

    from cyclegan_tpu_torch.utils.tensor_bundle import (
        _block_entries,
        _block_handle,
    )

    src = reference_artifact[0] / "d_A"
    shutil.copytree(src, tmp_path / "d_A")
    index = _bundle(tmp_path, "d_A").with_suffix(".index")
    data = bytearray(index.read_bytes())
    _, _, pos = _block_handle(bytes(data[-48:]), 0)
    offset, size, _ = _block_handle(bytes(data[-48:]), pos)
    _, handle = next(_block_entries(bytes(data[offset:offset + size])))
    block_offset, block_size, _ = _block_handle(handle, 0)
    data[block_offset + block_size] = 1
    index.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="compression type 1"):
        port_import.read_savedmodel_layers(tmp_path / "d_A")


def test_checkpoint_equals_the_jax_importers(imports):
    port, jax_dir = imports
    with np.load(port / "checkpoint.npz") as got, \
            np.load(jax_dir / "checkpoint.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert int(got["step"]) == 1234
        for name in NETWORKS:
            assert int(got[f"opt_state/{name}/0/count"]) == 1234
    for sample in ("a_samples.npy", "b_samples.npy"):
        np.testing.assert_array_equal(np.load(port / sample),
                                      np.load(jax_dir / sample))


def test_each_package_loads_the_others_import(imports):
    """The JAX package's loader takes the port's folder and the port's
    loader the JAX package's: the same parameters either way."""
    import jax

    from cyclegan_tpu.apps.inference import InferenceSession as JaxSession
    from cyclegan_tpu_torch.apps.inference import InferenceSession

    port, jax_dir = imports
    from cyclegan_tpu_torch.config import yaml2namespace

    assert yaml2namespace(port / "model_config.yaml").new is False
    jax_params = jax.tree.map(np.asarray, JaxSession(port).state.params)
    for name, model in InferenceSession(jax_dir, device="cpu").models.items():
        from cyclegan_tpu_torch.weights import jax_params_to_torch

        want = jax_params_to_torch(jax_params[name])
        for key, p in model.named_parameters():
            np.testing.assert_array_equal(p.numpy(), want[key].numpy())


def test_import_serves_as_the_jax_session(imports):
    import jax.numpy as jnp

    from cyclegan_tpu.apps.inference import InferenceSession as JaxSession
    from cyclegan_tpu_torch.apps.inference import InferenceSession
    from cyclegan_tpu_torch.ops import layout

    port, _ = imports
    session = InferenceSession(port, "float32", device="cpu")
    jax_session = JaxSession(port, "float32")
    x = np.random.default_rng(11).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    images = np.random.default_rng(3).integers(0, 256, (2, 32, 32, 3),
                                               dtype=np.uint8)
    for direction, name in (("a2b", "g_AB"), ("b2a", "g_BA")):
        with torch.inference_mode(), layout.nhwc():
            got = session.models[name](torch.from_numpy(x)).numpy()
        want, _ = jax_session.models[name].apply(
            jax_session.state.params[name],
            jax_session.state.model_state[name], jnp.asarray(x),
            train=False)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
        diff = np.abs(session.stylize(images, direction).astype(int)
                      - jax_session.stylize(images, direction))
        assert diff.max() <= 1


def test_import_resumes_in_the_port_trainer(imports):
    from cyclegan_tpu_torch.config import yaml2namespace
    from cyclegan_tpu_torch.trainer import CycleGan

    port, _ = imports
    model_config = yaml2namespace(port / "model_config.yaml")
    train_config = yaml2namespace(port / "train_config.yaml")
    model_config.location = str(port.parent)
    model_config.name = port.name
    train_config.compute_dtype = "float32"
    gan = CycleGan(model_config, train_config, device="cpu")
    assert gan.state.step == 1234
    opt = gan.state.optimizers["g_AB"]
    assert all(int(opt.state[p]["step"]) == 1234
               for p in gan.state.models["g_AB"].parameters())
    rng = np.random.default_rng(0)
    a, b = (rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
            for _ in range(2))
    metrics = gan.train_step_fn(gan.state, *gan._put(a, b))
    assert gan.state.step == 1235
    assert all(int(opt.state[p]["step"]) == 1235
               for p in gan.state.models["g_AB"].parameters())
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_imports_where_tensorflow_cannot_be_imported(reference_artifact,
                                                     imports, tmp_path):
    out = tmp_path / "no_tf"
    folder = str(reference_artifact[0])
    code = (
        "import sys\n"
        "sys.modules['tensorflow'] = None\n"
        "from cyclegan_tpu_torch.apps import import_reference\n"
        f"import_reference.import_reference_model({folder!r}, "
        f"{str(out)!r}, device='cpu')\n"
        "assert sys.modules['tensorflow'] is None\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
    with np.load(out / "checkpoint.npz") as got, \
            np.load(imports[0] / "checkpoint.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_chip_smoke_bundles_read_in_tensorflow(tmp_path):
    import chip_smoke

    rng = np.random.default_rng(5)
    tensors = {
        "layer_with_weights-0/kernel/.ATTRIBUTES/VARIABLE_VALUE":
            rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
        "layer_with_weights-0/bias/.ATTRIBUTES/VARIABLE_VALUE":
            np.zeros(4, np.float32),
        "layer_with_weights-1/gamma/.ATTRIBUTES/VARIABLE_VALUE":
            rng.normal(size=(4,)).astype(np.float64),
        "scalar": np.float32(2.5),
        "half": np.ones((2, 2), np.float16)}
    prefix = tmp_path / "variables" / "variables"
    chip_smoke.write_bundle(prefix, tensors)
    reader = tf.train.load_checkpoint(str(prefix))
    assert set(reader.get_variable_to_shape_map()) == set(tensors)
    bundle = TensorBundle(prefix)
    for key, value in tensors.items():
        want = np.asarray(value)
        for got in (reader.get_tensor(key), bundle.tensor(key)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=key)
