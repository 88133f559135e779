"""The port's streaming loader against the JAX package's, on the CPU.

Two domains of 13 and 11 seeded images, written by JAX's writer at 24x24
and streamed at 16x16 (a resize) and at 24x24 (none): the record index,
the split, every batch of two epochs, ``take_pairs`` and the slices of two
processes must equal JAX's streaming loader's exactly (both decode the
same PNGs and resize with cv2). Where nothing is resized, the streamed
batches equal the memory loader's exactly. The trainer CLI trains with
``data_loader: streaming``.
"""

import numpy as np
import pytest

from cyclegan_tpu.data import codec as jax_codec
from cyclegan_tpu.data import streaming as jax_streaming
from cyclegan_tpu.data import tfrecord as jax_tfrecord
from cyclegan_tpu_torch.config import namespace2yaml
from cyclegan_tpu_torch.data import pipeline, streaming
from cyclegan_tpu_torch.train import main as train_main
from tests.test_torch_trainer import tiny_model_config, tiny_train_config


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("streaming")
    out = []
    for name, n, seed in (("a", 13, 4), ("b", 11, 5)):
        rng = np.random.default_rng(seed)
        paths = []
        for part in range(2):  # two shards a domain
            path = root / f"{name}{part}.tfrecords"
            jax_tfrecord.write_tfrecord_file(path, (
                jax_codec.image2example(rng.integers(0, 256, (24, 24, 3),
                                                     dtype=np.uint8))
                for _ in range(n // 2 + part * (n % 2))))
            paths.append(str(path))
        out.append(paths)
    return out


def _same(got, want):
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.uint8


def test_index_shard_matches_jax(shards):
    for path in shards[0] + shards[1]:
        assert streaming.index_shard(path) == jax_streaming.index_shard(path)


@pytest.mark.parametrize("width", [16, 24])
def test_batches_match_jax(shards, width):
    got = streaming.create_streaming_dataset(*shards, width=width, seed=5)
    want = jax_streaming.create_streaming_dataset(*shards, width=width,
                                                  seed=5)
    # int(0.2 * 13) = 2 validation records per domain
    assert [len(d) for d in got] == [len(d) for d in want] == [9, 2]
    for g, w in zip(got, want):
        assert g.refs_a == w.refs_a and g.refs_b == w.refs_b
        assert g.num_batches(3) == w.num_batches(3)
        for epoch in (0, 1):
            pairs = list(zip(g.batches(3, epoch), w.batches(3, epoch)))
            assert len(pairs) == g.num_batches(3)
            for (ga, gb), (wa, wb) in pairs:
                _same(ga, wa)
                _same(gb, wb)
        for ga, wa in zip(g.take_pairs(4), w.take_pairs(4)):
            _same(ga, wa)


@pytest.mark.parametrize("index", [0, 1])
def test_process_slices_match_jax(shards, index):
    """Two processes each take their slice of every global batch."""
    got, _ = streaming.create_streaming_dataset(
        *shards, width=16, seed=5, process_index=index, process_count=2)
    want, _ = jax_streaming.create_streaming_dataset(
        *shards, width=16, seed=5, process_index=index, process_count=2)
    assert got.num_batches(2) == want.num_batches(2) == 2
    for (ga, gb), (wa, wb) in zip(got.batches(2, 3), want.batches(2, 3)):
        _same(ga, wa)
        _same(gb, wb)


def test_streaming_equals_memory_loader(shards):
    streamed = streaming.create_streaming_dataset(*shards, width=24, seed=5)
    memory = pipeline.create_dataset(*shards, width=24, seed=5)
    for s, m in zip(streamed, memory):
        for epoch in (0, 1):
            for (sa, sb), (ma, mb) in zip(s.batches(3, epoch),
                                          m.batches(3, epoch)):
                _same(sa, ma)
                _same(sb, mb)
        for sp, mp in zip(s.take_pairs(2), m.take_pairs(2)):
            _same(sp, mp)


def test_bad_process_index_raises():
    with pytest.raises(ValueError, match="process_index"):
        streaming.StreamingDataset([], [], 16, process_index=2,
                                   process_count=2)


def _records(root):
    rng = np.random.default_rng(7)
    for domain in ("tabby_records", "tortie_records"):
        (root / domain).mkdir(parents=True)
        jax_tfrecord.write_tfrecord_file(
            root / domain / "00000.tfrecords",
            (jax_codec.image2example(im) for im in rng.integers(
                0, 256, (6, 16, 16, 3), dtype=np.uint8)))


@pytest.mark.parametrize("loader", ["streaming", "lazy"])
def test_cli_data_loader(tmp_path, loader):
    """``data_loader: streaming`` trains (6 images: 1 for validation, 2
    batches of 2); anything but memory or streaming raises ValueError, as
    the JAX CLI does."""
    _records(tmp_path / "data")
    model_yaml, train_yaml = tmp_path / "model.yaml", tmp_path / "train.yaml"
    namespace2yaml(model_yaml, tiny_model_config(tmp_path / "models"))
    namespace2yaml(train_yaml, tiny_train_config(data_loader=loader,
                                                 tpu_layout=True))
    args = ["--model_config", str(model_yaml), "--train_config",
            str(train_yaml), "--data_dir", str(tmp_path / "data"),
            "--device", "cpu"]
    if loader != "streaming":
        with pytest.raises(ValueError, match="unknown data_loader"):
            train_main(args)
        return
    gan = train_main(args)
    assert gan.state.step == 2 and gan.tpu_layout
    assert len(gan.history) == 1 and gan.history[0]["validation_steps"] == 0
