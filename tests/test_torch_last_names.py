"""The last public names the port took from the JAX package, against it:
``ArrayDataset``'s ``drop_remainder`` (and ``StreamingDataset``'s, which
shares its arithmetic), ``config.json2dict`` / ``dict2json`` /
``json2namespace`` and ``data.augment.denormalize_to_unit``."""

import numpy as np
import pytest
import torch

from cyclegan_tpu_torch import config
from cyclegan_tpu_torch.data import augment
from cyclegan_tpu_torch.data.pipeline import (
    ArrayDataset,
    epoch_batches,
    epoch_limit,
)


def _batches(dataset, batch, drop_remainder):
    return ([(a[:, 0].tolist(), b[:, 0].tolist()) for a, b in
             dataset.batches(batch, 1, drop_remainder=drop_remainder)],
            dataset.num_batches(batch, drop_remainder=drop_remainder))


@pytest.mark.parametrize("process_count", [1, 2])
@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_drop_remainder_matches_jax(process_count, drop_remainder, shuffle):
    from cyclegan_tpu.data.pipeline import ArrayDataset as JaxDataset

    a, b = np.arange(23)[:, None], np.arange(100, 126)[:, None]
    for index in range(process_count):
        shard = dict(shuffle=shuffle, seed=3, process_index=index,
                     process_count=process_count)
        got = _batches(ArrayDataset(a, b, **shard), 3, drop_remainder)
        want = _batches(JaxDataset(a, b, **shard), 3, drop_remainder)
        assert got == want
        if process_count == 1 and not drop_remainder:
            assert len(got[0][-1][0]) == 23 % 3  # the partial tail
        else:
            assert all(len(x) == 3 for x, _ in got[0])


def test_epoch_arithmetic():
    assert [epoch_limit(23, 3, p, d) for p, d in
            ((1, True), (1, False), (2, True), (2, False))] == [21, 23, 18,
                                                                 18]
    assert [epoch_batches(23, 3, p, d) for p, d in
            ((1, True), (1, False), (2, True), (2, False))] == [7, 8, 3, 3]


def test_json_helpers_match_jax(tmp_path):
    from cyclegan_tpu import config as jax_config

    data = {"name": "m", "epochs": 3, "rates": [0.5, 1e-4],
            "nested": {"flag": True, "none": None}}
    path = tmp_path / "c.json"
    config.dict2json(data, path)
    jax_path = tmp_path / "jax.json"
    jax_config.dict2json(data, str(jax_path))
    assert path.read_text() == jax_path.read_text()
    assert config.json2dict(path) == jax_config.json2dict(str(path)) == data
    ns = config.json2namespace(path)
    assert isinstance(ns, config.Namespace)
    assert ns.nested.flag is True and ns.rates == [0.5, 1e-4]


def test_denormalize_to_unit_matches_jax():
    import jax.numpy as jnp

    from cyclegan_tpu.data.augment import denormalize_to_unit as jax_unit

    x = np.random.default_rng(0).uniform(-1, 1, (2, 4, 4, 3)).astype(
        np.float32)
    want = np.asarray(jax_unit(jnp.asarray(x)))
    got = augment.denormalize_to_unit(torch.from_numpy(x))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(augment.denormalize_to_unit(x), want)
