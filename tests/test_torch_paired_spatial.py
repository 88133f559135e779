"""The paired train step (``make_train_step(paired=True)``) on two H strips,
two gloo ranks of the CPU, against the JAX package's paired step on a
spatial mesh of its CPU devices.

The paired step ``torch.func.vmap``s the twin networks; under a strip
scope its convs exchange halos and its norms sum their statistics through
``ops/spatialctx.py``'s collectives, whose ``vmap`` rules fold the twins
into the batch and run each collective once. The recipe and point are
``tests/test_torch_spatial_step.py``'s (the tiny U-Nets of JAX's
``tests/test_spatial_shard_map.py`` ``_cyclegan_setup``, batch 4 at 32x32,
every affine beta at +-(3..4), so no ReLU decision flips between
implementations), f32, NHWC. With and without ``shard_map_dp`` the
metrics must be within 1e-5 relative and the surrogate gradients within
1e-5 of JAX's (relatively, or relative to the network's largest
gradient), as must the port's own unsharded paired step's gradients. The
twins must not double the collectives: a paired step issues half the
strip collectives of the unpaired one (3 generator rounds and 3
discriminator applications against 6 and 6), plus the same two
all-reduces of the gradients and the metrics.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cyclegan_tpu_torch import steps
from cyclegan_tpu_torch.parallel import create_spatial_mesh, run_ranks, \
    shard_batch
from tests.test_torch_spatial_step import (
    NETWORKS,
    WEIGHTS,
    assert_close_to_jax,
    jax_grads,
    jax_params,
    jax_state,
    make_point,
    port_state,
    snapshot,
)

SMAPS = (False, True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _counted(step, state, batch):
    """The step's metrics and the number of all-reduces it issued."""
    calls = [0]
    all_reduce = dist.all_reduce

    def counting(*args, **kwargs):
        calls[0] += 1
        return all_reduce(*args, **kwargs)

    dist.all_reduce = counting
    try:
        metrics = step(state, *batch)
    finally:
        dist.all_reduce = all_reduce
    return metrics, calls[0]


def _paired_worker(rank, world, point):
    mesh = create_spatial_mesh(data=1, spatial=world)
    params, model_state, a, b = point
    batch = shard_batch(mesh, (torch.from_numpy(a), torch.from_numpy(b)),
                        spatial_axis="spatial")
    out = {}
    for smap in SMAPS:
        for paired in (True, False):
            state = port_state(params, model_state)
            step = steps.make_train_step(
                "mse", WEIGHTS, "float32", tpu_layout=False, paired=paired,
                mesh=mesh, spatial_axis="spatial", shard_map_dp=smap)
            metrics, calls = _counted(step, state, batch)
            out[(smap, paired)] = snapshot(state, metrics) + (calls,)
    return out


@pytest.fixture(scope="module")
def point():
    return make_point()


@pytest.fixture(scope="module")
def ranks(point):
    return run_ranks(_paired_worker, 2, (point,), timeout=300)


@pytest.fixture(scope="module")
def jax_paired(point):
    """JAX's paired step on a (1 x 2) spatial mesh, GSPMD and shard_map."""
    import jax.numpy as jnp

    from cyclegan_tpu import steps as jax_steps
    from cyclegan_tpu.parallel import replicate
    from cyclegan_tpu.parallel.spatial import create_spatial_mesh as \
        jax_spatial_mesh
    from cyclegan_tpu.parallel.spatial import shard_spatial

    params, model_state, a, b = point
    mesh = jax_spatial_mesh(data=1, spatial=2)
    out = {}
    for smap in SMAPS:
        models, optimizers, state = jax_state(params, model_state)
        state = replicate(mesh, state)
        xa, xb = shard_spatial(mesh, (jnp.asarray(a), jnp.asarray(b)))
        state, metrics = jax_steps.make_train_step(
            models, optimizers, "mse", WEIGHTS, donate=False, paired=True,
            mesh=mesh, mesh_axis="data", spatial_axis="spatial",
            shard_map_dp=smap)(state, xa, xb)
        out[smap] = ({k: np.asarray(v) for k, v in metrics.items()},
                     jax_params(state), jax_grads(state))
    return out


@pytest.mark.parametrize("shard_map_dp", SMAPS)
def test_paired_spatial_step_matches_jax(ranks, jax_paired, shard_map_dp):
    for r in ranks:
        assert_close_to_jax(r[(shard_map_dp, True)][:3],
                            *jax_paired[shard_map_dp])


@pytest.mark.parametrize("shard_map_dp", SMAPS)
def test_paired_spatial_gradients_match_unsharded_paired_step(
        point, ranks, shard_map_dp):
    params, model_state, a, b = point
    state = port_state(params, model_state)
    steps.make_train_step("mse", WEIGHTS, "float32", tpu_layout=False,
                          paired=True)(state, torch.from_numpy(a),
                                       torch.from_numpy(b))
    want = snapshot(state)[2]
    got = ranks[0][(shard_map_dp, True)][2]
    for n in NETWORKS:
        top = max(np.abs(g).max() for g in want[n].values())
        for k, g in want[n].items():
            np.testing.assert_allclose(got[n][k], g, rtol=1e-5,
                                       atol=1e-5 * top, err_msg=f"{n} {k}")


@pytest.mark.parametrize("shard_map_dp", SMAPS)
def test_paired_twins_share_each_collective(ranks, shard_map_dp):
    """Half the unpaired step's strip collectives, on every rank alike."""
    for r in ranks:
        paired = r[(shard_map_dp, True)][3]
        unpaired = r[(shard_map_dp, False)][3]
        assert 2 * (paired - 2) == unpaired - 2, (paired, unpaired)
        assert paired == ranks[0][(shard_map_dp, True)][3]
