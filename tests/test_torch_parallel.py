"""Data parallelism in the port on two gloo ranks of the CPU: the mesh
helpers (``parallel/mesh.py``, ``parallel/spatial.py``), the train step on
a 2-rank data mesh against the JAX package's steps, batch norm with
``dp_shard_map`` both ways, the jitter's draws, and the data loaders'
process sharding.

The ResNet recipe (``configs/resnet.yaml`` cut as in
``tests/test_torch_resnet.py``: generator filters 4, PatchGAN 8/16/32, its
kink-free parameter seed) runs on two data ranks too, batch 2 at 32x32, one
per rank, NHCW (K9, K9-dW, K10 and the rest on their plain versions). Its
averaged f32 gradients equal the mean of the port's two batch-1 steps
within 1e-6 of the network's largest gradient (the ranks add nothing but
the mean), and are within 1e-4 of JAX's jitted single-device step's,
relatively or relative to that largest gradient: 1e-4 is
``tests/test_torch_resnet.py``'s f32 bound for this recipe, whose
generator gradients at this point move by 2-3e-5 of their largest when
only the batch is split differently (the port's batch-2 step against the
mean of its batch-1 steps), so no f32 implementation meets 1e-5 here.

The step runs on the recipe and point of ``tests/test_torch_spatial_step.py``
(batch 4 at 32x32, 2 per rank, f32, NHCW on the kernels' plain versions),
with the same bounds: metrics, parameters and gradients within 1e-5 of
JAX's. Without
``dp_shard_map`` a batch norm's statistics span both ranks, which is the
JAX single-device step's (its GSPMD path computes global statistics); with
it, each rank's own, which is JAX's ``shard_map`` step on a 2-device mesh.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cyclegan_tpu_torch import steps
from cyclegan_tpu_torch.data.augment import random_jitter_batch
from cyclegan_tpu_torch.data.pipeline import ArrayDataset
from cyclegan_tpu_torch.parallel import (
    create_mesh,
    create_spatial_mesh,
    replicate,
    run_ranks,
    shard_batch,
    shard_spatial,
)
from cyclegan_tpu_torch.parallel.spatial import check_spatial_divisibility
from tests.test_torch_spatial_step import (
    BATCH,
    NETWORKS,
    SIZE,
    WEIGHTS,
    _by_port_name,
    assert_close_to_jax,
    jax_grads,
    jax_params,
    jax_state,
    make_point,
    port_state,
    snapshot,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _moving(state):
    return {n: {k: b.numpy().copy() for k, b in
                state.models[n].named_buffers()} for n in NETWORKS}


def _jitter(generator, a, b, rows=None):
    return (random_jitter_batch(generator, a, SIZE, rows),
            random_jitter_batch(generator, b, SIZE, rows))


def _dp_worker(rank, world, point, bn_point, images):
    mesh = create_mesh(world)
    out = {"coords": mesh.coords, "backend": mesh.backend}
    for name, (params, model_state, a, b), norm in (
            ("in", point, "instancenorm"), ("bn", bn_point, "batchnorm")):
        for smap in (False, True):
            state = port_state(params, model_state, norm)
            metrics = steps.make_train_step(
                "mse", WEIGHTS, mesh=mesh, shard_map_dp=smap)(
                state, *shard_batch(mesh, (torch.from_numpy(a),
                                           torch.from_numpy(b))))
            out[(name, smap)] = snapshot(state, metrics) + (_moving(state),)
    # the jitter's draws: the global batch's without dp_shard_map
    params, model_state, _, _ = point
    state = port_state(params, model_state)
    steps.make_train_step("mse", WEIGHTS, preprocess=_jitter, mesh=mesh)(
        state, *shard_batch(mesh, (torch.from_numpy(images),) * 2))
    out["jitter"] = snapshot(state)
    # and the generators' dropout masks likewise
    params, model_state, a, b = point
    state = port_state(params, model_state, dropout=True)
    steps.make_train_step("mse", WEIGHTS, mesh=mesh)(
        state, *shard_batch(mesh, (torch.from_numpy(a),
                                   torch.from_numpy(b))))
    out["dropout"] = snapshot(state)
    # with it, per-rank generators from one draw of the state's
    par = steps._parallel(mesh, "data", None, True, True)
    jitter, _, _, _ = par.draws(port_state(params, model_state),
                                BATCH // 2)
    out["draw"] = torch.rand(4, generator=jitter).numpy()
    out["errors"] = _errors(mesh)
    out["replicated"] = _replicated(mesh, rank)
    a = np.arange(20)[:, None]
    train = ArrayDataset(a, a + 100, shuffle=True, seed=1,
                         process_index=mesh.index("data"),
                         process_count=mesh.axis_size("data"))
    out["batches"] = [x[:, 0].tolist() for x, _ in train.batches(3, 1)]
    out["num_batches"] = train.num_batches(3)
    return out


RESNET_CFG = {"generator": {"type": "resnet_generator", "filters": 4},
              "discriminator": {"type": "simple_discriminator",
                                "filters": [8, 16, 32], "kernels": [4, 4, 4],
                                "normalization": "instancenorm"},
              "loss": "mse", "loss_weights": dict(
                  cycle=10.0, identity=5.0, generator=1.0,
                  discriminator=0.5)}
RESNET_SEED = 22  # tests/test_torch_resnet.py's kink-free PARAM_SEED


def _resnet_grads(params, a, b, mesh=None):
    """The gradients the ResNet recipe's f32 step leaves (on ``mesh``,
    averaged over it, with a and b this rank's blocks)."""
    from cyclegan_tpu_torch.weights import load_jax_params

    models = steps.build_models(RESNET_CFG)
    load_jax_params(models, params)
    adam = dict(name="adam", learning_rate=2e-4, beta_1=0.5)
    state = steps.init_train_state(models, dict(g_opt=adam, d_opt=adam),
                                   device="cpu")
    steps.make_train_step("mse", RESNET_CFG["loss_weights"], mesh=mesh)(
        state, torch.from_numpy(a), torch.from_numpy(b))
    return snapshot(state)[2]


def _resnet_worker(rank, world, point):
    params, a, b = point
    mesh = create_mesh(world)
    half = a.shape[0] // world
    rows = slice(rank * half, (rank + 1) * half)
    return _resnet_grads(params, a[rows], b[rows], mesh)


def _errors(mesh):
    said = []
    spatial = create_spatial_mesh(data=1, spatial=2)
    for fn in (lambda: shard_batch(mesh, torch.zeros(3, 4, 4, 3)),
               lambda: create_mesh(3),
               lambda: create_mesh(1),
               lambda: check_spatial_divisibility(31, spatial),
               lambda: check_spatial_divisibility(
                   4, spatial, min_rows_per_shard=4),
               lambda: shard_spatial(create_spatial_mesh(data=2, spatial=1),
                                     torch.zeros(3, 4, 4, 3)),
               lambda: shard_batch(spatial, torch.zeros(2, 5, 4, 3),
                                   axis_name=None, spatial_axis="spatial")):
        try:
            fn()
            said.append(None)
        except ValueError as exc:
            said.append(str(exc))
    return said


def _replicated(mesh, rank):
    t = torch.full((3,), float(rank + 1))
    module = torch.nn.Linear(2, 2)
    with torch.no_grad():
        module.weight.fill_(rank + 5)
    replicate(mesh, {"t": t, "m": module})
    return t.tolist(), module.weight.flatten().tolist()


@pytest.fixture(scope="module")
def point():
    return make_point()


@pytest.fixture(scope="module")
def bn_point():
    return make_point("batchnorm")


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(4).integers(0, 256, (4, SIZE, SIZE, 3),
                                             dtype=np.uint8)


@pytest.fixture(scope="module")
def ranks(point, bn_point, images):
    return run_ranks(_dp_worker, 2, (point, bn_point, images), timeout=300)


@pytest.fixture(scope="module")
def resnet_point():
    """(params, a, b): the JAX tree of every ResNet-recipe network drawn
    with numpy from N(0, 0.1) at RESNET_SEED, and batches of 2 at SIZE."""
    import jax

    from cyclegan_tpu.models import create_model as jax_create_model

    shapes = {n: jax.eval_shape(jax_create_model(RESNET_CFG[
        "generator" if n.startswith("g") else "discriminator"]).init,
        jax.random.PRNGKey(0))[0] for n in NETWORKS}
    rng = np.random.default_rng(RESNET_SEED)
    params = {n: jax.tree.map(lambda leaf: (0.1 * rng.normal(
        size=leaf.shape)).astype(np.float32), shapes[n]) for n in NETWORKS}
    a, b = (np.random.default_rng(s).uniform(-1, 1, (2, SIZE, SIZE, 3))
            .astype(np.float32) for s in (2, 3))
    return params, a, b


@pytest.fixture(scope="module")
def resnet_ranks(resnet_point):
    return run_ranks(_resnet_worker, 2, (resnet_point,), timeout=300)


def _assert_grads_close(got, want, bound):
    for n in NETWORKS:
        assert got[n].keys() == want[n].keys(), n
        top = max(np.abs(g).max() for g in want[n].values())
        for k, g in want[n].items():
            np.testing.assert_allclose(got[n][k], g, rtol=bound,
                                       atol=bound * top, err_msg=f"{n} {k}")


def test_resnet_data_parallel_gradients_are_the_mean_of_rank_steps(
        resnet_point, resnet_ranks):
    params, a, b = resnet_point
    halves = [_resnet_grads(params, a[i:i + 1], b[i:i + 1])
              for i in range(2)]
    want = {n: {k: (halves[0][n][k] + halves[1][n][k]) / 2
                for k in halves[0][n]} for n in NETWORKS}
    for got in resnet_ranks:
        _assert_grads_close(got, want, 1e-6)


def test_resnet_data_parallel_gradients_match_jax_single_device(
        resnet_point, resnet_ranks):
    import jax
    import jax.numpy as jnp

    from cyclegan_tpu import steps as jax_steps
    from cyclegan_tpu.losses import get_loss_obj as jax_loss_obj
    from cyclegan_tpu.models import create_model as jax_create_model

    params, a, b = resnet_point
    models = {n: jax_create_model(RESNET_CFG[
        "generator" if n.startswith("g") else "discriminator"])
        for n in NETWORKS}
    model_state = {n: jax.eval_shape(models[n].init,
                                     jax.random.PRNGKey(0))[1]
                   for n in NETWORKS}

    def surrogate(p, x, y):
        total, _, _ = jax_steps._forward_losses(
            p, model_state, models, jax_loss_obj("mse"),
            RESNET_CFG["loss_weights"], x, y, train=True, rng=None,
            stop_grads=True)
        return total

    grads = jax.jit(jax.grad(surrogate))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(a), jnp.asarray(b))
    want = _by_port_name(grads)
    for got in resnet_ranks:
        _assert_grads_close(got, want, 1e-4)


def _jax_step(point, norm, mesh=False):
    import jax.numpy as jnp

    from cyclegan_tpu import steps as jax_steps

    params, model_state, a, b = point
    models, optimizers, state = jax_state(params, model_state, norm)
    kw = {}
    a, b = jnp.asarray(a), jnp.asarray(b)
    if mesh:
        from cyclegan_tpu.parallel import create_mesh as jax_mesh
        from cyclegan_tpu.parallel import replicate as jax_replicate
        from cyclegan_tpu.parallel import shard_batch as jax_shard

        kw = dict(mesh=jax_mesh(2), shard_map_dp=True)
        state = jax_replicate(kw["mesh"], state)
        a, b = jax_shard(kw["mesh"], (a, b))
    state, metrics = jax_steps.make_train_step(
        models, optimizers, "mse", WEIGHTS, donate=False, **kw)(state, a, b)
    return ({k: np.asarray(v) for k, v in metrics.items()},
            jax_params(state), jax_grads(state), state)


@pytest.fixture(scope="module")
def jax_in(point):
    return _jax_step(point, "instancenorm")


@pytest.fixture(scope="module")
def jax_bn(bn_point):
    return _jax_step(bn_point, "batchnorm")


@pytest.mark.parametrize("shard_map_dp", [False, True])
def test_data_parallel_step_matches_jax_single_device(jax_in, ranks,
                                                      shard_map_dp):
    for r in ranks:
        assert_close_to_jax(r[("in", shard_map_dp)][:3], *jax_in[:3])


def _assert_moving_close(got, jax_state_):
    import jax

    from cyclegan_tpu_torch.weights import jax_params_to_torch

    for n in NETWORKS:
        want = jax_params_to_torch(jax.tree.map(
            np.asarray, jax_state_.model_state[n]))
        assert got[n].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got[n][k], v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{n} {k}")


def test_batch_norm_global_statistics_match_jax_single_device(jax_bn,
                                                              ranks):
    """Without dp_shard_map the statistics span the global batch."""
    for r in ranks:
        got = r[("bn", False)]
        assert_close_to_jax(got[:3], *jax_bn[:3])
        _assert_moving_close(got[3], jax_bn[3])


def test_batch_norm_per_shard_statistics_match_jax_shard_map(bn_point,
                                                             jax_bn, ranks):
    """With dp_shard_map each rank's batch has its own statistics, as in
    JAX's shard_map step; rank 0's moving statistics are every rank's (the
    shard JAX's replicated output returns)."""
    want = _jax_step(bn_point, "batchnorm", mesh=True)
    single = jax_bn[0]
    assert any(abs(float(single[k]) - float(v)) > 1e-4
               for k, v in want[0].items()), "per-shard = global statistics"
    for r in ranks:
        got = r[("bn", True)]
        assert_close_to_jax(got[:3], *want[:3])
        _assert_moving_close(got[3], want[3])


def test_jitter_draw_is_the_single_device_draw(point, images, ranks):
    """Without dp_shard_map the ranks' jittered halves are the single
    device's batch: the step equals the unsharded port step."""
    params, model_state, _, _ = point
    state = port_state(params, model_state)
    steps.make_train_step("mse", WEIGHTS, preprocess=_jitter)(
        state, torch.from_numpy(images), torch.from_numpy(images))
    _, want, _ = snapshot(state)
    for r in ranks:
        for n in NETWORKS:
            for k, v in want[n].items():
                np.testing.assert_allclose(r["jitter"][1][n][k], v, rtol=0,
                                           atol=1e-5, err_msg=f"{n} {k}")


def test_dropout_draw_is_the_single_device_draw(point, ranks):
    """Without dp_shard_map the ranks' dropout masks are blocks of the
    single device's: the step equals the unsharded port step."""
    params, model_state, a, b = point
    state = port_state(params, model_state, dropout=True)
    steps.make_train_step("mse", WEIGHTS)(state, torch.from_numpy(a),
                                          torch.from_numpy(b))
    _, want, grads = snapshot(state)
    plain = port_state(params, model_state)
    steps.make_train_step("mse", WEIGHTS)(plain, torch.from_numpy(a),
                                          torch.from_numpy(b))
    assert any(not np.allclose(g, snapshot(plain)[2]["g_AB"][k])
               for k, g in grads["g_AB"].items()), "no dropout"
    for r in ranks:
        for n in NETWORKS:
            for k, v in want[n].items():
                np.testing.assert_allclose(r["dropout"][1][n][k], v, rtol=0,
                                           atol=1e-5, err_msg=f"{n} {k}")
                np.testing.assert_allclose(
                    r["dropout"][2][n][k], grads[n][k], rtol=1e-5,
                    atol=1e-5 * np.abs(grads[n][k]).max(),
                    err_msg=f"{n} {k} gradient")


def test_shard_map_generators_differ_per_data_rank(ranks):
    assert not np.array_equal(ranks[0]["draw"], ranks[1]["draw"])


def test_mesh_coordinates(ranks):
    assert [r["coords"] for r in ranks] == [{"data": 0}, {"data": 1}]
    assert {r["backend"] for r in ranks} == {"gloo"}


def test_mesh_helper_errors(ranks):
    (batch, too_many, too_few, height, rows, spatial_batch,
     spatial_height) = ranks[0]["errors"]
    assert batch == ("batch dimension 3 is not divisible by the mesh size 2 "
                     "along axis 'data' ({'data': 2}); choose a batch_size "
                     "that is a multiple of the device count")
    assert too_many == "requested 3 devices, have 2"
    assert too_few is not None and "every process holds one point" in too_few
    assert height is not None and height.startswith(
        "image height 31 is not divisible by the spatial mesh axis size 2")
    assert rows is not None and "leaves 2 rows per shard (< 4)" in rows
    assert spatial_batch == "batch 3 not divisible by data axis 2"
    assert spatial_height is not None and "image height 5" in spatial_height


def test_replicate_broadcasts_rank_zero(ranks):
    for r in ranks:
        assert r["replicated"] == ([1.0] * 3, [5.0] * 4)


def test_dataset_process_slices_are_the_global_batches(ranks):
    """The two data ranks' batches of 3 are disjoint halves of the
    single-process batches of 6, and the ragged tail is dropped on both."""
    a = np.arange(20)[:, None]
    solo = ArrayDataset(a, a + 100, shuffle=True, seed=1)
    want = [x[:, 0].tolist() for x, _ in solo.batches(6, 1)]
    assert [r["num_batches"] for r in ranks] == [len(want)] * 2
    got = [r0 + r1 for r0, r1 in zip(ranks[0]["batches"],
                                     ranks[1]["batches"])]
    assert got == want


def test_dataset_process_index_checked():
    with pytest.raises(ValueError, match="out of range"):
        ArrayDataset(np.zeros((2, 1)), np.zeros((2, 1)), process_index=2,
                     process_count=2)


def test_mesh_needs_a_process_group():
    with contextlib.suppress(Exception):
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="initialized torch.distributed"):
        create_spatial_mesh(1, 1)
