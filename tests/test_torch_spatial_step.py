"""The port's train, validate and multi step on a 2x2 (data x spatial) mesh
of four gloo ranks of the CPU, against the JAX package's single-device
steps and the port's own unsharded ones.

The tiny U-Net recipe of JAX's ``tests/test_spatial_shard_map.py``
(``_cyclegan_setup``: filters [4, 4], kernels [3, 3], MSE, Adam 2e-4), at
batch 4 and 32x32, every affine beta at +-(3..4) so that no ReLU decision
flips between implementations. Each rank runs the step with
``shard_map_dp`` on its batch half's H strip (NHCW, the kernels' plain
versions: K1 on the halo-extended strips, the norms' sums all-reduced).
Metrics and parameters after the step must be within 1e-5 of JAX's in
f32 (a parameter whose gradient fell below 1e-6 within 2 lr more, as
``tests/test_torch_multi_step.py`` allows: Adam's first update turns on
rounding there) and within 2e-2 in bf16, JAX's own bounds
(``tests/test_spatial_shard_map.py:228``). Adam's first update is close
to lr * sign(g), blind to the gradients' scale, so the averaged gradients
themselves are held against JAX's step's, read exactly through an optax
transformation that keeps them as its state: in f32 each within 1e-5,
relatively or relative to its network's largest gradient; in bf16 each
network's gradient has JAX's norm within 5% and points its way (cosine at
least 0.9), since bf16 rounding at this point leaves about 30% of relative
L2 error between either package's bf16 gradients and the f32 ones. The
averaged f32 gradients are also within 1e-5 of the port's unsharded
step's. The JAX spatial multi step fails in
JAX itself, so the port's spatial multi step is held against its own
sequential unsharded steps and against two JAX single-device steps.
"""


import numpy as np
import pytest
import torch
import torch.distributed as dist

from cyclegan_tpu_torch import steps
from cyclegan_tpu_torch.config import Namespace
from cyclegan_tpu_torch.data.augment import random_jitter_batch
from cyclegan_tpu_torch.parallel import (
    create_spatial_mesh,
    make_spatial_forward,
    run_ranks,
    shard_batch,
)
from cyclegan_tpu_torch.weights import (
    jax_params_to_torch,
    load_jax_params,
    models_to_jax_params,
    models_to_jax_state,
)

NETWORKS = steps.NETWORKS
BATCH, SIZE, K = 4, 32, 2
WEIGHTS = dict(cycle=2.0, identity=0.5, generator=1.0, discriminator=0.5)
LR = 2e-4
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def model_config(norm="instancenorm", location="unused", **gen):
    unet = dict(type="unet_generator", filters=[4, 4], kernels=[3, 3],
                expansion="upsample", normalization=norm, dropout=False)
    return Namespace(dict(
        name="tiny", new=True, location=str(location), seed=0,
        generator=dict(unet, output_channels=3, final_activation="tanh",
                       **gen),
        discriminator=dict(unet, output_channels=1,
                           final_activation="sigmoid"),
        loss="mse", loss_weights=WEIGHTS))


def train_config(**extra):
    adam = dict(name="adam", learning_rate=LR, beta_1=0.5)
    return Namespace(dict(epochs=1, batch_size=2, image_size=16, g_opt=adam,
                          d_opt=adam, summary=dict(samples=2, images=1,
                                                   model=1), **extra))


def shift_affine(tree, rng):
    """Every beta at +-(3..4), gamma at 1 +- 0.2, in place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            shift_affine(v, rng)
        elif k == "beta":
            tree[k] = (rng.choice([-1.0, 1.0], v.shape)
                       * rng.uniform(3.0, 4.0, v.shape)).astype(np.float32)
        elif k == "gamma":
            tree[k] = (1.0 + 0.2 * rng.normal(size=v.shape)).astype(
                np.float32)


def make_point(norm="instancenorm", k=None):
    """(params, model_state, a, b): seeded parameters as the JAX trees and
    NHWC batches in [-1, 1] ((K, B, ...) with ``k``)."""
    cfg = model_config(norm)
    models = steps.build_models(cfg, seed=0)
    params = models_to_jax_params(models)
    shift_affine(params, np.random.default_rng(11))
    rng = np.random.default_rng(5)
    lead = (BATCH,) if k is None else (k, BATCH)
    a, b = (rng.uniform(-1, 1, lead + (SIZE, SIZE, 3)).astype(np.float32)
            for _ in range(2))
    return params, models_to_jax_state(models), a, b


def port_state(params, model_state, norm="instancenorm", **gen):
    models = steps.build_models(model_config(norm, **gen), seed=0)
    load_jax_params(models, params, model_state)
    return steps.init_train_state(models, train_config(), seed=7,
                                  device="cpu")


def snapshot(state, metrics=None):
    """(metrics, params, grads) as numpy, the params and grads keyed by
    network and name."""
    params = {n: {k: p.detach().numpy().copy()
                  for k, p in state.models[n].named_parameters()}
              for n in NETWORKS}
    grads = {n: {k: p.grad.numpy().copy()
                 for k, p in state.models[n].named_parameters()
                 if p.grad is not None} for n in NETWORKS}
    return ({k: np.asarray(v) for k, v in (metrics or {}).items()}, params,
            grads)


def _mesh_worker(rank, world, point, point_k):
    """On a 2x2 mesh: the f32 and bf16 train steps, the validate step, the
    K-step multi step, the spatial generator forward, and the refusals
    that need a mesh."""
    mesh = create_spatial_mesh(data=2, spatial=2)
    params, model_state, a, b = point
    sharded = shard_batch(mesh, (torch.from_numpy(a), torch.from_numpy(b)),
                          spatial_axis="spatial")
    out = {}
    kw = dict(mesh=mesh, spatial_axis="spatial", shard_map_dp=True)
    for dtype in ("float32", "bfloat16"):
        state = port_state(params, model_state)
        metrics = steps.make_train_step("mse", WEIGHTS, dtype, **kw)(
            state, *sharded)
        out[("train", dtype)] = snapshot(state, metrics)
    state = port_state(params, model_state)
    out["validate"] = {k: np.asarray(v) for k, v in steps.make_validate_step(
        "mse", WEIGHTS, "float32", **kw)(state, *sharded).items()}
    pk, sk, ak, bk = point_k
    state = port_state(pk, sk)
    stacked = shard_batch(mesh, (torch.from_numpy(ak),
                                 torch.from_numpy(bk)),
                          batch_dim=1, spatial_axis="spatial")
    metrics = steps.make_train_multi_step("mse", WEIGHTS, "float32", **kw)(
        state, *stacked)
    out["multi"] = snapshot(state, metrics)
    # the generator alone, inference-style, on this rank's block
    state = port_state(params, model_state)
    fwd = make_spatial_forward(state.models["g_AB"], mesh)
    with torch.no_grad():
        y = fwd(sharded[0])
        y_all = torch.zeros((world,) + tuple(y.shape))
        y_all[rank] = y
        dist.all_reduce(y_all)
    out["forward"] = y_all.numpy()
    out["refusals"] = _refusals(mesh)
    return out


def _refusals(mesh):
    from cyclegan_tpu_torch.trainer import CycleGan

    said = []
    cfg = model_config(expansion="transpose")
    cfg.generator["kernels"] = [3, 5]
    for make in (
            lambda: CycleGan(cfg, train_config(), mesh=mesh, device="cpu"),
            lambda: CycleGan(model_config(), train_config(tpu_layout=True),
                             mesh=mesh, device="cpu"),
            lambda: steps.make_train_step(
                "mse", WEIGHTS, mesh=mesh, spatial_axis="spatial",
                tpu_layout=True)):
        try:
            make()
            said.append(None)
        except ValueError as exc:
            said.append(str(exc))
    return said


@pytest.fixture(scope="module")
def point():
    return make_point()


@pytest.fixture(scope="module")
def point_k():
    return make_point(k=K)


@pytest.fixture(scope="module")
def ranks(point, point_k):
    return run_ranks(_mesh_worker, 4, (point, point_k), timeout=300)


def _kept_grads():
    """An optax transformation that passes the updates on unchanged and
    keeps them as its state: chained first, the step's gradients."""
    import jax
    import jax.numpy as jnp
    import optax

    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def jax_state(params, model_state, norm="instancenorm"):
    """The JAX models, optimizers (Adam behind ``_kept_grads``) and train
    state at the point."""
    import jax
    import jax.numpy as jnp
    import optax

    from cyclegan_tpu import steps as jax_steps
    from cyclegan_tpu.models import create_model
    from cyclegan_tpu.optimizers import get_optimizer

    cfg = model_config(norm)
    models = {n: create_model(cfg.generator if n.startswith("g")
                              else cfg.discriminator) for n in NETWORKS}
    optimizers = {n: optax.chain(_kept_grads(), get_optimizer(dict(
        name="adam", learning_rate=LR, beta_1=0.5))) for n in NETWORKS}
    jparams = jax.tree.map(jnp.asarray, params)
    state = jax_steps.TrainState(
        params=jparams,
        model_state=jax.tree.map(jnp.asarray, model_state),
        opt_state={n: optimizers[n].init(jparams[n]) for n in NETWORKS},
        rng=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32))
    return models, optimizers, state


def _by_port_name(trees):
    import jax

    return {n: {k: v.numpy() for k, v in jax_params_to_torch(
        jax.tree.map(np.asarray, trees[n])).items()} for n in NETWORKS}


def jax_params(state):
    return _by_port_name(state.params)


def jax_grads(state):
    """The gradients of the step that made ``state`` (``_kept_grads``)."""
    return _by_port_name({n: state.opt_state[n][0] for n in NETWORKS})


def assert_close_to_jax(got, want_metrics, want_params, want_grads,
                        dtype="float32"):
    """Metrics and parameters within ``TOL[dtype]`` of JAX's (in f32 a
    parameter whose gradient is below 1e-6 within 2 lr more), and the
    gradients as the module docstring says."""
    tol = TOL[dtype]
    metrics, params, grads = got
    assert metrics.keys() == want_metrics.keys()
    for k, v in want_metrics.items():
        assert abs(float(metrics[k]) - float(v)) <= tol * max(
            1.0, abs(float(v))), (k, float(metrics[k]), float(v))
    for n in NETWORKS:
        assert grads[n].keys() == want_grads[n].keys(), n
        for k, want in want_params[n].items():
            small = np.abs(grads[n][k]) < 1e-6 if dtype == "float32" else 0
            diff = np.abs(params[n][k] - want)
            assert (diff <= tol + 2 * LR * small).all(), (
                n, k, float(diff.max()))
        if dtype == "float32":
            top = max(np.abs(g).max() for g in want_grads[n].values())
            for k, g in want_grads[n].items():
                np.testing.assert_allclose(grads[n][k], g, rtol=tol,
                                           atol=tol * top,
                                           err_msg=f"{n} {k} gradient")
        else:
            u, v = (np.concatenate([t[k].ravel() for k in sorted(t)])
                    for t in (grads[n], want_grads[n]))
            ratio = np.linalg.norm(u) / np.linalg.norm(v)
            cosine = u @ v / (np.linalg.norm(u) * np.linalg.norm(v))
            assert abs(ratio - 1) <= 0.05 and cosine >= 0.9, (
                n, float(ratio), float(cosine))


@pytest.fixture(scope="module")
def jax_single(point):
    """The JAX single-device step from the point, f32 and bf16 (XLA)."""
    import jax.numpy as jnp

    from cyclegan_tpu import steps as jax_steps

    params, model_state, a, b = point
    out = {}
    for dtype in ("float32", "bfloat16"):
        models, optimizers, state = jax_state(params, model_state)
        state, metrics = jax_steps.make_train_step(
            models, optimizers, "mse", WEIGHTS, donate=False,
            compute_dtype=dtype)(state, jnp.asarray(a), jnp.asarray(b))
        out[dtype] = ({k: np.asarray(v) for k, v in metrics.items()},
                      jax_params(state), jax_grads(state))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spatial_train_step_matches_jax_single_device(ranks, jax_single,
                                                      dtype):
    got = ranks[0][("train", dtype)]
    assert_close_to_jax(got, *jax_single[dtype], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spatial_ranks_hold_one_replica(ranks, dtype):
    """Every rank ends the step with the same parameters and metrics."""
    first = ranks[0][("train", dtype)]
    for other in ranks[1:]:
        got = other[("train", dtype)]
        for k, v in first[0].items():
            assert np.array_equal(got[0][k], v), k
        for n in NETWORKS:
            for k, v in first[1][n].items():
                assert np.array_equal(got[1][n][k], v), (n, k)


def test_spatial_gradients_match_unsharded_port(point, ranks):
    params, model_state, a, b = point
    state = port_state(params, model_state)
    steps.make_train_step("mse", WEIGHTS, "float32")(
        state, torch.from_numpy(a), torch.from_numpy(b))
    _, _, want = snapshot(state)
    got = ranks[0][("train", "float32")][2]
    for n in NETWORKS:
        for k, g in want[n].items():
            np.testing.assert_allclose(got[n][k], g, rtol=1e-5,
                                       atol=1e-5 * np.abs(g).max(),
                                       err_msg=f"{n} {k}")


def test_spatial_validate_step_matches_jax(point, ranks):
    import jax.numpy as jnp

    from cyclegan_tpu import steps as jax_steps

    params, model_state, a, b = point
    models, _, state = jax_state(params, model_state)
    want = jax_steps.make_validate_step(models, "mse", WEIGHTS)(
        state, jnp.asarray(a), jnp.asarray(b))
    got = ranks[0]["validate"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-5 * max(1, abs(float(v))), k


def test_spatial_multi_step_matches_sequential_steps(point_k, ranks):
    """K steps per call on the mesh against K unsharded port steps and K
    JAX single-device steps."""
    import jax.numpy as jnp

    from cyclegan_tpu import steps as jax_steps

    params, model_state, a, b = point_k
    state = port_state(params, model_state)
    step = steps.make_train_step("mse", WEIGHTS, "float32")
    seq = [step(state, torch.from_numpy(a[i]), torch.from_numpy(b[i]))
           for i in range(K)]
    metrics, got_params, _ = ranks[0]["multi"]
    for k in seq[0]:
        np.testing.assert_allclose(metrics[k], [float(m[k]) for m in seq],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    _, want_params, _ = snapshot(state)
    for n in NETWORKS:
        for k, v in want_params[n].items():
            np.testing.assert_allclose(got_params[n][k], v, rtol=0,
                                       atol=1e-5, err_msg=f"{n} {k}")
    models, optimizers, jstate = jax_state(params, model_state)
    jstep = jax_steps.make_train_step(models, optimizers, "mse", WEIGHTS,
                                      donate=False)
    for i in range(K):
        jstate, jm = jstep(jstate, jnp.asarray(a[i]), jnp.asarray(b[i]))
    want = jax_params(jstate)
    for n in NETWORKS:
        for k, v in want[n].items():
            np.testing.assert_allclose(got_params[n][k], v, rtol=0,
                                       atol=1e-5 + 2 * K * LR,
                                       err_msg=f"{n} {k}")
    for k, v in jm.items():
        assert abs(float(metrics[k][-1]) - float(v)) <= 1e-5 * max(
            1, abs(float(v))), k


def test_spatial_forward_matches_whole_image(point, ranks):
    """``make_spatial_forward`` on each rank's block, assembled, equals
    the generator on the whole batch."""
    params, model_state, a, _ = point
    state = port_state(params, model_state)
    with torch.no_grad():
        want = state.models["g_AB"](torch.from_numpy(a)).numpy()
    blocks = ranks[0]["forward"]            # rank d * 2 + s
    got = np.concatenate([np.concatenate([blocks[2 * d + s]
                                          for s in range(2)], axis=1)
                          for d in range(2)], axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_spatial_refusals(ranks):
    transposes, layout, step = ranks[0]["refusals"]
    assert transposes is not None and "generator k5" in transposes
    assert layout is not None and "dp_shard_map" in layout
    assert step is not None and "mutually exclusive" in step


def test_spatial_kernel_exclusion_without_a_mesh():
    with pytest.raises(ValueError, match="mutually exclusive"):
        steps.make_train_step("mse", WEIGHTS, spatial_axis="spatial",
                              tpu_layout=True)
    with pytest.raises(ValueError, match="shard_map_dp requires a mesh"):
        steps.make_validate_step("mse", WEIGHTS, shard_map_dp=True)


def _jitter_worker(rank, world, images):
    """The jitter of the spatial ranks of one image: gathered H, one draw,
    each strip kept (the step's preprocess); returns this rank's strip."""
    mesh = create_spatial_mesh(data=1, spatial=world)
    x = shard_batch(mesh, torch.from_numpy(images), axis_name=None,
                    spatial_axis="spatial")
    step_par = steps._parallel(mesh, "data", "spatial", False, False)
    gen = torch.Generator().manual_seed(3)
    with step_par.scope():
        a, _ = steps._preprocessed(
            lambda g, a, b, rows: (random_jitter_batch(g, a, SIZE, rows),
                                   random_jitter_batch(g, b, SIZE, rows)),
            step_par, gen, None, x, x)
    return a.numpy()


def test_spatial_jitter_is_the_whole_image_jitter():
    images = np.random.default_rng(2).integers(
        0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    strips = run_ranks(_jitter_worker, 2, (images,), timeout=120)
    want = random_jitter_batch(torch.Generator().manual_seed(3),
                               torch.from_numpy(images), SIZE).numpy()
    np.testing.assert_array_equal(np.concatenate(strips, axis=1), want)
