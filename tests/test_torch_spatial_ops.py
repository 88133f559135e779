"""The port's H-sharded ops (``ops/spatialctx.py`` and the spatial branches
of ``ops/conv.py``, ``ops/norm.py``, ``ops/pool.py``) on 2 and 4 gloo ranks
of the CPU, against the unsharded op and the JAX package's global op.

Each rank holds one strip of a 32x32 (transposes: 16x16) input and runs
the op under ``spatialctx.spatial``; its output strips, gathered, and the
input gradient of sum(y * cotangent), gathered, must equal the unsharded
op's, and the parameter gradients summed over the ranks must equal its
own (the sum the train step's average rests on). f32 within 1e-5, bf16
within 2e-2 (the JAX spatial tests' bounds,
``tests/test_spatial_shard_map.py``). The ranks are spawned once per world
size for every case (``parallel.run_ranks``, a file store, one thread
each, a deadline).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cyclegan_tpu_torch.ops import layout, spatialctx
from cyclegan_tpu_torch.ops import norm as norm_ops
from cyclegan_tpu_torch.ops.conv import (
    conv2d,
    conv2d_reflect,
    conv2d_transpose,
)
from cyclegan_tpu_torch.ops.pool import avg_pool2x2
from cyclegan_tpu_torch.ops.resize import upsample_concat
from cyclegan_tpu_torch.parallel import run_ranks

B, C, COUT = 2, 4, 5
# name: (op, layout, dtype, kernel, stride); the input is 32x32, 16x16 for
# the transposes
CASES = {
    **{f"conv_k{k}_s{s}_nhcw": ("conv", "NHCW", "f32", k, s)
       for k in (3, 4, 7) for s in (1, 2)},
    "conv_k3_s1_nhwc": ("conv", "NHWC", "f32", 3, 1),
    "conv_k4_s2_nhwc": ("conv", "NHWC", "f32", 4, 2),
    "conv_k4_s1_nhcw_bf16": ("conv", "NHCW", "bf16", 4, 1),
    "transpose_k3": ("transpose", "NHCW", "f32", 3, 2),
    "transpose_k4": ("transpose", "NHWC", "f32", 4, 2),
    "reflect_k3": ("reflect", "NHCW", "f32", 3, 1),
    "reflect_k7": ("reflect", "NHWC", "f32", 7, 1),
    "instance_norm_f32": ("inorm", "NHCW", "f32", 0, 1),
    "instance_norm_bf16": ("inorm", "NHCW", "bf16", 0, 1),
    "instance_norm_nhwc": ("inorm", "NHWC", "f32", 0, 1),
    "batch_norm_f32": ("bnorm", "NHCW", "f32", 0, 1),
    "pool": ("pool", "NHCW", "f32", 0, 1),
    "junction": ("junction", "NHCW", "f32", 0, 1),
}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": 1e-5, "bf16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(name):
    """NHWC x, weights, bias, gamma/beta and the output's cotangent
    (NHWC), from a seed per case."""
    op, _, _, k, stride = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    size = 16 if op == "transpose" else 32
    x = rng.uniform(-1, 1, (B, size, size, C)).astype(np.float32)
    params = {}
    if op in ("conv", "reflect"):
        params["w"] = rng.normal(0, 0.2, (k, k, C, COUT)).astype(np.float32)
        params["b"] = rng.normal(0, 0.5, (COUT,)).astype(np.float32)
    elif op == "transpose":
        params["w"] = rng.normal(0, 0.2, (k, k, COUT, C)).astype(np.float32)
        params["b"] = rng.normal(0, 0.5, (COUT,)).astype(np.float32)
    elif op in ("inorm", "bnorm"):
        params["gamma"] = rng.uniform(0.5, 1.5, (C,)).astype(np.float32)
        params["beta"] = rng.uniform(-0.5, 0.5, (C,)).astype(np.float32)
    elif op == "junction":
        params["skip"] = rng.uniform(-1, 1, (B, 2 * size, 2 * size, 3)
                                     ).astype(np.float32)
    out_size = {"transpose": 2 * size, "pool": size // 2,
                "junction": 2 * size}.get(op, size // stride)
    out_c = {"conv": COUT, "reflect": COUT, "transpose": COUT,
             "junction": 3 + C}.get(op, C)
    cot = rng.normal(0, 1, (B, out_size, out_size, out_c)).astype(
        np.float32)
    return x, params, cot


def _apply(name, x, params):
    """The case's op on NHWC x (made the case's layout and dtype here),
    output NHWC f32."""
    op, lay, dt, k, stride = CASES[name]
    dtype = DTYPES[dt]
    cast = {n: p.to(dtype) for n, p in params.items()}
    xin = x.to(dtype)
    with layout.nhcw(lay == "NHCW"):
        if lay == "NHCW":
            xin = layout.to_nhcw(xin)
            if "skip" in cast:
                cast["skip"] = layout.to_nhcw(cast["skip"])
        if op == "conv":
            y = conv2d(xin, cast["w"], cast["b"], stride=stride)
        elif op == "transpose":
            y = conv2d_transpose(xin, cast["w"], cast["b"], stride=stride)
        elif op == "reflect":
            y = conv2d_reflect(xin, cast["w"], cast["b"])
        elif op == "inorm":
            y = norm_ops.instance_norm(xin, cast["gamma"], cast["beta"],
                                       act="relu")
        elif op == "bnorm":
            with norm_ops.batch_stats(True):
                y = norm_ops.batch_norm(
                    xin, cast["gamma"], cast["beta"], torch.zeros(C),
                    torch.ones(C), None, act="leaky_relu")
        elif op == "pool":
            y = avg_pool2x2(xin)
        else:
            y = upsample_concat(cast["skip"], xin)
        if lay == "NHCW":
            y = layout.from_nhcw(y)
    return y.float()


def _grads(name, x, params, cot):
    """(y, dx, {param: grad}) of sum(y * cot), unsharded or on a strip."""
    x = x.clone().requires_grad_(True)
    params = {n: p.clone().requires_grad_(n != "skip")
              for n, p in params.items()}
    y = _apply(name, x, params)
    (y * cot).sum().backward()
    return (y.detach(), x.grad,
            {n: p.grad for n, p in params.items() if p.grad is not None})


def _strip(t, n, i):
    h = t.shape[1] // n
    return t[:, i * h:(i + 1) * h].contiguous()


def _ops_worker(rank, world, cases):
    """Every case on this rank's strips: gathered outputs and input
    gradients, parameter gradients summed over the ranks (rank 0's are
    returned)."""
    group = dist.group.WORLD
    out = {}
    for name, (x, params, cot) in cases.items():
        x, cot = torch.from_numpy(x), torch.from_numpy(cot)
        params = {n: torch.from_numpy(p) for n, p in params.items()}
        if "skip" in params:
            params["skip"] = _strip(params["skip"], world, rank)
        with spatialctx.spatial(group, world, rank), \
                norm_ops.batch_group(group, world):
            y, dx, dp = _grads(name, _strip(x, world, rank), params,
                               _strip(cot, world, rank))
            with torch.no_grad():
                y, dx = spatialctx.gather_h(y), spatialctx.gather_h(dx)
        for g in dp.values():
            dist.all_reduce(g)
        out[name] = (y.numpy(), dx.numpy(),
                     {n: g.numpy() for n, g in dp.items()})
    return out


@pytest.fixture(scope="module")
def sharded():
    cases = {name: _inputs(name) for name in CASES}
    return {n: run_ranks(_ops_worker, n, (cases,), timeout=240)[0]
            for n in (2, 4)}


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_op_matches_unsharded(sharded, shards, name):
    x, params, cot = _inputs(name)
    y, dx, dp = _grads(name, torch.from_numpy(x),
                       {n: torch.from_numpy(p) for n, p in params.items()},
                       torch.from_numpy(cot))
    got_y, got_dx, got_dp = sharded[shards][name]
    tol = TOL[CASES[name][2]]
    scale = lambda t: max(1.0, float(np.abs(t).max()))  # noqa: E731
    np.testing.assert_allclose(got_y, y.numpy(), rtol=tol,
                               atol=tol * scale(y.numpy()))
    np.testing.assert_allclose(got_dx, dx.numpy(), rtol=tol,
                               atol=tol * scale(dx.numpy()))
    assert got_dp.keys() == dp.keys()
    for n, g in dp.items():
        np.testing.assert_allclose(got_dp[n], g.numpy(), rtol=tol,
                                   atol=tol * scale(g.numpy()), err_msg=n)


def _jax_global(name, x, params):
    """The JAX package's op on the whole NHWC input, f32 out."""
    import jax.numpy as jnp

    from cyclegan_tpu.ops import conv as jconv
    from cyclegan_tpu.ops import norm as jnorm

    op, _, dt, _, stride = CASES[name]
    dtype = jnp.bfloat16 if dt == "bf16" else jnp.float32
    xj = jnp.asarray(x).astype(dtype)
    p = {n: jnp.asarray(v).astype(dtype) for n, v in params.items()}
    if op == "conv":
        y = jconv.conv2d(xj, p["w"], p["b"], stride=stride)
    elif op == "transpose":
        y = jconv.conv2d_transpose(xj, p["w"], p["b"], stride=stride)
    elif op == "reflect":
        y = jconv.conv2d_reflect(xj, p["w"], p["b"])
    elif op == "inorm":
        y = jnp.maximum(jnorm.instance_norm(xj, p["gamma"], p["beta"]), 0)
    else:
        y, _, _ = jnorm.batch_norm_stats(
            xj, p["gamma"], p["beta"], jnp.zeros(C), jnp.ones(C), True)
        y = jnp.where(y >= 0, y, 0.2 * y)
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", sorted(
    n for n, c in CASES.items() if c[0] not in ("pool", "junction")))
def test_sharded_op_matches_jax_global_op(sharded, shards, name):
    x, params, _ = _inputs(name)
    want = _jax_global(name, x, params)
    tol = TOL[CASES[name][2]]
    np.testing.assert_allclose(sharded[shards][name][0], want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def test_halo_exchange_gradient_routes_to_producer():
    """Each halo row's gradient returns to the strip that produced it: the
    gathered input gradients of sum(x_ext * cot), with cot read off one
    global cotangent over the zero-padded image, equal the global
    gradient; the edges' halos are zeros."""
    n, above, below = 4, 2, 1
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (1, 16, 3, 5)).astype(np.float32)
    # the strips' windows are rows [r h - above, (r + 1) h + below) of the
    # image padded by above before and below after: one cotangent per
    # rank's window (overlapping windows get independent values)
    h = 16 // n
    cots = rng.normal(0, 1, (n, 1, h + above + below, 3, 5)).astype(
        np.float32)
    want = np.zeros((1, 16 + above + below, 3, 5), np.float32)
    for r in range(n):
        want[:, r * h:r * h + h + above + below] += cots[r]
    want = want[:, above:above + 16]
    results = run_ranks(_halo_window_worker, n, (x, cots, above, below),
                        timeout=120)
    for r, (ext, dx) in enumerate(results):
        padded = np.pad(x, ((0, 0), (above, below), (0, 0), (0, 0)))
        np.testing.assert_array_equal(
            ext, padded[:, r * h:r * h + h + above + below])
        np.testing.assert_allclose(dx, want, rtol=1e-6, atol=1e-6)


def _halo_window_worker(rank, world, x, cots, above, below):
    xl = _strip(torch.from_numpy(x), world, rank).requires_grad_(True)
    with spatialctx.spatial(dist.group.WORLD, world, rank):
        ext = spatialctx.halo_exchange_h(xl, above, below)
        (ext * torch.from_numpy(cots[rank])).sum().backward()
        with torch.no_grad():
            dx = spatialctx.gather_h(xl.grad)
    return ext.detach().numpy(), dx.numpy()


def _refusal_worker(rank, world):
    """The refusals that need a strip: an odd local H at a pool, a halo
    wider than the strip."""
    out = []
    with spatialctx.spatial(dist.group.WORLD, world, rank):
        for fn in (lambda: avg_pool2x2(torch.zeros(1, 3, 2, 2)),
                   lambda: spatialctx.halo_exchange_h(
                       torch.zeros(1, 2, 1, 1), 3, 3),
                   lambda: spatialctx.halo_exchange_h_reflect(
                       torch.zeros(1, 2, 1, 1), 2)):
            try:
                fn()
                out.append(None)
            except ValueError as exc:
                out.append(str(exc))
    return out


def test_spatial_refusals():
    pool, halo, reflect = run_ranks(_refusal_worker, 2, timeout=120)[0]
    assert pool is not None and "odd local H" in pool
    assert halo is not None and "exceeds the local H shard" in halo
    assert reflect is not None and "needs pad < local H" in reflect
