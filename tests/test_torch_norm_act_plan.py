"""K2's and K6's schedule (kernels/csrc/norm_act.cuh), emulated in torch ops
on the CPU, against the plain versions and the JAX package.

No CPU runs the kernels, so this holds their geometry and index map: the
rule ``cuda_norm_act.norm_act_geometry`` (the C rule's mirror) at every
K2 and K6 launch of chip_smoke.py's four train plans and at its edge
shapes, in bf16 and f32: a cluster of at most 8 CTAs that divides the
grid, planes sharing a CTA with a warp or more each, the kept slots within
the register budget, every bf16 launch of the recipes resident in 16-byte
slots, and each plane's elements walked
exactly once (the walk steps (row, slot) with a carry, as the kernels do).
Then the emulated kernels: per-thread f32 sums over a thread's slots in
order, each warp's butterfly, the plane's warps in order, the cluster's
ranks in order; then the output pass through the same slots, into an
output that starts as NaN (an element never written would stay NaN).
They are held against ``instance_norm_act_plain`` and
``instance_norm_act_bwd_plain`` and against the Pallas kernels in
interpret mode (bf16) and the JAX XLA ops (f32), with the tolerances of
``tests/test_torch_kernels.py`` and ``tests/test_torch_kernels_bwd.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cyclegan_tpu.ops import layout as jax_layout
from cyclegan_tpu.ops import packctx, pallas_norm_act
from cyclegan_tpu.ops.norm import instance_norm as jax_instance_norm
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.ops import cuda_norm_act
from cyclegan_tpu_torch.ops.cuda_norm_act import (NA_MAX_CLUSTER,
                                                  NA_THREADS,
                                                  norm_act_geometry)

BF16 = dict(rtol=2e-2, atol=1e-2)
F32_ATOL = 1e-5
# K2's statistics against the plain version's (chip_smoke.py TOL)
STATS = dict(rtol=1e-4, atol=1e-5)
ESIZE = {torch.bfloat16: 2, torch.float32: 4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def schedule(geo, b, h, c, w, ctas=None):
    """Flat offsets into x [b, h, c, w] that each thread of each CTA in
    ``ctas`` (default: the whole grid) walks: [ctas, threads, slots, vec],
    -1 past a thread's slots. CTA k is rank k % cluster of tile
    k // cluster, a tile (sample, group of ``channels`` planes); thread t
    serves plane t // tpc of the group, and its slots are tl, tl + tpc, ...
    (tl = t % tpc) of the CTA's rows x q, walked with a carry."""
    if ctas is None:
        ctas = range(geo["tiles"] * geo["cluster"])
    k = torch.as_tensor(ctas)
    cl_size, ch, tpc, q, vec = (geo["cluster"], geo["channels"], geo["tpc"],
                                geo["q"], geo["vec"])
    rank, tile = k % cl_size, k // cl_size
    tiles = c // ch
    bb, c0 = tile // tiles, (tile % tiles) * ch
    t = torch.arange(NA_THREADS)
    plane, tl = t // tpc, t % tpc
    h0 = rank * geo["rows"]
    here = (torch.clamp(h0 + geo["rows"], max=h) - h0).clamp(min=0)
    total = (here * q)[:, None]
    n = torch.where(total > tl, (total - tl + tpc - 1) // tpc, 0)
    row = h0[:, None] + tl // q
    col = (tl % q).expand_as(row).clone()
    chan = c0[:, None] + plane
    offs = []
    for s in range(geo["slots"]):
        off = ((bb[:, None] * h + row) * c + chan) * w + col * vec
        offs.append(torch.where(s < n, off, -1))
        row = row + tpc // q
        col = col + tpc % q
        carry = col >= q
        col = col - carry * q
        row = row + carry.long()
    offs = torch.stack(offs, dim=2)
    e = torch.arange(vec)
    return torch.where(offs[..., None] >= 0, offs[..., None] + e, -1)


def plane_sums(geo, partial):
    """partial [grid, threads] f32 -> [tiles, channels] totals: each warp's
    butterfly, the plane's warps in order, then the cluster's ranks in
    rank order, as ``na::plane_sums``."""
    grid = partial.shape[0]
    v = partial.view(grid, NA_THREADS // 32, 32)
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, :, lane ^ o]
    red = v[:, :, 0]
    wpp = NA_THREADS // 32 // geo["channels"]
    part = []
    for p in range(geo["channels"]):
        a = torch.zeros(grid)
        for w in range(wpp):
            a = a + red[:, p * wpp + w]
        part.append(a)
    part = torch.stack(part, dim=1)                  # [grid, channels]
    if geo["cluster"] == 1:
        return part
    ranks = part.view(-1, geo["cluster"], geo["channels"])
    tot = ranks[:, 0]
    for r in range(1, geo["cluster"]):
        tot = tot + ranks[:, r]
    return tot


def _per_plane(geo, b, c, tot):
    """[tiles, channels] -> [b, c]"""
    return tot.reshape(b, c)


def _thread_sums(vals, valid, terms):
    """Per-thread f32 sums of ``terms(v)`` over the slots and their
    elements in order; vals [grid, threads, slots, vec]."""
    accs = None
    for s in range(vals.shape[2]):
        for e in range(vals.shape[3]):
            ts = terms(vals[:, :, s, e], s, e)
            if accs is None:
                accs = [torch.zeros_like(ts[0]) for _ in ts]
            ok = valid[:, :, s]
            accs = [torch.where(ok, a + t, a) for a, t in zip(accs, ts)]
    return accs


def _gather(geo, t):
    """Each thread's slots of t (f32), and which of them exist."""
    b, h, c, w = t.shape
    offs = schedule(geo, b, h, c, w)
    vals = t.float().reshape(-1)[offs.clamp(min=0)]
    return offs, vals, offs[..., 0] >= 0


def _per_thread(geo, b, c, per_plane):
    """[b, c] -> [grid, threads]: each thread's plane's value."""
    k = torch.arange(geo["tiles"] * geo["cluster"])
    tile = k // geo["cluster"]
    tiles = c // geo["channels"]
    bb, c0 = tile // tiles, (tile % tiles) * geo["channels"]
    plane = torch.arange(NA_THREADS) // geo["tpc"]
    return per_plane[bb[:, None], c0[:, None] + plane]


def _write(offs, values, like):
    """Scatter per-slot values into a NaN tensor shaped like ``like``."""
    out = torch.full((like.numel(),), float("nan"))
    ok = offs >= 0
    out[offs[ok]] = values[ok]
    return out.view(like.shape)


def _act(y, act, alpha=0.2):
    if act == "relu":
        return torch.clamp(y, min=0.0)
    if act == "leaky_relu":
        return torch.where(y >= 0.0, y, y * alpha)
    return y


def emulate_fwd(x, gamma, beta, eps, act):
    """K2's (out, mu, rstd) as its schedule computes them."""
    b, h, c, w = x.shape
    geo = norm_act_geometry(b, h, c, w, ESIZE[x.dtype], 1)
    offs, vals, valid = _gather(geo, x)
    two_pass = x.dtype == torch.float32
    s1, s2 = _thread_sums(vals, valid, lambda v, s, e: (v, v * v))
    mu_p = _per_plane(geo, b, c, plane_sums(geo, s1)) * (1.0 / (h * w))
    if two_pass:
        mu_t = _per_thread(geo, b, c, mu_p)[:, :, None, None]
        (d2,) = _thread_sums(vals, valid,
                             lambda v, s, e: ((v - mu_t[:, :, 0, 0]) ** 2,))
        var = _per_plane(geo, b, c, plane_sums(geo, d2)) * (1.0 / (h * w))
    else:
        sq = _per_plane(geo, b, c, plane_sums(geo, s2)) * (1.0 / (h * w))
        var = torch.clamp(sq - mu_p * mu_p, min=0.0)
    rstd_p = torch.rsqrt(var + eps)
    g = torch.ones(c) if gamma is None else gamma.float()
    be = torch.zeros(c) if beta is None else beta.float()
    mu_t = _per_thread(geo, b, c, mu_p)[:, :, None, None]
    a_t = _per_thread(geo, b, c, g[None, :] * rstd_p)[:, :, None, None]
    be_t = _per_thread(geo, b, c, be[None, :].expand(b, c))[:, :, None, None]
    y = _act((vals - mu_t) * a_t + be_t, act).to(x.dtype).float()
    return _write(offs, y, x).to(x.dtype), mu_p, rstd_p


def emulate_bwd(x, gz, gamma, beta, mu, rstd, act, alpha=0.2):
    """K6's (dx, t1, t2) as its schedule computes them."""
    b, h, c, w = x.shape
    geo = norm_act_geometry(b, h, c, w, ESIZE[x.dtype], 2)
    offs, xv, valid = _gather(geo, x)
    _, gv, _ = _gather(geo, gz)
    g = torch.ones(c) if gamma is None else gamma.float()
    be = torch.zeros(c) if beta is None else beta.float()
    mu_t, rstd_t, g_t, be_t = (
        _per_thread(geo, b, c, p)[:, :, None, None] for p in (
            mu, rstd, g[None, :].expand(b, c), be[None, :].expand(b, c)))
    xhat = (xv - mu_t) * rstd_t
    v = xhat * g_t + be_t
    if act == "relu":
        slope = (v > 0.0).float()
    elif act == "leaky_relu":
        slope = torch.where(v >= 0.0, 1.0, alpha)
    else:
        slope = torch.ones_like(v)
    dv = gv * slope
    s1, s2 = _thread_sums(xhat, valid, lambda xh, s, e: (
        dv[:, :, s, e], dv[:, :, s, e] * xh))
    t1 = _per_plane(geo, b, c, plane_sums(geo, s1))
    t2 = _per_plane(geo, b, c, plane_sums(geo, s2))
    n = h * w
    k_t = g_t * rstd_t
    m1 = _per_thread(geo, b, c, t1 * (1.0 / n))[:, :, None, None]
    m2 = _per_thread(geo, b, c, t2 * (1.0 / n))[:, :, None, None]
    dx = (k_t * (dv - m1 - xhat * m2)).to(x.dtype).float()
    return _write(offs, dx, x).to(x.dtype), t1, t2


# --- the geometry -----------------------------------------------------------

def _train_norm_shapes():
    """{(B, H, C)} of every K2/K6 launch of chip_smoke.py's four train plans
    (batch 8, 256x256; K6 launches at the same shapes as K2)."""
    cfgs = {"unet": chip_smoke.MODEL_DIR / "model_config.yaml",
            "resnet": chip_smoke.RESNET_CONFIG,
            "unet_transpose": chip_smoke.TRANSPOSE_CONFIG,
            "strided": chip_smoke.STRIDED_CONFIG}
    shapes = set()
    for name, path in cfgs.items():
        plan = (chip_smoke.resnet_train_launches if name == "resnet"
                else chip_smoke.train_launches)(yaml2namespace(path), 8, 256)
        assert plan["instance_norm_act_bwd"] == plan["instance_norm_act"]
        shapes.update(s[:3] for s in plan["instance_norm_act"])
    return sorted(shapes)


TRAIN_SHAPES = _train_norm_shapes()
EDGE_SHAPES = sorted({s[:3] for s in
                      chip_smoke.EDGE_NORM_SHAPES["instance_norm_act"]})
assert sorted({s[:3] for s in chip_smoke.EDGE_NORM_SHAPES[
    "instance_norm_act_bwd"]}) == EDGE_SHAPES


def _check_geometry(b, h, c, esize, operands):
    w = h
    geo = norm_act_geometry(b, h, c, w, esize, operands)
    cl, ch = geo["cluster"], geo["channels"]
    assert cl in (1, 2, 4, 8) and cl <= NA_MAX_CLUSTER
    assert geo["tiles"] == b * (c // ch)
    assert ch in (1, 2, 4, 8) and c % ch == 0 and geo["tpc"] >= 32
    assert cl == 1 or ch == 1            # a cluster splits one plane
    assert geo["rows"] * cl >= h > (geo["rows"] - 1) * cl   # ceil(h / cl)
    assert geo["vec"] * geo["q"] == w
    # a thread keeps at most 128 bytes of operands: 32 of its registers
    assert geo["nv"] * 16 * operands <= 128
    assert geo["resident"] == (geo["slots"] <= geo["nv"]
                               and geo["vec"] * esize == 16)
    # every element of the first and the last tile's planes exactly once
    tiles = geo["tiles"]
    for tile in (0, tiles - 1):
        offs = schedule(geo, b, h, c, w, range(tile * cl, (tile + 1) * cl))
        got = torch.sort(offs[offs >= 0]).values
        bb, c0 = tile // (c // ch), (tile % (c // ch)) * ch
        r = torch.arange(h)[:, None, None]
        cc = torch.arange(c0, c0 + ch)[None, :, None]
        col = torch.arange(w)[None, None, :]
        want = torch.sort((((bb * h + r) * c + cc) * w + col).reshape(-1))
        assert torch.equal(got, want.values), (b, h, c, esize, operands)
    return geo


@pytest.mark.parametrize("operands", [1, 2])
@pytest.mark.parametrize("esize", [2, 4])
def test_geometry_covers_every_train_launch(esize, operands):
    """At every K2 (1 operand) and K6 (2) launch of the four recipes'
    steps: each plane walked exactly once, a cluster of at most 8, the
    kept slots within the register budget; every bf16 launch resident, in
    16-byte slots."""
    assert len(TRAIN_SHAPES) == 14
    for b, h, c in TRAIN_SHAPES:
        geo = _check_geometry(b, h, c, esize, operands)
        if esize == 2:
            assert geo["resident"] and geo["vec"] == 8, (b, h, c, geo)


@pytest.mark.parametrize("operands", [1, 2])
@pytest.mark.parametrize("esize", [2, 4])
def test_geometry_covers_the_edge_shapes(esize, operands):
    """chip_smoke.py's EDGE_NORM_SHAPES take the paths they are there for:
    one-element slots, rows of 6 or 12 slots, eight planes to a CTA,
    clusters over planes whose count no cluster size divides, a launch of
    one cluster, and the streamed pass."""
    geos = [_check_geometry(b, h, c, esize, operands)
            for b, h, c in EDGE_SHAPES]
    assert any(g["channels"] == 8 for g in geos)
    assert any(g["q"] in (3, 6, 12) for g in geos)
    assert any(g["cluster"] > 1 and g["tiles"] % 2 for g in geos)
    assert any(g["cluster"] == 8 and g["tiles"] == 1 for g in geos)
    assert any(not g["resident"] for g in geos)
    if esize == 2:
        assert any(g["vec"] == 1 for g in geos)


def test_unaligned_pointers_take_one_element_slots():
    geo = norm_act_geometry(8, 64, 64, 64, 2, 1, aligned=False)
    assert geo["vec"] == 1 and geo["q"] == 64
    assert norm_act_geometry(8, 64, 64, 64, 2, 1)["vec"] == 8


# --- the emulated kernels ---------------------------------------------------

# (B, H, C, W): eight planes to a CTA; planes split over a cluster of 2
# (bf16; f32 4); eight planes to a CTA at W = 48 (6 slots a row, 12 in
# f32); a ragged W (one-element slots, streamed, in bf16); one plane
# streamed past the budget (512x512); one 256x256 plane over a cluster of
# 8 (streamed in f32)
EMULATED = [(4, 4, 256, 16), (2, 128, 3, 128), (12, 4, 48, 48), (2, 12, 5, 12),
            (1, 512, 1, 512), (1, 256, 1, 256)]


def _np(shape, seed, scale=1.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return (offset + scale * rng.normal(size=shape)).astype(np.float32)


def _inputs(shape, seed, dtype):
    c = shape[2]
    # an offset mean makes the one-sweep variance's cancellation visible
    x = _np(shape, seed, scale=1.5, offset=0.5)
    gamma = _np((c,), seed + 1, scale=0.1, offset=1.0)
    beta = _np((c,), seed + 2, scale=0.1)
    gz = _np(shape, seed + 3)
    return [torch.from_numpy(a).to(dtype) for a in (x, gamma, beta, gz)]


def _jnp(t):
    return jnp.asarray(t.float().numpy(),
                       jnp.bfloat16 if t.dtype == torch.bfloat16
                       else jnp.float32)


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _close(got, want, rtol, atol, scale=1.0):
    """|got - want| <= rtol |want| + atol * scale, elementwise."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want)
    limit = rtol * np.abs(want) + atol * np.asarray(scale, np.float32)
    assert (err <= limit).all(), (
        f"max excess {float((err - limit).max())}, max err "
        f"{float(err.max())}")


def _jax_fwd(x, gamma, beta, act, affine):
    """The JAX package's forward: Pallas in interpret mode for bf16, the
    XLA instance norm under NHCW for f32."""
    g, b = (_jnp(gamma), _jnp(beta)) if affine else (None, None)
    if x.dtype == torch.bfloat16:
        with packctx.scope(True, interpret=True):
            return pallas_norm_act.instance_norm_act(_jnp(x), g, b, 1e-3,
                                                     act)
    with jax_layout.nhcw():
        y = jax_instance_norm(_jnp(x), g, b, eps=1e-3)
    if act == "relu":
        return jax.nn.relu(y)
    return jax.nn.leaky_relu(y, 0.2) if act == "leaky_relu" else y


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", EMULATED)
def test_emulated_forward_matches_plain_and_jax(shape, dtype):
    act = ("relu", "leaky_relu", "none")[EMULATED.index(shape) % 3]
    affine = EMULATED.index(shape) % 2 == 0
    x, gamma, beta, _ = _inputs(shape, 11, dtype)
    if not affine:
        gamma = beta = None
    out, mu, rstd = emulate_fwd(x, gamma, beta, 1e-3, act)
    assert not torch.isnan(out.float()).any()   # every element written
    p_out, p_mu, p_rstd = cuda_norm_act.instance_norm_act_plain(
        x, gamma, beta, 1e-3, act, with_stats=True)
    _close(mu, p_mu, **STATS)
    _close(rstd, p_rstd, **STATS)
    ref = _jax_fwd(x, gamma, beta, act, affine)
    if dtype == torch.bfloat16:
        _close(out, p_out, **BF16)
        _close(out, ref, **BF16)
    else:
        _close(out, p_out, 0, F32_ATOL)
        _close(out, ref, 0, F32_ATOL)


def _norm_param_scale(x, g):
    """sum |g| (1 + |xhat|) over (B, H, W): the size of the sums that
    dgamma and dbeta are (tests/test_torch_kernels_bwd.py)."""
    x, g = _f32(x), _f32(g)
    xhat = (x - x.mean(axis=(1, 3), keepdims=True)) / (
        x.std(axis=(1, 3), keepdims=True) + 1e-6)
    return (np.abs(g) * (1.0 + np.abs(xhat))).sum(axis=(0, 1, 3))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", EMULATED)
def test_emulated_backward_matches_plain_and_jax(shape, dtype):
    act = ("relu", "none", "leaky_relu")[EMULATED.index(shape) % 3]
    affine = EMULATED.index(shape) % 2 == 1
    x, gamma, beta, gz = _inputs(shape, 21, dtype)
    if not affine:
        gamma = beta = None
    _, mu, rstd = cuda_norm_act.instance_norm_act_plain(
        x, gamma, beta, 1e-3, act, with_stats=True)
    dx, t1, t2 = emulate_bwd(x, gz, gamma, beta, mu, rstd, act)
    assert not torch.isnan(dx.float()).any()    # every element written
    p_dx, p_t1, p_t2 = cuda_norm_act.instance_norm_act_bwd_plain(
        x, gz, gamma, beta, mu, rstd, act)
    # chip_smoke.py's K6 tolerances, each output's largest |value| its scale
    tol = (dict(rtol=1e-2, atol=1e-2) if dtype == torch.bfloat16
           else dict(rtol=1e-4, atol=1e-4))
    sums = (dict(rtol=1e-3, atol=1e-4))
    _close(dx, p_dx, tol["rtol"], tol["atol"], float(p_dx.float().abs().max()))
    _close(t1, p_t1, sums["rtol"], sums["atol"], float(p_t1.abs().max()))
    _close(t2, p_t2, sums["rtol"], sums["atol"], float(p_t2.abs().max()))

    args = [x, gamma, beta] if affine else [x]
    if dtype == torch.bfloat16:
        with packctx.scope(True, interpret=True):
            _, vjp = jax.vjp(lambda *a: pallas_norm_act.instance_norm_act(
                a[0], *(a[1:] if affine else (None, None)), 1e-3, act),
                *map(_jnp, args))
            ref = vjp(_jnp(gz))
        _close(dx, ref[0], **BF16)
        rtol, atol = BF16["rtol"], BF16["atol"]
    else:
        def jax_fn(x, gamma=None, beta=None):
            y = jax_instance_norm(x, gamma, beta, eps=1e-3)
            if act == "relu":
                return jax.nn.relu(y)
            return jax.nn.leaky_relu(y, 0.2) if act == "leaky_relu" else y
        with jax_layout.nhcw():
            _, vjp = jax.vjp(jax_fn, *map(_jnp, args))
            ref = vjp(_jnp(gz))
        # dx = gamma rstd (dv - mean dv - xhat mean(dv xhat)): scale |g| rstd
        xa = _f32(x)
        r = 1.0 / np.sqrt(xa.var(axis=(1, 3), keepdims=True) + 1e-3)
        _close(dx, ref[0], 0, F32_ATOL, 3 * np.abs(_f32(gz)).max() * r)
        rtol, atol = 0, F32_ATOL
    if affine:
        scale = _norm_param_scale(x, gz)
        _close(t2.sum(dim=0), ref[1], rtol, atol, scale)
        _close(t1.sum(dim=0), ref[2], rtol, atol, scale)
