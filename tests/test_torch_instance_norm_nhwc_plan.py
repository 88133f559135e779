"""K13's launch (kernels/csrc/instance_norm_nhwc.cu), emulated in torch ops
on the CPU, against the plain version and the JAX package.

No CPU runs the kernel, so this holds its geometry and its sums: the rule
``cuda_norm.instance_norm_nhwc_geometry`` at every K13 launch of
chip_smoke.py's plans (the NHWC train steps of phases 12-13; no NHCW train
step or serving forward launches K13) and at its edge shapes, in bf16 and
f32 (every recipe launch resident: x copied on chip once, in one launch);
then the kernel's map and fixed-order sums, emulated in f32 (resident:
each thread's slots in order, the butterfly over a warp's lanes of one
channel vector, the warps in order, the cluster's ranks in order;
streamed: each thread's rows of a split in order, the split's row lanes in
order, the splits in order), then the statistics and y written through
the same map into an output that starts as NaN. The emulation must write
every element once and give y, mean and rstd within
the tolerances ``tests/test_torch_norm_nhwc.py`` holds the plain version
to against ``pallas_norm._forward`` (interpret mode, under ``jax.jit``):
f32 2e-5 absolute; bf16 y 0.05 absolute, its statistics 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cyclegan_tpu.ops import pallas_norm
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.ops import cuda_norm
from cyclegan_tpu_torch.ops.cuda_norm import (MAX_CLUSTER, MAX_TILE,
                                              SMEM_MAX, TARGET_BLOCKS,
                                              THREADS,
                                              instance_norm_nhwc_geometry)

ESIZE = {torch.bfloat16: 2, torch.float32: 4}
EPS = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the geometry -----------------------------------------------------------

def _plan_shapes():
    """{(N, H, C)} of every K13 launch of chip_smoke.py's plans (batch 8,
    256x256; W = H): the NHWC train steps of the U-Net and the ResNet; the
    NHCW train steps and serving forwards launch none."""
    cfgs = {"unet": chip_smoke.MODEL_DIR / "model_config.yaml",
            "resnet": chip_smoke.RESNET_CONFIG,
            "unet_transpose": chip_smoke.TRANSPOSE_CONFIG,
            "strided": chip_smoke.STRIDED_CONFIG}
    shapes = set()
    for name, path in cfgs.items():
        cfg = yaml2namespace(path)
        train = (chip_smoke.resnet_train_launches if name == "resnet"
                 else chip_smoke.train_launches)(cfg, 8, 256)
        serve = (chip_smoke.resnet_generator_launches if name == "resnet"
                 else chip_smoke.serve_launches)(cfg.generator, 8, 256)
        assert "instance_norm_nhwc" not in train
        assert "instance_norm_nhwc" not in serve
        if name in ("unet", "resnet"):
            nhwc = chip_smoke.nhwc_train_launches(cfg, 8, 256)
            shapes.update(s[:3] for s in nhwc["instance_norm_nhwc"])
    return sorted(shapes)


PLAN_SHAPES = _plan_shapes()


def _check_geometry(n, h, c, esize, aligned=True):
    hw = h * h
    geo = instance_norm_nhwc_geometry(n, hw, c, esize, aligned)
    vec, tile, cluster = geo["vec"], geo["tile"], geo["cluster"]
    assert vec == 16 // esize or vec == 1
    assert c % vec == 0
    lanes = THREADS // tile
    if geo["path"] == "resident":
        assert vec == 16 // esize and geo["splits"] == 0
        assert (c // vec) % tile == 0
        assert tile & (tile - 1) == 0 and tile <= MAX_TILE
        assert cluster & (cluster - 1) == 0 and cluster <= MAX_CLUSTER
        # the cluster's ranks cover the rows, each lane's slots a rank's
        assert geo["rows"] * cluster >= hw > geo["rows"] * (cluster - 1)
        assert geo["slots"] * lanes >= geo["rows"] > (
            geo["slots"] - 1) * lanes
        assert geo["smem"] == geo["slots"] * THREADS * 16 <= SMEM_MAX
        assert geo["blocks"] == n * (c // vec // tile) * cluster
    else:
        assert geo["path"] == ("streamed" if vec > 1 else "element")
        assert tile == min(c // vec, 32) and cluster == 1
        assert geo["slots"] == geo["smem"] == 0
        assert 1 <= geo["splits"] <= max(1, hw // (4 * lanes))
        assert geo["blocks"] == n * -(-(c // vec) // tile) * geo["splits"]
    return geo


@pytest.mark.parametrize("esize", [2, 4])
def test_geometry_covers_every_plan_launch(esize):
    """Every K13 launch of the NHWC train steps keeps x on chip (resident,
    one launch, x read once), in bf16 and f32; the 128x128 and 256x256
    layers take a cluster of 16, the latter over tiles of 2 vectors."""
    assert PLAN_SHAPES == [(8, 32, 128), (8, 32, 256), (8, 64, 64),
                           (8, 64, 128), (8, 128, 32), (8, 128, 64),
                           (8, 256, 16), (8, 256, 32)]
    for n, h, c in PLAN_SHAPES:
        geo = _check_geometry(n, h, c, esize)
        assert geo["path"] == "resident", (n, h, c, geo)
        if h >= 128:
            assert geo["cluster"] == 16
        if h == 256:
            assert geo["tile"] == 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_geometry_of_the_edge_shapes(dtype):
    """chip_smoke.py's EDGE_NHWC_NORM_SHAPES take the paths and clusters
    they are there for."""
    esize = ESIZE[dtype]
    edges = chip_smoke.EDGE_NHWC_NORM_SHAPES["instance_norm_nhwc"]
    # (path, cluster, splits)
    want = {2: [("element", 1, 1), ("element", 1, 11), ("resident", 1, 0),
                ("resident", 4, 0), ("resident", 8, 0),
                ("streamed", 1, 256)],
            4: [("element", 1, 1), ("element", 1, 11), ("resident", 1, 0),
                ("resident", 8, 0), ("resident", 16, 0),
                ("streamed", 1, 512)]}[esize]
    for shape, got in zip(edges, want):
        n, h, c, _ = shape
        geo = _check_geometry(n, h, c, esize)
        assert (geo["path"], geo["cluster"], geo["splits"]) == got, shape
        assert chip_smoke.expected_path("instance_norm_nhwc", shape,
                                        dtype) == got[0]
    assert {a for *_, a in edges} == {True, False}
    assert min(n for n, *_ in edges) == 1


def test_unaligned_pointers_take_the_element_path():
    assert instance_norm_nhwc_geometry(8, 4096, 128, 2)["path"] == "resident"
    geo = instance_norm_nhwc_geometry(8, 4096, 128, 2, aligned=False)
    assert geo["path"] == "element" and geo["vec"] == 1


def test_streamed_launches_keep_the_two_launch_rule():
    """A tile past the on-chip budget takes the two-launch design's row
    splits: about TARGET_BLOCKS blocks, at least 4 rows a lane."""
    geo = instance_norm_nhwc_geometry(8, 512 * 512, 16, 2)
    assert geo["path"] == "streamed" and geo["tile"] == 2
    assert geo["splits"] == -(-TARGET_BLOCKS // 8) == 66
    assert instance_norm_nhwc_geometry(1, 64, 3, 4)["splits"] == 1


# --- the emulated kernel ----------------------------------------------------

def _resident_sums(xf, geo):
    """The resident launch's (sum, sum of squares) [2, n, c] and, per
    sample, the element offsets its threads write (each once)."""
    n, hw, c = xf.shape
    vec, tile, cluster = geo["vec"], geo["tile"], geo["cluster"]
    rows, slots = geo["rows"], geo["slots"]
    lanes = THREADS // tile
    tiles = c // vec // tile
    # thread t of rank r of tile g: vector g tile + t % tile, slot k at row
    # r rows + t / tile + k lanes (valid below min(hw, (r + 1) rows))
    r = torch.arange(cluster)[:, None, None]
    t = torch.arange(THREADS)[None, :, None]
    k = torch.arange(slots)[None, None, :]
    row = r * rows + t // tile + k * lanes              # [cl, T, slots]
    valid = row < torch.minimum(torch.tensor(hw), (r + 1) * rows)
    g = torch.arange(tiles)[:, None, None, None]
    ch = ((g * tile + t % tile) * vec)[..., None] + torch.arange(vec)
    off = row[None, ..., None] * c + ch                 # [g, cl, T, s, vec]
    valid = valid[None, ..., None].expand(off.shape)
    flat = xf.reshape(n, hw * c)
    vals = torch.where(valid, flat[:, off.clamp(max=hw * c - 1)],
                       torch.zeros(()))                 # [n, g, cl, T, s, v]
    s1 = torch.zeros(vals.shape[:4] + (vec,))
    s2 = torch.zeros_like(s1)
    for kk in range(slots):                             # slots in order
        f = vals[..., kk, :]
        s1 = s1 + f
        s2 = s2 + f * f
    sums = torch.stack([s1, s2])                        # [2, n, g, cl, T, v]
    sums = sums.reshape(*sums.shape[:4], THREADS // 32, 32, vec)
    lane = torch.arange(32)
    o = 16
    while o >= tile:                                    # the butterfly
        sums = sums + sums[..., lane ^ o, :]
        o //= 2
    part = torch.zeros(sums.shape[:4] + (tile, vec))
    for wi in range(THREADS // 32):                     # warps in order
        part = part + sums[..., wi, :tile, :]
    tot = part[:, :, :, 0]
    for rk in range(1, cluster):                        # ranks in order
        tot = tot + part[:, :, :, rk]
    return tot.reshape(2, n, c), off[valid]


def _streamed_sums(xf, geo):
    """The two-launch design's (sum, sum of squares) [2, n, c] and the
    element offsets its normalize launch writes."""
    n, hw, c = xf.shape
    lanes = THREADS // geo["tile"]
    splits = geo["splits"]
    tot = torch.zeros(2, n, c)
    for s in range(splits):                             # splits in order
        r0, r1 = hw * s // splits, hw * (s + 1) // splits
        row = r0 + torch.arange(lanes)[:, None] + lanes * torch.arange(
            -(-(r1 - r0) // lanes))[None, :]            # [lane, k]
        vals = torch.where((row < r1)[None, ..., None],
                           xf[:, row.clamp(max=hw - 1)], torch.zeros(()))
        s1 = torch.zeros(n, lanes, c)
        s2 = torch.zeros_like(s1)
        for kk in range(row.shape[1]):                  # a lane's rows
            f = vals[:, :, kk]
            s1 = s1 + f
            s2 = s2 + f * f
        part = torch.zeros(2, n, c)
        for ty in range(lanes):                         # lanes in order
            part = part + torch.stack([s1[:, ty], s2[:, ty]])
        tot = tot + part
    off = torch.arange(hw * c)
    return tot, off


def emulate(x, gamma, beta, aligned=True):
    """K13's (y, mean, rstd, writes per element of y) as its threads
    compute them: x [N, H, W, C]."""
    n, h, w, c = x.shape
    hw = h * w
    geo = instance_norm_nhwc_geometry(n, hw, c, ESIZE[x.dtype], aligned)
    xf = x.reshape(n, hw, c).float()
    tot, sel = (_resident_sums if geo["path"] == "resident"
                else _streamed_sums)(xf, geo)
    count = float(hw)
    mean = tot[0] / count
    var = torch.clamp(tot[1] / count - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + EPS)
    # y through the write map, into NaN
    flat = xf.reshape(n, hw * c)
    yflat = torch.full((n, hw * c), float("nan"))
    writes = torch.zeros(n, hw * c, dtype=torch.int64)
    cidx = sel % c
    for i in range(n):
        v = (flat[i, sel] - mean[i, cidx]) * rstd[i, cidx]
        if gamma is not None:
            v = v * gamma.float()[cidx] + beta.float()[cidx]
        yflat[i, sel] = v
        writes[i].index_add_(0, sel, torch.ones(sel.numel(),
                                                dtype=torch.int64))
    y = yflat.to(x.dtype).reshape(n, h, w, c)
    return y, mean[:, None, :], rstd[:, None, :], writes


# (N, H, C, affine, aligned): resident over clusters of 2, 4 and 8 (bf16;
# f32 2, 8 and 4) and on one CTA (bf16); C of no whole vector (element:
# the two-launch design in 11 row splits); x off alignment (element, 1
# split)
EMULATED = [(2, 32, 64, True, True), (2, 64, 16, False, True),
            (1, 64, 8, True, True), (2, 32, 16, True, True),
            (2, 48, 5, True, True), (2, 16, 16, False, False)]


def _inputs(n, h, c, affine, seed):
    rng = np.random.default_rng(seed)
    x = (0.5 + 1.5 * rng.normal(size=(n, h, h, c))).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32)
    beta = (0.1 * rng.normal(size=c)).astype(np.float32)
    return x, (gamma if affine else None), (beta if affine else None)


def _t(a, dtype):
    return None if a is None else torch.from_numpy(a).to(dtype)


@jax.jit
def _pallas_forward(x, gamma, beta):
    n, h, w, c = x.shape
    y, mean, rstd = pallas_norm._forward(x.reshape(n, h * w, c), gamma,
                                         beta, EPS, True)
    return y.reshape(x.shape), mean, rstd


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", EMULATED)
def test_emulated_kernel_matches_plain_and_pallas(shape, dtype):
    n, h, c, affine, aligned = shape
    x, gamma, beta = _inputs(n, h, c, affine, EMULATED.index(shape))
    tx, tg, tb = _t(x, dtype), _t(gamma, dtype), _t(beta, dtype)
    geo = instance_norm_nhwc_geometry(n, h * h, c, ESIZE[dtype], aligned)
    assert geo["path"] == ("element" if not aligned or c % (
        16 // ESIZE[dtype]) else "resident")
    y, mean, rstd, writes = emulate(tx, tg, tb, aligned)
    assert bool((writes == 1).all())      # every element written once
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = _pallas_forward(*[None if a is None else jnp.asarray(a, jdt)
                             for a in (x, gamma, beta)])
    plain = cuda_norm.instance_norm_nhwc_plain(tx, tg, tb, EPS)
    y_atol = 0.05 if dtype == torch.bfloat16 else 2e-5
    refs = ([np.asarray(r, np.float32) for r in want],
            [r.float().numpy() for r in plain])
    for ref in refs:
        assert y.dtype == dtype and tuple(y.shape) == ref[0].shape
        np.testing.assert_allclose(y.float().numpy(), ref[0], rtol=0,
                                   atol=y_atol)
        for got, r in zip((mean, rstd), ref[1:]):
            assert tuple(got.shape) == r.shape == (n, 1, c)
            if dtype == torch.bfloat16:
                np.testing.assert_allclose(got.numpy(), r, rtol=1e-5,
                                           atol=1e-5)
            else:
                np.testing.assert_allclose(got.numpy(), r, rtol=0,
                                           atol=2e-5)


def test_sum_order_is_the_kernels_not_a_plain_sum():
    """The emulation adds in the kernel's order, not torch's: on inputs
    where f32 order matters the two sums differ in their last bits, while
    both stay within the tolerance above."""
    x, _, _ = _inputs(1, 64, 8, False, 9)
    tx = torch.from_numpy(x * 1000.0 + 3.0e4)
    plain = cuda_norm.instance_norm_nhwc_plain(tx, None, None, EPS)[1]
    for aligned in (True, False):         # resident, then streamed
        _, mean, _, _ = emulate(tx, None, None, aligned)
        assert not torch.equal(mean, plain)
        np.testing.assert_allclose(mean.numpy(), plain.numpy(), rtol=1e-5)
