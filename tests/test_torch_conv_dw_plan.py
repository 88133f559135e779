"""K5's and K9-dW's TMA + wgmma schedule (kernels/csrc/conv_dw.cu), emulated
in torch ops on the CPU, against the plain dW.

No CPU runs the kernel, so this holds its index map: the M tiles' rows as
(tap, channel) with ``dw_tma_geometry``'s rule (rows of taps past K*K are
left stale, here NaN, and must never reach the output), boxes of 64 pixels
started at a multiple of 8 columns and at row h + dy - pad of copy dx,
reading zeros outside the tensor as TMA does,
g tiles N = ``dw_tma_n(Cout)`` wide, the split of the (b, h) rows and the
fixed-order sum of the splits, and x read as its K column-shifted copies
(``shifted_copies``: a TMA box cannot start at an odd column), of the
reflect-padded x for K9-dW. f32,
tolerance 1e-5 sum |x| |g| (chip_smoke.py's: only the summation order
differs). Then every bf16 dW launch of chip_smoke.py's four train plans is
checked to lie in the TMA domain, with row strides of 16-byte multiples.
"""

import math

import pytest
import torch

import chip_smoke
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.ops import cuda_conv, cuda_reflect

PX = cuda_conv.TMA_PX
ROWS = cuda_conv.TMA_TILE_ROWS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tma_boxes(t, b, h, c0, rows, w0):
    """Boxes [len(h), rows, PX] of the tensor map over t [B, H, C, W] at
    (b, h, c0 + i, w0 + j), zeros outside [0, B) x [0, H) x [0, C) x
    [0, W), as TMA fills them; w0 a multiple of 8, as TMA needs."""
    assert w0 % 8 == 0
    B, H, C, W = t.shape
    hh = h[:, None, None]
    cc = (c0 + torch.arange(rows))[None, :, None]
    ww = (w0 + torch.arange(PX))[None, None, :]
    inside = (hh >= 0) & (hh < H) & (cc < C) & (ww < W)
    vals = t[b[:, None, None], hh.clamp(0, H - 1), cc.clamp(max=C - 1),
             ww.clamp(max=W - 1)]
    return torch.where(inside, vals, torch.zeros((), dtype=t.dtype))


def emulate(x, g, k, pad, reflect=False, splits=None):
    """dW [K,K,C,Cout] f32 as the TMA design computes it, in
    ``dw_tma_splits`` slices of the rows unless ``splits`` is given (the
    kernel takes any count the wrapper passes)."""
    B, H, Cout, W = g.shape
    C = int(x.shape[2])
    xs = cuda_conv.shifted_copies(x, k, pad, reflect)
    kpad = 0 if reflect else pad
    assert xs.shape == (k, B, H + (k - 1 if reflect else 0), x.shape[2], W)
    cb, taps, c_tiles, m_tiles = cuda_conv.dw_tma_geometry(C, k)
    assert cb * taps == ROWS and cb >= min(C, 64)
    n = cuda_conv.dw_tma_n(Cout)
    R = B * H
    splits = splits or cuda_conv.dw_tma_splits(k, C, Cout, R, W)
    assert 1 <= splits <= R
    rows_per = -(-R // splits)
    covered = []
    part = torch.full((splits, k * k * C, Cout), math.nan)
    for split in range(splits):
        start = split * rows_per  # a split past the rows sums nothing
        r = torch.arange(start, max(start, min(R, start + rows_per)))
        covered += r.tolist()
        b, h = r // H, r % H
        acc = torch.zeros(m_tiles, -(-Cout // n), ROWS, n)
        for w0 in range(0, W, PX):
            for nt in range(acc.shape[1]):
                gt = tma_boxes(g, b, h, nt * n, n, w0)
                for mt in range(m_tiles):
                    tap0, c0 = (mt // c_tiles) * taps, (mt % c_tiles) * cb
                    a = torch.full((len(r), ROWS, PX), math.nan)
                    for j in range(min(taps, k * k - tap0)):
                        dy, dx = divmod(tap0 + j, k)
                        a[:, j * cb:(j + 1) * cb] = tma_boxes(
                            xs[dx], b, h + dy - kpad, c0, cb, w0)
                    acc[mt, nt] += torch.einsum("rmp,rnp->mn", a, gt)
        # the epilogue: only real (tap, c) rows and co columns
        for mt in range(m_tiles):
            tap0, c0 = (mt // c_tiles) * taps, (mt % c_tiles) * cb
            for row in range(ROWS):
                tap, c = tap0 + row // cb, c0 + row % cb
                if tap < k * k and c < C:
                    for nt in range(acc.shape[1]):
                        cols = slice(nt * n, min(Cout, (nt + 1) * n))
                        width_n = cols.stop - cols.start
                        part[split, tap * C + c, cols] = acc[mt, nt, row,
                                                             :width_n]
    assert sorted(covered) == list(range(R))
    assert not bool(part.isnan().any())
    dw = part[0].clone()
    for split in range(1, splits):  # the fixed order
        dw += part[split]
    return dw.reshape(k, k, C, Cout)


CASES = [(c, cout, k) for c in (3, 16) for cout in (1, 3, 16)
         for k in (1, 3, 4, 7)]


@pytest.mark.parametrize("c,cout,k", CASES + [(80, 130, 3)])
def test_tma_schedule_matches_plain_dw(c, cout, k):
    size = 16 if k < 7 else 32
    gen = torch.Generator().manual_seed(c * 1000 + cout * 10 + k)
    x = torch.randn(2, size, c, size, generator=gen)
    g = torch.randn(2, size, cout, size, generator=gen)
    pad = cuda_conv.tf_same_pad(k)[0]
    want = cuda_conv.conv_dw_plain(x, g, k, pad)
    scale = cuda_conv.conv_dw_plain(x.abs(), g.abs(), k, pad)
    got = emulate(x, g, k, pad)
    assert bool(((got - want).abs() <= 1e-5 * scale).all())


@pytest.mark.parametrize("c,cout,k", [s for s in CASES if s[2] % 2]
                         + [(80, 130, 3)])
def test_tma_schedule_matches_plain_reflect_dw(c, cout, k):
    size = 24
    gen = torch.Generator().manual_seed(c * 1000 + cout * 10 + k + 1)
    x = torch.randn(1, size, c, size, generator=gen)
    g = torch.randn(1, size, cout, size, generator=gen)
    want = cuda_reflect.conv_reflect_dw_plain(x, g, k)
    scale = cuda_reflect.conv_reflect_dw_plain(x.abs(), g.abs(), k)
    got = emulate(x, g, k, k // 2, reflect=True)
    assert bool(((got - want).abs() <= 1e-5 * scale).all())


@pytest.mark.parametrize("splits", [3, 31])
def test_tma_schedule_sums_any_split_of_the_rows(splits):
    """3 slices of 32 rows (the last one shorter) and 31 (slices past row
    32 sum nothing and add zeros)."""
    gen = torch.Generator().manual_seed(splits)
    x = torch.randn(2, 16, 3, 16, generator=gen)
    g = torch.randn(2, 16, 16, 16, generator=gen)
    want = cuda_conv.conv_dw_plain(x, g, 4, 1)
    scale = cuda_conv.conv_dw_plain(x.abs(), g.abs(), 4, 1)
    got = emulate(x, g, 4, 1, splits=splits)
    assert bool(((got - want).abs() <= 1e-5 * scale).all())


def test_tma_splits_at_the_main_path_shapes():
    """Up to eight blocks per SM, at least 32 stages a block, never more
    slices than rows: (8, 256, 16, 16, k7) 151, (8, 64, 128, 128, k3) 16,
    a 16x16 image 1."""
    assert cuda_conv.dw_tma_splits(7, 16, 16, 2048, 256) == 151
    assert cuda_conv.dw_tma_splits(3, 128, 128, 512, 64) == 16
    assert cuda_conv.dw_tma_splits(3, 3, 1, 16, 16) == 1


def _train_plans():
    cfgs = {"unet": "model_instances/converged256/model_config.yaml",
            "resnet": "configs/resnet.yaml",
            "unet_transpose": "configs/unet_transpose.yaml",
            "strided": "configs/strided_unet.yaml"}
    plans = {}
    for name, path in cfgs.items():
        derive = (chip_smoke.resnet_train_launches if name == "resnet"
                  else chip_smoke.train_launches)
        plans[name] = derive(yaml2namespace(path), chip_smoke.BATCH,
                             chip_smoke.SIZE)
    return plans


def test_every_main_path_dw_launch_is_in_the_tma_domain():
    plans = _train_plans()
    dw_launches = 0
    for name, plan in plans.items():
        for b, h, cin, cout, k, *rest in (plan.get("conv_dw", [])
                                          + plan.get("conv_reflect_dw", [])):
            dw_launches += 1
            x = torch.empty((1, 1, cin, h), dtype=torch.bfloat16)
            g = torch.empty((1, 1, cout, h), dtype=torch.bfloat16)
            assert cuda_conv.dw_tma_domain(x, g), (name, b, h, cin, cout, k)
            cb, taps, _, _ = cuda_conv.dw_tma_geometry(cin, k)
            assert cb <= 256 and cuda_conv.dw_tma_n(cout) <= 256
            assert PX * 2 == 128  # a box row: one 128-byte swizzle row
            # the shifted copies' strides, of the reflect-padded x for
            # conv_reflect_dw (no pad in the shape)
            pad, reflect = (rest[0], False) if rest else (k // 2, True)
            xs = cuda_conv.shifted_copies(
                torch.zeros((1, k // 2 + 1, cin, h), dtype=torch.bfloat16),
                k, pad, reflect)
            assert xs.is_contiguous() and xs.stride(3) * 2 % 16 == 0
    # U-Net 124 + 10, ResNet 120 + 4, T 124 + 10, S 40 + 4
    assert dw_launches == 134 + 124 + 134 + 44


def test_tma_domain_rule():
    x = torch.zeros((1, 2, 3, 64), dtype=torch.bfloat16)
    assert cuda_conv.dw_tma_domain(x, x)
    assert not cuda_conv.dw_tma_domain(x.float(), x.float())
    odd = torch.zeros((1, 2, 3, 12), dtype=torch.bfloat16)
    assert not cuda_conv.dw_tma_domain(odd, odd)
    flat = torch.zeros(2 * 3 * 64 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(1, 2, 3, 64)  # 2 bytes past an aligned base
    assert not cuda_conv.dw_tma_domain(shifted, x)
