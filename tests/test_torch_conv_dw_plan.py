"""K5's and K9-dW's tap-ring schedule (kernels/csrc/conv_dw.cu), emulated
in torch ops on the CPU, against the plain dW.

No CPU runs the kernel, so this holds its index map as the kernel walks
it: ``dw_tma_geometry``'s cut (row groups of 8 (channel group, tap) rows in
group-major order, ``rg_block`` a block, N tiles, splits of the (b, chunk,
h) steps); a block's stream of x rows (per step the newest row h + d1 -
pad, and before the first step of a slice and of each new (b, chunk) the
rest of its dy span), each loaded as the TMA box [8 groups_max channels,
lines pixels] from column 64 chunk - lead with zeros outside the tensor
(rows through the reflected index map for K9-dW), transposed into a ring
of ``slots`` rows with 8 channels innermost and, for K9-dW, its columns
past the W edges copied from the reflected ones; every tap's A read from
the ring row of its dy at the tap's dx offset (stale ring entries are NaN
and must never reach the output); g tiles N = ``n`` wide; the partial sums
of each split and their fixed-order sum. f32, tolerance 1e-5 sum |x| |g|
(chip_smoke.py's: only the summation order differs). Then the cut and the
domain at every bf16 dW launch of chip_smoke.py's train plans and
U-GAT-IT's step.
"""

import math

import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.ops import cuda_conv, cuda_reflect

PX = cuda_conv.DW_PX


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reflect_index(i, n):
    return -i if i < 0 else (2 * n - 2 - i if i >= n else i)


def x_box(x, b, row, c0, rows, px0, lines):
    """The TMA box [rows, lines] of x [B, H, C, W] at (b, row, c0, px0),
    zeros outside the tensor."""
    B, H, C, W = x.shape
    box = torch.zeros(rows, lines)
    if not 0 <= row < H:
        return box
    c1, w0, w1 = min(C, c0 + rows), max(0, px0), min(W, px0 + lines)
    if c1 > c0 and w1 > w0:
        box[:c1 - c0, w0 - px0:w1 - px0] = x[b, row, c0:c1, w0:w1]
    return box


def emulate(x, g, k, pad, reflect=False, splits=None):
    """dW [K,K,C,Cout] f32 as the tap-ring design computes it, in the
    geometry's splits of the steps unless ``splits`` is given."""
    B, H, C, W = (int(v) for v in x.shape)
    Cout = int(g.shape[2])
    geo = cuda_conv.dw_tma_geometry(B, H, W, C, Cout, k, pad)
    assert geo is not None
    kk, n, lines, lead = k * k, geo["n"], geo["lines"], geo["lead"]
    S, gm, units, chunks = (geo["slots"], geo["groups_max"], geo["units"],
                            geo["chunks"])
    assert lines % 32 == 0 and lead >= pad and lines <= cuda_conv.DW_MAX_LINES
    assert lead + PX + k - 1 - pad <= geo["raw_lines"] <= 256
    assert geo["raw_lines"] % 8 == 0 and geo["raw_lines"] // 8 % 2 == 1
    splits = splits or geo["splits"]
    per = -(-units // splits)
    part = torch.full((splits, kk * C, Cout), math.nan)
    steps = []
    for split in range(splits):
        u0 = min(units, split * per)  # a split past the steps sums nothing
        u1 = min(units, u0 + per)
        steps += range(u0, u1)
        for m in range(geo["m_blocks"]):
            blk = cuda_conv.dw_block(m, geo["rg_block"], geo["total"], k)
            d0, d1, g0 = blk["d0"], blk["d1"], blk["g0"]
            span, ngb = d1 - d0 + 1, blk["g1"] - g0 + 1
            assert span + cuda_conv.DW_AHEAD <= S and ngb <= gm
            rows = []  # (local group, dy, dx) of each real row group
            for rg in range(blk["r0"], blk["r1"]):
                tap = rg % kk
                rows.append((rg // kk - g0, tap // k, tap % k))
            assert all(d0 <= dy <= d1 for _, dy, _ in rows)
            for nt in range(geo["n_tiles"]):
                ring = torch.full((S, gm, lines, 8), math.nan)
                acc = torch.zeros(len(rows), 8, n)
                j = 0
                for u in range(u0, u1):
                    h, wc, b = u % H, (u // H) % chunks, u // H // chunks
                    first = d0 - d1 if (u == u0 or h == 0) else 0
                    for e in range(first, 1):
                        xr = h + d1 - pad + e
                        box = x_box(x, b, reflect_index(xr, H) if reflect
                                    else xr, 8 * g0, 8 * gm,
                                    wc * PX - lead, lines)
                        # transposed: pixel lines of 8 channels, the
                        # block's groups only
                        ring[j % S, :ngb] = box.view(gm, 8, lines)[
                            :ngb].transpose(1, 2)
                        # lines past the raw row's end hold whatever the
                        # next row's start is: never read
                        ring[j % S, :, geo["raw_lines"]:] = math.nan
                        if reflect:
                            for i in range(1, pad + 1):
                                for px, frm in ((-i, i),
                                                (W - 1 + i, W - 1 - i)):
                                    line = px - wc * PX + lead
                                    src = frm - wc * PX + lead
                                    if 0 <= line < lines and 0 <= src < lines:
                                        ring[j % S, :ngb, line] = ring[
                                            j % S, :ngb, src]
                        j += 1
                    newest = j - 1
                    a = torch.stack([
                        ring[(newest - d1 + dy) % S, gl,
                             dx - pad + lead:dx - pad + lead + PX]
                        for gl, dy, dx in rows])          # [rows, 64, 8]
                    gt = torch.zeros(n, PX)
                    co1, w1 = min(Cout, nt * n + n), min(W, wc * PX + PX)
                    gt[:co1 - nt * n, :w1 - wc * PX] = g[
                        b, h, nt * n:co1, wc * PX:w1]
                    acc += torch.einsum("rpc,np->rcn", a, gt)
                # the epilogue: real (tap, c) rows and co columns only
                for (gl, dy, dx), sums in zip(rows, acc):
                    c = (g0 + gl) * 8 + torch.arange(8)
                    keep = c < C
                    co1 = min(Cout, nt * n + n)
                    part[split, (dy * k + dx) * C + c[keep],
                         nt * n:co1] = sums[keep, :co1 - nt * n]
    assert sorted(steps) == list(range(units))
    assert not bool(part.isnan().any())
    dw = part[0].clone()
    for split in range(1, splits):  # the fixed order
        dw += part[split]
    return dw.reshape(k, k, C, Cout)


CASES = [(c, cout, k) for c in (3, 16) for cout in (1, 3, 16)
         for k in (1, 3, 4, 7)]


def _close(got, want, scale):
    return bool(((got - want).abs() <= 1e-5 * scale).all())


@pytest.mark.parametrize("c,cout,k", CASES + [(80, 130, 3), (80, 130, 5)])
def test_tma_schedule_matches_plain_dw(c, cout, k):
    """W 16 or 32: one step of 64 pixels with its tail past the row."""
    size = 16 if k < 7 else 32
    gen = torch.Generator().manual_seed(c * 1000 + cout * 10 + k)
    x = torch.randn(2, size, c, size, generator=gen)
    g = torch.randn(2, size, cout, size, generator=gen)
    pad = cuda_conv.tf_same_pad(k)[0]
    want = cuda_conv.conv_dw_plain(x, g, k, pad)
    scale = cuda_conv.conv_dw_plain(x.abs(), g.abs(), k, pad)
    assert _close(emulate(x, g, k, pad), want, scale)


@pytest.mark.parametrize("c,cout,k", [s for s in CASES if s[2] % 2]
                         + [(80, 130, 3)])
def test_tma_schedule_matches_plain_reflect_dw(c, cout, k):
    """W 24: both reflected edges inside one step's window."""
    size = 24
    gen = torch.Generator().manual_seed(c * 1000 + cout * 10 + k + 1)
    x = torch.randn(1, size, c, size, generator=gen)
    g = torch.randn(1, size, cout, size, generator=gen)
    want = cuda_reflect.conv_reflect_dw_plain(x, g, k)
    scale = cuda_reflect.conv_reflect_dw_plain(x.abs(), g.abs(), k)
    assert _close(emulate(x, g, k, k // 2, reflect=True), want, scale)


@pytest.mark.parametrize("splits", [3, 31])
def test_tma_schedule_sums_any_split_of_the_rows(splits):
    """3 slices of 32 steps (the last one shorter, a slice starting inside
    an image) and 31 (slices past step 32 sum nothing and add zeros)."""
    gen = torch.Generator().manual_seed(splits)
    x = torch.randn(2, 16, 3, 16, generator=gen)
    g = torch.randn(2, 16, 16, 16, generator=gen)
    want = cuda_conv.conv_dw_plain(x, g, 4, 1)
    scale = cuda_conv.conv_dw_plain(x.abs(), g.abs(), 4, 1)
    assert _close(emulate(x, g, 4, 1, splits=splits), want, scale)


def test_tma_schedule_walks_chunks_of_a_wide_row():
    """W 136: three 64-pixel steps a row, the last one ragged; reflected
    columns at both edges of the row, in different steps; a split that
    starts inside a (b, chunk)."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 6, 16, 136, generator=gen)
    g = torch.randn(2, 6, 24, 136, generator=gen)
    for k, reflect in ((3, True), (4, False), (7, True)):
        pad = k // 2 if reflect else cuda_conv.tf_same_pad(k)[0]
        plain = (lambda a, b: cuda_reflect.conv_reflect_dw_plain(a, b, k)
                 if reflect else cuda_conv.conv_dw_plain(a, b, k, pad))
        got = emulate(x, g, k, pad, reflect, splits=5)
        assert _close(got, plain(x, g), plain(x.abs(), g.abs())), k


def _dw_launches():
    """{(C, Cout, K, pad, reflect): launches} of the bf16 dW launches of
    chip_smoke.py's train plans (batch 8, 256x256; the fifth recipe at its
    batch) and of U-GAT-IT's step, keyed without batch and side, and the
    full shapes."""
    cfgs = {"unet": "model_instances/converged256/model_config.yaml",
            "resnet": "configs/resnet.yaml",
            "unet_transpose": "configs/unet_transpose.yaml",
            "strided": "configs/strided_unet.yaml",
            "unet_patchgan": "configs/unet_patchgan.yaml"}
    shapes = []
    for name, path in cfgs.items():
        derive = (chip_smoke.resnet_train_launches if name == "resnet"
                  else chip_smoke.train_launches)
        batch = (chip_smoke.PATCHGAN_BATCH if name == "unet_patchgan"
                 else chip_smoke.BATCH)
        plan = derive(yaml2namespace(path), batch, chip_smoke.SIZE)
        shapes += [(b, h, c, co, k, pad, False)
                   for b, h, c, co, k, pad in plan.get("conv_dw", [])]
        shapes += [(b, h, c, co, k, k // 2, True)
                   for b, h, c, co, k in plan.get("conv_reflect_dw", [])]
    ugatit = chip_smoke.ugatit_dw_launches()
    shapes += [(b, h, c, co, k, k // 2, True)
               for b, h, c, co, k in ugatit["conv_reflect_dw"]]
    return shapes


MAIN_PATH = sorted({s[2:] for s in _dw_launches()})


@pytest.mark.parametrize("c,cout,k,pad,reflect", MAIN_PATH)
def test_tma_schedule_at_a_main_path_cut(c, cout, k, pad, reflect):
    """Each main-path (C, Cout, K) with its cut (blocks, N tiles, ring) on
    a small image, two 64-pixel steps a row."""
    gen = torch.Generator().manual_seed(c * 7 + cout * 3 + k)
    x = torch.randn(1, 8, c, 128, generator=gen)
    g = torch.randn(1, 8, cout, 128, generator=gen)
    if reflect:
        want = cuda_reflect.conv_reflect_dw_plain(x, g, k)
        scale = cuda_reflect.conv_reflect_dw_plain(x.abs(), g.abs(), k)
    else:
        want = cuda_conv.conv_dw_plain(x, g, k, pad)
        scale = cuda_conv.conv_dw_plain(x.abs(), g.abs(), k, pad)
    assert _close(emulate(x, g, k, pad, reflect), want, scale)


def test_tma_splits_at_the_main_path_shapes():
    """One block per SM, at least 16 steps a slice: the ResNet and U-GAT-IT
    trunk (9 blocks x 2 N tiles) 7 slices, the U-Net discriminator's k7
    (2 blocks of 4 tiles a warpgroup) 66, a 32x32 image of 256 steps at
    most 16."""
    geo = cuda_conv.dw_tma_geometry(8, 64, 64, 256, 256, 3, 1)
    assert (geo["m_blocks"], geo["n_tiles"], geo["splits"]) == (9, 2, 7)
    geo = cuda_conv.dw_tma_geometry(8, 256, 256, 16, 16, 7, 3)
    assert (geo["mt"], geo["m_blocks"], geo["splits"]) == (4, 2, 66)
    geo = cuda_conv.dw_tma_geometry(8, 32, 32, 128, 128, 4, 1)
    assert geo["units"] == 256 and geo["splits"] == 16


def test_every_main_path_dw_launch_is_in_the_tma_domain():
    shapes = _dw_launches()
    for b, h, c, cout, k, pad, reflect in shapes:
        x = torch.empty((1, 1, c, h), dtype=torch.bfloat16)
        gy = torch.empty((1, 1, cout, h), dtype=torch.bfloat16)
        assert cuda_conv.dw_tma_domain(x, gy, k, pad, reflect), (
            b, h, c, cout, k)
        geo = cuda_conv.dw_tma_geometry(b, h, h, c, cout, k, pad)
        assert geo["smem"] <= 232448 and geo["eff"] >= 0.25
        assert geo["n"] * geo["n_tiles"] >= cout
        assert geo["m_blocks"] * geo["n_tiles"] * geo["splits"] <= max(
            132, geo["m_blocks"] * geo["n_tiles"])
    # U-Net 124 + 10, ResNet 120 + 4, T 124 + 10, S 40 + 4, unet_patchgan
    # 90 + 4, U-GAT-IT 6 x 20
    assert len(shapes) == 134 + 124 + 134 + 44 + 94 + 120


def test_tma_domain_rule():
    x = torch.zeros((1, 2, 3, 64), dtype=torch.bfloat16)
    assert cuda_conv.dw_tma_domain(x, x, 3, 1)
    assert not cuda_conv.dw_tma_domain(x.float(), x.float(), 3, 1)
    odd = torch.zeros((1, 2, 3, 12), dtype=torch.bfloat16)
    assert not cuda_conv.dw_tma_domain(odd, odd, 3, 1)
    flat = torch.zeros(2 * 3 * 64 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(1, 2, 3, 64)  # 2 bytes past an aligned base
    assert not cuda_conv.dw_tma_domain(shifted, x, 3, 1)
    # a window wider than 96 pixels: K 35 pads 17 before and after
    assert cuda_conv.dw_tma_domain(x, x, 33, 16)
    assert not cuda_conv.dw_tma_domain(x, x, 35, 17)
    # K9-dW needs a line past the raw row's end: K up to 17
    assert cuda_conv.dw_tma_domain(x, x, 17, 8, reflect=True)
    assert not cuda_conv.dw_tma_domain(x, x, 19, 9, reflect=True)
