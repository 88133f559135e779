"""K1's and K9's tensor-core schedule (kernels/csrc/conv_same.cu), emulated
in torch ops on the CPU, against the plain convolutions.

No CPU runs the kernel, so this holds its index map: the pack's padded,
channel-grouped copy xp [cg, B, hp, wp, 8] (zeros for K1 with the pad and
grow of the launch, the reflect map for K9, channels past C zero up to a
multiple of 16) and K-major weights wp [nt, c16, K*K, 2, n, 8] in N tiles
(``conv_tc_pack_plain``); a block's M tile of ``bm`` flattened padded
pixels by one N tile; one stage per 16 channels and run of ``rows`` tap
rows, laid out as the shared memory holds it: the window of ``nw`` pixels
per channel group from the run's first row on (offset dy0 wp), cut off at
the end of xp (the pixels past it are stale, here NaN, and must
never reach the output), then the run's weights; both operands read
through wgmma's no-swizzle K-major descriptor (core matrices of 8 rows x
16 bytes, ``sbo`` 128 bytes between 8-row groups, ``lbo`` between the two
channel groups of a k16 step) with tap (dy, dx) the window's start moved
by (dy - dy0) wp + dx; N = Cout rounded up; and
the junk rows (w >= wo, h >= ho) never stored. f32, tolerance 1e-5 sum
|x| |w| (chip_smoke.py's scale: only the order of the sum differs). Then
every bf16 K1 and K9 launch of chip_smoke.py's serving and train plans is
checked to lie in ``conv_tc_domain`` with a stage ring of at least two
stages (one would wait on itself) that fits the H100's 227 KB, as are
chip_smoke.py's edge shapes.
"""

import pytest
import torch

import chip_smoke
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.ops import cuda_conv, cuda_reflect


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def desc_read(stage, start, lbo, sbo, rows):
    """[rows, 16] bf16-element operand that wgmma reads through a K-major
    no-swizzle descriptor from ``stage`` (flat, in elements): row r, column
    k at start + (r // 8) sbo + (r % 8) 8 + (k // 8) lbo + k % 8 (start,
    lbo and sbo in elements, 8 to a 16-byte unit)."""
    r = torch.arange(rows)[:, None]
    k = torch.arange(16)[None, :]
    return stage[start + (r // 8) * sbo + (r % 8) * 8 + (k // 8) * lbo
                 + k % 8]


def emulate(x, w, bias, pad, grow=0, reflect=False):
    """out [B, ho, Cout, wo] f32 as the tensor-core design computes it."""
    B, H, C, W = x.shape
    k, cout = int(w.shape[0]), int(w.shape[3])
    geo = cuda_conv.conv_tc_geometry(B, H, C, W, cout, k, grow)
    xp, wp = cuda_conv.conv_tc_pack_plain(x, w, pad, grow, reflect)
    cg, n, nt, bm, nw, ptot, rows, groups = (
        geo[key] for key in
        ("cg", "n", "nt", "bm", "nw", "ptot", "rows", "groups"))
    hp, wq, ho, wo = geo["hp"], geo["wp"], geo["ho"], geo["wo"]
    assert xp.shape == (cg, B, hp, wq, 8) and n % 8 == 0
    assert wp.shape == (nt, geo["c16"], k * k, 2, n, 8) and nt * n >= cout
    assert cg * 8 >= C and cg % 2 == 0
    assert geo["steps"] == geo["c16"] * groups and rows * groups == k
    assert 2 <= geo["stages"] or geo["steps"] == 1
    xflat = xp.reshape(cg, ptot, 8)
    result = torch.full((geo["blocks"] * bm, nt * n), float("nan"))
    for tile in range(nt):
        for blk in range(geo["blocks"]):
            m0 = blk * bm
            acc = torch.zeros(bm, n)
            for i in range(geo["steps"]):
                step, dy0 = i // groups, (i % groups) * rows
                dy1 = dy0 + rows
                start = m0 + dy0 * wq
                # the bulk copy stops at the end of xp
                valid = max(0, min(nw, ptot - start))
                window = torch.full((2, nw, 8), float("nan"))
                window[:, :valid] = xflat[2 * step:2 * step + 2,
                                          start:start + valid]
                stage = torch.cat([
                    window.reshape(-1),
                    wp[tile, step, dy0 * k:dy1 * k].reshape(-1)])
                wbase = 2 * nw * 8
                for dy in range(dy1 - dy0):
                    for dx in range(k):
                        off = dy * wq + dx
                        assert off + bm <= nw
                        b = desc_read(stage,
                                      wbase + (dy * k + dx) * 2 * n * 8,
                                      n * 8, 64, n)
                        a = desc_read(stage, off * 8, nw * 8, 64, bm)
                        acc += a @ b.T
            result[m0:m0 + bm, tile * n:(tile + 1) * n] = acc
    m = torch.arange(ptot)
    bb, rem = m // (hp * wq), m % (hp * wq)
    h, ww = rem // wq, rem % wq
    keep = (h < ho) & (ww < wo)
    assert int(keep.sum()) == B * ho * wo
    out = result[:ptot][keep].reshape(B, ho, wo, nt * n)[..., :cout]
    if bias is not None:
        out = out + bias
    return out.permute(0, 1, 3, 2)


# (K, pad, grow, reflect, C, Cout): every class of the plans' launches.
# K1 forward pads (K-1)/2 before, its input gradient K-1-(K-1)/2; the
# reflect conv's input gradient is K1 at pad p and grow p; K9 reflects.
CASES = [
    (1, 0, 0, False, 48, 1), (1, 0, 0, False, 1, 80),
    (1, 0, 0, False, 16, 256),
    (3, 1, 0, False, 16, 48), (3, 1, 0, False, 80, 16),
    (4, 1, 0, False, 3, 16), (4, 2, 0, False, 80, 3),
    (4, 2, 0, False, 16, 192),
    (5, 2, 0, False, 48, 80), (5, 2, 0, False, 1, 48),
    (7, 3, 0, False, 3, 16), (7, 3, 0, False, 16, 3),
    (3, 1, 1, False, 80, 48), (7, 3, 3, False, 3, 16),
    (3, 1, 0, True, 48, 48), (3, 1, 0, True, 16, 80),
    (7, 3, 0, True, 3, 16), (7, 3, 0, True, 16, 3),
    # beyond the plans: tap rows cut into runs where two stages of all K*K
    # taps' weights do not fit (k7 32->128, k4 48->256), N tiles past 256
    (7, 3, 0, False, 32, 128), (4, 2, 0, False, 48, 256),
    (7, 3, 0, True, 32, 128), (3, 1, 0, False, 48, 320),
    (1, 0, 0, False, 16, 300),
]


@pytest.mark.parametrize("k,pad,grow,reflect,c,cout", CASES)
def test_emulated_schedule_matches_plain(k, pad, grow, reflect, c, cout):
    g = torch.Generator().manual_seed(k * 1000 + c * 10 + cout)
    B, H, W = 2, 9, 12
    x = torch.randn(B, H, c, W, generator=g)
    w = torch.randn(k, k, c, cout, generator=g) * 0.1
    bias = torch.randn(cout, generator=g)
    got = emulate(x, w, bias, pad, grow, reflect)
    if reflect:
        want = cuda_reflect.conv_reflect_plain(x, w, bias)
        scale = cuda_reflect.conv_reflect_plain(x.abs(), w.abs())
    else:
        want = cuda_conv.conv_same_plain(x, w, bias, pad=pad, grow=grow)
        scale = cuda_conv.conv_same_plain(x.abs(), w.abs(), pad=pad,
                                          grow=grow)
    assert got.shape == want.shape == (B, H + 2 * grow, cout, W + 2 * grow)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= 1e-5 * scale + 1e-6).all()


def test_pack_reflect_is_the_reflect_pad():
    """The reflect pack's interior and halo are ReflectionPadding2D's."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 6, 3, 7, generator=g)
    w = torch.zeros(7, 7, 3, 4)
    xp, _ = cuda_conv.conv_tc_pack_plain(x, w, 3, reflect=True)
    want = torch.nn.functional.pad(x.permute(0, 2, 1, 3), (3,) * 4,
                                   mode="reflect")
    got = xp.permute(1, 0, 4, 2, 3).reshape(2, 16, 12, 13)
    assert torch.equal(got[:, :3], want)
    assert not got[:, 3:].any()


def _plans():
    """{path: {kernel: shapes}} of chip_smoke.py's serving forwards and
    NHCW train steps of the four recipes at batch 8, 256x256."""
    cfgs = {"unet": chip_smoke.MODEL_DIR / "model_config.yaml",
            "resnet": chip_smoke.RESNET_CONFIG,
            "unet_transpose": chip_smoke.TRANSPOSE_CONFIG,
            "strided": chip_smoke.STRIDED_CONFIG}
    plans = {}
    for name, path in cfgs.items():
        cfg = yaml2namespace(path)
        resnet = name == "resnet"
        plans[f"{name}_serve"] = (
            chip_smoke.resnet_generator_launches if resnet
            else chip_smoke.serve_launches)(cfg.generator, 8, 256)
        plans[f"{name}_train"] = (
            chip_smoke.resnet_train_launches if resnet
            else chip_smoke.train_launches)(cfg, 8, 256)
    return plans


def _check_geometry(b, h, c, cout, k, grow):
    geo = cuda_conv.conv_tc_geometry(b, h, c, h, cout, k, grow)
    # two stages wherever there are two steps: consumers free a step's
    # stage only after the next step's wait, so one stage would deadlock
    assert min(geo["steps"], 2) <= geo["stages"] <= min(
        geo["steps"], cuda_conv.TC_MAX_STAGES), (b, h, c, cout, k, geo)
    assert geo["smem"] <= cuda_conv.TC_SMEM_MAX
    assert geo["nt"] * geo["n"] >= cout and geo["n"] % 8 == 0
    assert geo["n"] <= 256 and geo["rows"] * geo["groups"] == k
    # the descriptor's address and LBO fields hold 14 bits of 16-byte
    # units: everything lies below 256 KB
    assert 2 * geo["nw"] * 16 < 2 ** 18
    return geo


def test_every_bf16_launch_of_the_plans_takes_the_tensor_cores():
    x = torch.zeros((), dtype=torch.bfloat16)
    assert cuda_conv.conv_tc_domain(x)
    assert not cuda_conv.conv_tc_domain(x.float())
    seen = 0
    for path, plan in _plans().items():
        # conv_same (B, H, Cin, Cout, K, bias, pad[, grow]): the reflect
        # conv's input gradient runs at grow p on dY of side h
        launches = [(s[0], s[1], s[2], s[3], s[4],
                     s[7] if len(s) > 7 else 0)
                    for s in plan.get("conv_same", [])]
        launches += [(s[0], s[1], s[2], s[3], s[4], 0)
                     for s in plan.get("conv_reflect", [])]
        for shape in set(launches):
            geo = _check_geometry(*shape)
            # every launch of the recipes takes all K tap rows per stage
            # and one N tile
            assert geo["groups"] == 1 and geo["nt"] == 1, (path, shape)
            seen += 1
    assert seen > 40


def test_chip_smoke_edge_shapes_cut_taps_and_tile_n():
    """chip_smoke.py's phase-2 shapes beyond the plans run the tap rows in
    runs (k7 32->128, k4 64->256) and tile N (Cout 320), each with a
    ring of at least two stages."""
    runs = tiles = 0
    for name, shapes in chip_smoke.EDGE_CONV_SHAPES.items():
        for s in shapes:
            grow = s[7] if name == "conv_same" and len(s) > 7 else 0
            geo = _check_geometry(s[0], s[1], s[2], s[3], s[4], grow)
            runs += geo["groups"] > 1
            tiles += geo["nt"] > 1
    assert runs >= 3 and tiles >= 1
