"""U-GAT-IT in the port (``models/ugatit.py``, ``ops/ada_norm.py``, the
``ugatit`` losses of ``losses.py`` through ``steps.py``) against the
benchmark's plain reference ``benchmark/reference/ugatit.py``, on the CPU
at 128x128, ngf/ndf 8, two residual blocks, batch 2 (the global
discriminator needs 128x128): the networks' outputs and spectral-norm
updates, the AdaLIN/ILN op against its formula (and ``gradcheck`` in
f64), two train steps, the validate step, a checkpoint round trip and
``InferenceSession.stylize``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import ugatit as ref
from cyclegan_tpu_torch import steps
from cyclegan_tpu_torch.config import Namespace, namespace2yaml
from cyclegan_tpu_torch.data.augment import random_jitter_batch
from cyclegan_tpu_torch.losses import ugatit_losses
from cyclegan_tpu_torch.models import create_model
from cyclegan_tpu_torch.ops import layout
from cyclegan_tpu_torch.ops.ada_norm import (
    AdaNorm,
    ada_norm,
    ada_norm_bwd_plain,
    ada_norm_plain,
)

SIZE, BATCH = 128, 2
OPT = {"name": "adam", "learning_rate": 1e-2, "beta_1": 0.5, "beta_2": 0.999,
       "epsilon": 1e-8, "weight_decay": 1e-4}
CFG = {"generator": {"type": "ugatit_generator", "ngf": 8, "n_res": 2,
                     "img_size": SIZE},
       "discriminator": {"type": "ugatit_discriminator", "ndf": 8,
                         "n_layers_global": 7, "n_layers_local": 5},
       "loss": "ugatit",
       "loss_weights": {"adversarial": 1.0, "cycle": 10.0, "identity": 10.0,
                        "cam": 1000.0},
       "image_size": SIZE, "optimizer": OPT}
WEIGHTS = CFG["loss_weights"]
NETWORKS = steps.NETWORKS
LAYOUTS = ("NHWC", "NHCW")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(seed=0, rho_near_bounds=False):
    """The reference's seeded weights; optionally every AdaLIN rho at
    0.995 and ILN rho at 0.005, so that a large step crosses [0, 1]."""
    w = ref.make_weights(CFG, seed, "cpu")
    if rho_near_bounds:
        for n in ("g_AB", "g_BA"):
            for k in w[n]:
                if k.endswith(".rho"):
                    w[n][k].fill_(0.995 if k.startswith("ada.") else 0.005)
    return w


def _models(weights):
    gen = torch.Generator().manual_seed(0)
    models = {n: create_model(CFG["generator" if n.startswith("g")
                                  else "discriminator"], gen)
              for n in NETWORKS}
    for n in NETWORKS:
        models[n].load_state_dict(weights[n], strict=True)
    return models


def _images(seed, n=BATCH):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, SIZE, SIZE, 3), generator=g) * 2 - 1


def _scope(name):
    return layout.scope(name)


def _to(name, x):
    return layout.to_nhcw(x) if name == "NHCW" else x


def _nchw(name, y):
    return y.permute(0, 2, 1, 3) if name == "NHCW" else y.permute(0, 3, 1, 2)


@pytest.mark.parametrize("name", LAYOUTS)
def test_networks_match_reference(name):
    """Generator (image, CAM logits) and discriminator (four outputs) on
    the reference's weights, and the ``u`` buffers after one power
    iteration each."""
    weights = _weights()
    models = _models(weights)
    x = _images(1)
    xr = x.permute(0, 3, 1, 2)
    o = ref.Ops()
    p_ref = {n: {k: v.clone() for k, v in weights[n].items()}
             for n in NETWORKS}
    with torch.no_grad(), _scope(name):
        img, cam = models["g_AB"](_to(name, x))
        want_img, want_cam = ref.generator(o, CFG["generator"],
                                           p_ref["g_AB"], xr)
        assert torch.allclose(_nchw(name, img), want_img, atol=2e-5)
        assert torch.allclose(cam, want_cam, atol=2e-5, rtol=1e-5)
        got = models["d_A"](_to(name, x))
        want = ref.discriminator(o, CFG["discriminator"], p_ref["d_A"], xr)
    for g, w in zip(got, want):
        g = _nchw(name, g) if g.dim() == 4 else g
        assert g.shape == w.shape
        assert torch.allclose(g, w, atol=2e-5, rtol=1e-4)
    state = models["d_A"].state_dict()
    moved = 0
    for k, v in state.items():
        if k.endswith(".u"):
            assert torch.allclose(v, p_ref["d_A"][k], atol=1e-6), k
            moved += int(not torch.equal(v, weights["d_A"][k]))
    assert moved >= 1


def _formula(x, rho, gamma, beta, relu):
    """The authors' adaILN / ILN on NCHW x, as ``torch.var``'s unbiased
    variance."""
    return ref.Ops().ada_lin(x, rho, gamma, beta, relu)


@pytest.mark.parametrize("per_sample", [True, False], ids=["adalin", "iln"])
@pytest.mark.parametrize("relu", [False, True])
def test_ada_norm_matches_formula(per_sample, relu):
    g = torch.Generator().manual_seed(3)
    B, H, C, W = 3, 6, 5, 8
    x = torch.randn((B, H, C, W), generator=g) * 2 + 1.5
    rho = torch.rand(C, generator=g)
    shape = (B, C) if per_sample else (C,)
    gamma = torch.randn(shape, generator=g)
    beta = torch.randn(shape, generator=g)
    want = _formula(x.permute(0, 2, 1, 3), rho, gamma, beta, relu)
    got = ada_norm_plain(x, rho, gamma, beta, relu=relu)
    assert torch.allclose(got.permute(0, 2, 1, 3), want, atol=2e-5)
    with layout.nhwc():
        nhwc = ada_norm(x.permute(0, 1, 3, 2), rho, gamma, beta, relu=relu)
    assert torch.allclose(nhwc.permute(0, 3, 1, 2), want, atol=2e-5)


@pytest.mark.parametrize("per_sample", [True, False], ids=["adalin", "iln"])
@pytest.mark.parametrize("relu", [False, True])
def test_ada_norm_gradcheck(per_sample, relu):
    """K15's plain backward (through ``AdaNorm``) against finite
    differences in f64, at a tiny size."""
    g = torch.Generator().manual_seed(4)
    B, H, C, W = 2, 3, 3, 4
    x = (torch.randn((B, H, C, W), generator=g, dtype=torch.float64)
         + 0.3).requires_grad_()
    rho = torch.rand(C, generator=g, dtype=torch.float64).requires_grad_()
    shape = (B, C) if per_sample else (C,)
    gamma = torch.randn(shape, generator=g,
                        dtype=torch.float64).requires_grad_()
    beta = (torch.randn(shape, generator=g, dtype=torch.float64)
            + 0.5).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda *a: AdaNorm.apply(*a, 1e-5, relu), (x, rho, gamma, beta),
        eps=1e-6, atol=1e-6)


def test_ada_norm_backward_matches_autograd():
    """The closed-form backward against autograd of the formula, f32."""
    g = torch.Generator().manual_seed(5)
    B, H, C, W = 2, 8, 6, 16
    x = torch.randn((B, H, C, W), generator=g) * 3 + 2
    rho, gamma = torch.rand(C, generator=g), torch.randn((B, C), generator=g)
    beta, gy = torch.randn((B, C), generator=g), torch.randn(x.shape,
                                                            generator=g)
    leaves = [t.clone().requires_grad_() for t in (x, rho, gamma, beta)]
    y = _formula(leaves[0].permute(0, 2, 1, 3), *leaves[1:], relu=True)
    want = torch.autograd.grad(y, leaves, gy.permute(0, 2, 1, 3))
    _, saved, stats = ada_norm_plain(x, rho, gamma, beta, relu=True,
                                     with_stats=True)
    got = ada_norm_bwd_plain(x, gy, rho, gamma, saved, stats, relu=True)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, atol=2e-4, rtol=1e-4)


def _state(weights, name="NHCW"):
    return steps.init_train_state(_models(weights), {"g_opt": OPT,
                                                     "d_opt": OPT},
                                  seed=0, device="cpu")


def _gap(got, want):
    """A leaf's gap: the norm of the difference over the reference's."""
    return float((got - want).norm() / want.norm().clamp_min(1e-12))


# The f32 reference against itself on channels-last inputs (other
# convolution algorithms) moves g_AB's AdaLIN leaves by up to 2.6e-3 and
# its median leaf by 2.6e-4 at these weights (g_BA's 4e-5, the
# discriminators' 5e-7): a ReLU of the gamma/beta MLP lies near its kink.
# A leaf may move by twice that, a network's median leaf by four times.
LEAF_GAP, MEDIAN_GAP = 5e-3, 1e-3


def test_train_step_gradients_and_update():
    """Two port steps (no jitter): each step's losses and four gradients
    against the reference's, and the parameters after the port's update
    against the reference's Adam (weight decay, then the rho clip) on the
    port's own gradients (Adam's first steps are nearly sign(g), so a
    gradient element near 0 would swing the comparison)."""
    weights = _weights(rho_near_bounds=True)
    state = _state(weights)
    step = steps.make_train_step("ugatit", WEIGHTS, "float32")
    a, b = _images(6), _images(7)
    p = {n: {k: v.clone() for k, v in weights[n].items()} for n in NETWORKS}
    opts = {n: ref.Adam(OPT["learning_rate"], OPT["beta_1"], OPT["beta_2"],
                        OPT["epsilon"], OPT["weight_decay"])
            for n in NETWORKS}
    for i in range(2):
        metrics = step(state, a, b)
        live = {n: {k: (v.detach().requires_grad_(True) if ref.trainable(k)
                        else v) for k, v in p[n].items()} for n in NETWORKS}
        ls = ref.losses(CFG, ref.Ops(), live, a.permute(0, 3, 1, 2),
                        b.permute(0, 3, 1, 2))
        ref_grads = {}
        for n, loss in zip(NETWORKS, ref.LOSS_NAMES):
            assert abs(float(metrics[loss]) - float(ls[loss].detach())
                       ) <= 1e-5 * abs(float(ls[loss].detach())), (i, loss)
            keys = [k for k in live[n] if ref.trainable(k)]
            grads = torch.autograd.grad(ls[loss], [live[n][k] for k in keys],
                                        retain_graph=True)
            params = dict(state.models[n].named_parameters())
            gaps = [_gap(params[k].grad, gr) for k, gr in zip(keys, grads)]
            assert max(gaps) <= LEAF_GAP, (i, n, max(zip(gaps, keys)))
            assert float(np.median(gaps)) <= MEDIAN_GAP, (i, n)
            ref_grads[n] = dict(zip(keys, grads))
        for n in NETWORKS:  # the reference's Adam on the port's gradients
            params = dict(state.models[n].named_parameters())
            opts[n].update(p[n], {k: params[k].grad.detach().clone()
                                  for k in ref_grads[n]})
        for n in ("g_AB", "g_BA"):
            for k, v in p[n].items():
                if k.endswith(".rho"):
                    v.clamp_(0.0, 1.0)
        for n in NETWORKS:
            for k, v in state.models[n].state_dict().items():
                if k.endswith(".u"):
                    assert torch.allclose(v, p[n][k], atol=1e-6), (i, n, k)
                else:
                    assert torch.allclose(v, p[n][k], atol=1e-6,
                                          rtol=1e-5), (i, n, k)
    rhos = torch.cat([r.detach() for r in state.models["g_AB"].rhos()])
    assert float(rhos.max()) == 1.0 and float(rhos.min()) == 0.0


def test_reference_train_matches_port_steps():
    """The reference's ``train`` (jitter, two steps) against the port's
    step with the trainer's jitter: losses, first gradients as Adam took
    them and the parameters' change."""
    weights = _weights(seed=2)
    state = _state(weights)
    size = SIZE

    def jitter(gen, a, b):
        return (random_jitter_batch(gen, a, size),
                random_jitter_batch(gen, b, size))

    step = steps.make_train_step("ugatit", WEIGHTS, "float32", jitter)
    state.generator.manual_seed(9)
    opt = dict(OPT, learning_rate=1e-4)
    for o in state.optimizers.values():
        o.param_groups[0]["lr"] = opt["learning_rate"]
    g = torch.Generator().manual_seed(8)
    batches = [tuple(torch.randint(0, 256, (BATCH, 100, 100, 3), generator=g,
                                   dtype=torch.uint8) for _ in range(2))
               for _ in range(2)]
    start = {n: {k: v.detach().clone() for k, v in
                 state.models[n].named_parameters()} for n in NETWORKS}
    losses = []
    for i, (a, b) in enumerate(batches):
        m = step(state, a, b)
        losses.append({k: float(m[k]) for k in ref.LOSS_NAMES})
        if i == 0:
            firsts = {f"{n}.{k}": float(state.optimizers[n].state[p][
                "exp_avg"].norm()) / (1 - opt["beta_1"])
                for n in NETWORKS
                for k, p in state.models[n].named_parameters()}
    p = {n: {k: v.clone() for k, v in weights[n].items()} for n in NETWORKS}
    cfg = dict(CFG, optimizer=opt)
    want_losses, want_grads, want_change = ref.train(cfg, p, batches, 9)
    for got, want in zip(losses, want_losses):
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), k
    assert max(abs(firsts[k] - v) / v for k, v in want_grads.items()
               ) <= LEAF_GAP
    gaps = [abs(float((v.detach() - start[n][k]).norm())
                - want_change[f"{n}.{k}"]) / want_change[f"{n}.{k}"]
            for n in NETWORKS for k, v in state.models[n].named_parameters()]
    assert float(np.median(gaps)) <= MEDIAN_GAP


@pytest.mark.parametrize("tpu_layout", [False, True])
def test_validate_step_matches_reference(tpu_layout):
    """The validate step (the forward set without stop-gradients, the
    networks in eval mode): its four losses against the U-GAT-IT losses
    of the reference's generators and of its discriminators without a
    power iteration; every ``u`` unchanged, the networks back in train
    mode."""
    weights = _weights(seed=4)
    state = _state(weights)
    a, b = _images(3), _images(4)
    metrics = steps.make_validate_step("ugatit", WEIGHTS, "float32",
                                       tpu_layout=tpu_layout)(state, a, b)
    o, ra, rb = ref.Ops(), a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
    with torch.no_grad():
        def g(name, x):
            return ref.generator(o, CFG["generator"], weights[name], x)

        def d(name, x):
            return ref.discriminator(o, CFG["discriminator"], weights[name],
                                     x, power_iteration=False)

        fake_b, fake_a = g("g_AB", ra), g("g_BA", rb)
        d_fake_a, d_fake_b = d("d_A", fake_a[0]), d("d_B", fake_b[0])
        _, want = ugatit_losses(
            WEIGHTS, ra, rb, fake_a, fake_b, g("g_BA", fake_b[0]),
            g("g_AB", fake_a[0]), g("g_BA", ra), g("g_AB", rb),
            d("d_A", ra), d("d_B", rb), d_fake_a, d_fake_b, d_fake_a,
            d_fake_b)
    for k in ref.LOSS_NAMES:
        assert abs(float(metrics[k]) - float(want[k])) <= 1e-5 * abs(
            float(want[k])), k
    for n in NETWORKS:
        assert state.models[n].training
        for k, v in state.models[n].state_dict().items():
            if k.endswith(".u"):
                assert torch.equal(v, weights[n][k]), (n, k)


@pytest.mark.parametrize("option", ["paired", "fuse_apps", "remat", "mesh"])
def test_refused_options(option):
    kw = {"mesh": object()} if option == "mesh" else {option: True}
    with pytest.raises(ValueError, match="U-GAT-IT"):
        steps.make_train_step("ugatit", WEIGHTS, "float32", **kw)


def test_checkpoint_round_trip(tmp_path):
    """``u`` buffers, rho and Adam's state through the trainer's
    checkpoint into a fresh state."""
    from cyclegan_tpu_torch.utils.checkpoint import (
        load_train_state,
        save_train_state,
    )

    state = _state(_weights())
    steps.make_train_step("ugatit", WEIGHTS, "float32")(
        state, _images(1), _images(2))
    path = tmp_path / "ckpt.npz"
    save_train_state(path, state, np.zeros(2, np.uint32))
    fresh = _state(_weights(seed=5))
    load_train_state(path, fresh)
    for n in NETWORKS:
        want = state.models[n].state_dict()
        got = fresh.models[n].state_dict()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (n, k)
        for p, q in zip(state.models[n].parameters(),
                        fresh.models[n].parameters()):
            assert torch.equal(state.optimizers[n].state[p]["exp_avg"],
                               fresh.optimizers[n].state[q]["exp_avg"])
    assert any(k.endswith(".u") for k in got)


@pytest.mark.parametrize("tpu_layout", [False, True])
def test_session_stylize_matches_reference(tmp_path, tpu_layout):
    from cyclegan_tpu_torch.apps.inference import InferenceSession
    from cyclegan_tpu_torch.utils.checkpoint import save_model_folder

    weights = _weights(seed=3)
    models = _models(weights)
    cfg_path = tmp_path / "cfg.yaml"
    namespace2yaml(cfg_path, Namespace({k: CFG[k] for k in (
        "generator", "discriminator", "loss", "loss_weights")}))
    save_model_folder(tmp_path / "m", cfg_path, models)
    session = InferenceSession(tmp_path / "m", "float32",
                               tpu_layout=tpu_layout, device="cpu")
    images = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3),
                           generator=torch.Generator().manual_seed(4),
                           dtype=torch.uint8)
    got = session.stylize(images.numpy(), "b2a")
    want = ref.stylize(CFG["generator"], weights["g_BA"], images).numpy()
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
