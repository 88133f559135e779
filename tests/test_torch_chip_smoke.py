"""chip_smoke.py's launch plans are the real ones.

chip_smoke.py checks and times each kernel at the shape of every launch of
one generator forward and of one train step, from plans it derives from
the config. Here each plan is held against the launches a forward and a
train step really make, recorded on the CPU through the plain versions the
wrappers call there.
"""

import collections

import numpy as np
import pytest
import torch

import chip_smoke
from cyclegan_tpu_torch import steps
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.data.augment import random_jitter_batch
from cyclegan_tpu_torch.models import ResNetGenerator, create_model
from cyclegan_tpu_torch.ops import (cuda_concat, cuda_conv, cuda_norm,
                                    cuda_norm_act, cuda_reflect, cuda_resize,
                                    layout)

NEW_RECIPES = ["configs/unet_transpose.yaml", "configs/strided_unet.yaml"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU shapes: the suite runs in
    several worker processes at once, and torch's default of one thread
    per core in each of them oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _nhcw_layout():
    """These tests feed the ops and networks NHCW activations, the layout
    of the port's kernels; the default layout scope is NHWC."""
    with layout.nhcw():
        yield


@pytest.mark.parametrize("config", [
    "model_instances/converged256/model_config.yaml",
    "configs/smoke.yaml",
    *NEW_RECIPES,
])
def test_launch_plan_matches_a_recorded_forward(config, monkeypatch):
    cfg = yaml2namespace(config).generator
    batch, size = 2, 32
    seen = collections.defaultdict(list)

    def record(module, name, key, shape_of):
        plain = getattr(module, name)

        def wrapper(*args, **kwargs):
            seen[key].append(shape_of(*args))
            return plain(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapper)

    record(cuda_conv, "conv_same_plain", "conv_same",
           lambda x, w, b=None: (x.shape[0], x.shape[1], x.shape[2],
                                 w.shape[3], w.shape[0], b is not None))
    record(cuda_norm_act, "instance_norm_act_plain", "instance_norm_act",
           _norm_shape)
    record(cuda_resize, "sum2x2_plain", "sum2x2",
           lambda x, *a: (x.shape[0], x.shape[1], x.shape[2]))
    record(cuda_concat, "concat_up2_plain", "concat_up2",
           lambda skip, x: (skip.shape[0], skip.shape[1], skip.shape[2],
                            x.shape[2]))
    record(cuda_concat, "concat2_plain", "concat2",
           lambda a, b: (a.shape[0], a.shape[1], a.shape[2], b.shape[2]))
    model = create_model(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(torch.zeros(batch, size, 3, size))
    assert chip_smoke.generator_launches(cfg, batch, size) == dict(seen)


def _norm_shape(x, gamma, beta, eps, act, *args, **kwargs):
    return (x.shape[0], x.shape[1], x.shape[2], act, gamma is not None)


def _norm_bwd_shape(x, gz, gamma, beta, mu, rstd, act, *args):
    return (x.shape[0], x.shape[1], x.shape[2], act, gamma is not None)


def test_default_generator_launch_counts():
    cfg = yaml2namespace("model_instances/converged256/model_config.yaml")
    plan = chip_smoke.generator_launches(cfg.generator, 8, 256)
    assert {k: len(v) for k, v in plan.items()} == {
        "conv_same": 15, "instance_norm_act": 14, "sum2x2": 3,
        "concat_up2": 3}
    assert (8, 128, 160, 64, 4, False) in plan["conv_same"]
    assert plan["conv_same"][-1] == (8, 256, 32, 3, 1, True)


def _record_train_step(monkeypatch, model_cfg, batch, size, **step_kw):
    """Every kernel launch of one bf16 train step (jitter inside), recorded
    on the CPU through the plain versions the Functions call there;
    ``step_kw`` picks the step's layout."""
    seen = collections.defaultdict(list)

    def record(module, name, key, shape_of):
        plain = getattr(module, name)

        def wrapper(*args, **kwargs):
            seen[key].append(shape_of(*args, **kwargs))
            return plain(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapper)

    def conv_shape(x, w, b=None, pad=None, grow=0):
        k = int(w.shape[0])
        shape = (x.shape[0], x.shape[1], x.shape[2], w.shape[3], k,
                 b is not None, cuda_conv.tf_same_pad(k)[0] if pad is None
                 else pad)
        return shape + (grow,) if grow else shape

    def plane(x, *args, **kwargs):
        return (x.shape[0], x.shape[1], x.shape[2])

    record(cuda_conv, "conv_same_plain", "conv_same", conv_shape)
    record(cuda_conv, "conv_dw_plain", "conv_dw",
           lambda x, g, k, pad: (x.shape[0], x.shape[1], x.shape[2],
                                 g.shape[2], k, pad))
    record(cuda_norm_act, "instance_norm_act_plain", "instance_norm_act",
           _norm_shape)
    record(cuda_norm_act, "instance_norm_act_bwd_plain",
           "instance_norm_act_bwd", _norm_bwd_shape)
    record(cuda_reflect, "conv_reflect_plain", "conv_reflect",
           lambda x, w, b=None: (x.shape[0], x.shape[1], x.shape[2],
                                 w.shape[3], w.shape[0], b is not None))
    record(cuda_reflect, "conv_reflect_dw_plain", "conv_reflect_dw",
           lambda x, g, k: (x.shape[0], x.shape[1], x.shape[2], g.shape[2],
                            k))
    record(cuda_reflect, "reflect_fold_plain", "reflect_fold",
           lambda dxp, p: (dxp.shape[0], dxp.shape[1] - 2 * p, dxp.shape[2],
                           p))
    record(cuda_resize, "sum2x2_plain", "sum2x2", plane)
    record(cuda_resize, "dup2x2_plain", "dup2x2", plane)
    record(cuda_concat, "concat_up2_plain", "concat_up2",
           lambda skip, x: (skip.shape[0], skip.shape[1], skip.shape[2],
                            x.shape[2]))
    record(cuda_concat, "split_pool2_plain", "split_pool2",
           lambda g, c1: (g.shape[0], g.shape[1], c1, g.shape[2] - c1))
    record(cuda_concat, "concat2_plain", "concat2",
           lambda a, b: (a.shape[0], a.shape[1], a.shape[2], b.shape[2]))
    record(cuda_concat, "split2_plain", "split2",
           lambda g, c1: (g.shape[0], g.shape[1], c1, g.shape[2] - c1))
    record(cuda_norm, "instance_norm_nhwc_plain", "instance_norm_nhwc",
           lambda x, gamma, beta, eps: (x.shape[0], x.shape[1], x.shape[3],
                                        gamma is not None))

    def jitter(generator, a, b):
        return (random_jitter_batch(generator, a, size),
                random_jitter_batch(generator, b, size))

    state = steps.init_train_state(
        steps.build_models(model_cfg),
        yaml2namespace("configs/training_config.yaml"), device="cpu")
    step = steps.make_train_step(model_cfg.loss, model_cfg.loss_weights,
                                 "bfloat16", preprocess=jitter, **step_kw)
    images = torch.zeros(batch, size, size, 3, dtype=torch.uint8)
    step(state, images, images)
    return seen


@pytest.mark.parametrize("config", [
    "model_instances/converged256/model_config.yaml",
    "configs/cycle.yaml",
    *NEW_RECIPES,
])
def test_train_launch_plan_matches_a_recorded_step(config, monkeypatch):
    model_cfg = yaml2namespace(config)
    seen = _record_train_step(monkeypatch, model_cfg, 2, 32)
    plan = chip_smoke.train_launches(model_cfg, 2, 32)
    assert set(seen) == set(plan)
    for name, shapes in plan.items():
        assert collections.Counter(seen[name]) == \
            collections.Counter(shapes), name


def test_default_train_step_launch_counts():
    cfg = yaml2namespace("model_instances/converged256/model_config.yaml")
    plan = chip_smoke.train_launches(cfg, 8, 256)
    assert {k: len(v) for k, v in plan.items()} == {
        "conv_same": 304, "instance_norm_act": 144, "sum2x2": 30,
        "concat_up2": 30, "conv_dw": 134, "instance_norm_act_bwd": 144,
        "dup2x2": 30, "split_pool2": 30}
    # the input gradient of a k4 conv pads 2 before; its forward pads 1
    assert (8, 128, 64, 160, 4, False, 2) in plan["conv_same"]
    assert (8, 128, 160, 64, 4, False, 1) in plan["conv_same"]
    # the generators' 14 k4 convs: 6 forwards at pad 1; input gradients at
    # pad 2 in all 6 applications but the first conv of the 4 whose input
    # is a real image
    k4 = collections.Counter(s[6] for s in plan["conv_same"] if s[4] == 4)
    assert k4 == {1: 6 * 14, 2: 6 * 14 - 4}


@pytest.mark.parametrize("config,forward,step", [
    ("configs/unet_transpose.yaml",
     {"conv_same": 15, "instance_norm_act": 17, "sum2x2": 3, "concat2": 3},
     {"conv_same": 304, "conv_dw": 134, "instance_norm_act": 174,
      "instance_norm_act_bwd": 174, "sum2x2": 30, "dup2x2": 30,
      "concat2": 30, "split2": 30}),
    ("configs/strided_unet.yaml",
     {"instance_norm_act": 6, "concat2": 3},
     {"conv_same": 128, "conv_dw": 44, "instance_norm_act": 96,
      "instance_norm_act_bwd": 96, "sum2x2": 12, "dup2x2": 12,
      "concat_up2": 12, "split_pool2": 12, "concat2": 18, "split2": 18}),
])
def test_new_recipe_launch_counts(config, forward, step):
    """Per serving forward and per batch-8 256x256 train step: K11 and K12
    at every concat (3 per generator, 2 per transpose-expansion
    discriminator; 6 generator and 6 discriminator applications)."""
    cfg = yaml2namespace(config)
    serve = chip_smoke.serve_launches(cfg.generator, 8, 256)
    assert {k: len(v) for k, v in serve.items()} == forward
    plan = chip_smoke.train_launches(cfg, 8, 256)
    assert {k: len(v) for k, v in plan.items()} == step
    # every serving launch is a launch of the train step's forwards
    for name, shapes in serve.items():
        assert set(shapes) <= set(plan[name]), name


def test_new_recipe_concat_shapes():
    t = chip_smoke.train_launches(yaml2namespace(NEW_RECIPES[0]), 8, 256)
    # the generators' three levels, and the discriminators' two, which
    # concat the same widths at 128 and 256
    assert collections.Counter(t["concat2"]) == {
        (8, 64, 64, 128): 6, (8, 128, 32, 64): 12, (8, 256, 16, 32): 12}
    s = chip_smoke.train_launches(yaml2namespace(NEW_RECIPES[1]), 8, 256)
    assert set(s["concat2"]) == {(8, 32, 64, 128), (8, 64, 32, 64),
                                 (8, 128, 16, 32)}
    # the strided up norms take skip + up channels
    assert (8, 32, 192, "relu", True) in s["instance_norm_act"]


def test_resnet_launch_plan_matches_a_recorded_forward(monkeypatch):
    cfg = yaml2namespace("configs/resnet.yaml").generator
    seen = collections.defaultdict(list)
    for module, name, key, shape_of in (
            (cuda_reflect, "conv_reflect_plain", "conv_reflect",
             lambda x, w, b=None: (x.shape[0], x.shape[1], x.shape[2],
                                   w.shape[3], w.shape[0], b is not None)),
            (cuda_norm_act, "instance_norm_act_plain", "instance_norm_act",
             _norm_shape)):
        def wrapper(*args, _plain=getattr(module, name), _key=key,
                    _shape_of=shape_of, **kwargs):
            seen[_key].append(_shape_of(*args, **kwargs))
            return _plain(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapper)
    model = ResNetGenerator(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(torch.zeros(1, 32, 3, 32))
    plan = chip_smoke.resnet_generator_launches(cfg, 1, 32)
    assert dict(seen) == plan
    assert {k: len(v) for k, v in plan.items()} == {
        "conv_reflect": 20, "instance_norm_act": 23}


def test_resnet_train_launch_plan_matches_a_recorded_step(monkeypatch):
    model_cfg = yaml2namespace("configs/resnet.yaml")
    seen = _record_train_step(monkeypatch, model_cfg, 2, 32)
    plan = chip_smoke.resnet_train_launches(model_cfg, 2, 32)
    assert set(seen) == set(plan)
    for name, shapes in plan.items():
        assert collections.Counter(seen[name]) == \
            collections.Counter(shapes), name


def test_resnet_f32_point_is_kink_free():
    """The full-width ResNet f32 step at chip_smoke's comparison point
    meets no ReLU or LeakyReLU input within KINK_MARGIN of zero."""
    model_cfg = yaml2namespace("configs/resnet.yaml")
    point = chip_smoke.RESNET_F32_POINT
    x = chip_smoke.f32_point_inputs(point)
    grads, kink = chip_smoke.nearest_kink(lambda: chip_smoke.step_grads(
        model_cfg, "cpu", "float32", x, seed=point["seed"]))
    assert kink > chip_smoke.KINK_MARGIN
    assert set(grads) == set(steps.NETWORKS)
    flat = [chip_smoke._flat(g) for g in grads.values()]
    assert all(bool(torch.isfinite(g).all()) and g.norm() > 0 for g in flat)


@pytest.mark.parametrize("config", NEW_RECIPES)
def test_unet_f32_point_is_kink_free(config):
    """The full-width f32 steps of the transpose-expansion and strided
    recipes at chip_smoke's comparison point (betas at +-(3..4)) meet no
    ReLU input within KINK_MARGIN of zero."""
    model_cfg = yaml2namespace(config)
    point = chip_smoke.UNET_F32_POINT
    x = chip_smoke.f32_point_inputs(point)
    grads, kink = chip_smoke.nearest_kink(lambda: chip_smoke.step_grads(
        model_cfg, "cpu", "float32", x, seed=point["seed"],
        beta=point["beta"]))
    assert kink > chip_smoke.KINK_MARGIN
    assert set(grads) == set(steps.NETWORKS)
    flat = [chip_smoke._flat(g) for g in grads.values()]
    assert all(bool(torch.isfinite(g).all()) and g.norm() > 0 for g in flat)


@pytest.mark.parametrize("config", [
    "configs/cycle.yaml", "configs/resnet.yaml", *NEW_RECIPES])
def test_pre_norm_bias_names_the_biases_a_norm_removes(config):
    """Adding a constant to a bias that ``pre_norm_bias`` names leaves the
    network's output as it was (up to rounding); adding it to any other
    bias moves the output."""
    cfg = yaml2namespace(config)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (1, 32, 3, 32)).astype(np.float32))
    for part in ("generator", "discriminator"):
        model = create_model(cfg[part], torch.Generator().manual_seed(0))
        with torch.no_grad():
            base = model(x)
            for key, p in model.named_parameters():
                if not key.endswith(".b"):
                    continue
                p += 0.5
                moved = float((model(x) - base).abs().max())
                p -= 0.5
                if chip_smoke.pre_norm_bias(key):
                    assert moved <= 1e-4, (part, key, moved)
                else:
                    assert moved > 1e-3, (part, key, moved)


@pytest.mark.parametrize("shape", [(2, 8, 3, 3), (1, 6, 5, 1)])
def test_reflect_fold_library_call_is_the_same_function(shape, monkeypatch):
    """K10's library yardstick (the adjoint of reflect padding) computes
    the plain fold's function."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    _, plain, library, *_ = chip_smoke.make_case("reflect_fold", shape,
                                                 torch.float32, 0)
    want = plain()[0].permute(0, 2, 1, 3)
    torch.testing.assert_close(library(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 8, 3, 5), (1, 6, 1, 2),
                                   (2, 64, 64, 128)])
def test_split_pool2_library_call_is_the_same_function(shape, monkeypatch):
    """K8's library yardstick, two calls timed together (the skip part's
    copy and ``aten.upsample_nearest2d_backward`` on the NCHW view of the
    rest), computes the plain version's function in f32."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    _, plain, library, *_ = chip_smoke.make_case("split_pool2", shape,
                                                 torch.float32, 0)
    dskip, dx = plain()
    got_skip, got_dx = library()
    assert torch.equal(got_skip, dskip)
    torch.testing.assert_close(got_dx.permute(0, 2, 1, 3), dx, rtol=1e-6,
                               atol=1e-6)
    assert "two calls" in chip_smoke.LIBRARY_NOTES["split_pool2"]


def test_default_resnet_train_step_launch_counts():
    cfg = yaml2namespace("configs/resnet.yaml")
    plan = chip_smoke.resnet_train_launches(cfg, 8, 256)
    assert {k: len(v) for k, v in plan.items()} == {
        "conv_reflect": 120, "conv_reflect_dw": 120, "reflect_fold": 116,
        "conv_same": 128, "conv_dw": 4, "instance_norm_act": 156,
        "instance_norm_act_bwd": 156}
    # the head's input gradient: K1 on dY (3 channels) at pad 3, grow 3
    assert (8, 256, 3, 32, 7, False, 3, 3) in plan["conv_same"]
    assert (8, 64, 128, 1) in plan["reflect_fold"]
    assert (8, 32, 256, "leaky_relu", False) in plan["instance_norm_act"]


@pytest.mark.parametrize("config", [
    "model_instances/converged256/model_config.yaml", "configs/resnet.yaml",
    *NEW_RECIPES])
def test_nhwc_train_launch_plan_matches_a_recorded_step(config,
                                                        monkeypatch):
    """The NHWC step with ``pallas_norm`` launches K13 at every instance
    norm of its 12 applications and no other kernel."""
    model_cfg = yaml2namespace(config)
    seen = _record_train_step(monkeypatch, model_cfg, 2, 32,
                              tpu_layout=False, pallas_norm=True)
    plan = chip_smoke.nhwc_train_launches(model_cfg, 2, 32)
    assert set(seen) == {"instance_norm_nhwc"} == set(plan)
    assert collections.Counter(seen["instance_norm_nhwc"]) == \
        collections.Counter(plan["instance_norm_nhwc"])


def test_nhwc_train_step_launch_counts():
    """Per batch-8 256x256 step, as K2's forward count in NHCW."""
    for config, count, nhcw_plan in (
            ("model_instances/converged256/model_config.yaml", 144,
             chip_smoke.train_launches),
            ("configs/resnet.yaml", 156, chip_smoke.resnet_train_launches)):
        cfg = yaml2namespace(config)
        plan = chip_smoke.nhwc_train_launches(cfg, 8, 256)
        assert len(plan["instance_norm_nhwc"]) == count == len(
            nhcw_plan(cfg, 8, 256)["instance_norm_act"])
    unet = chip_smoke.nhwc_train_launches(
        yaml2namespace(NEW_RECIPES[0]), 8, 256)["instance_norm_nhwc"]
    assert (8, 256, 16, True) in unet and (8, 128, 32, True) in unet
    resnet = chip_smoke.nhwc_train_launches(
        yaml2namespace("configs/resnet.yaml"), 8, 256)["instance_norm_nhwc"]
    assert (8, 64, 128, False) in resnet and (8, 32, 256, False) in resnet


@pytest.mark.parametrize("shape", [(2, 8, 16, True), (1, 4, 3, False)])
def test_instance_norm_nhwc_library_call_is_the_same_function(shape,
                                                              monkeypatch):
    """K13's case: its library yardstick computes the plain version's y."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    _, plain, library, nbytes, ops, checks = chip_smoke.make_case(
        "instance_norm_nhwc", shape, torch.float32, 0)
    y, mean, rstd = plain()
    torch.testing.assert_close(library().permute(0, 2, 3, 1), y,
                               rtol=1e-4, atol=1e-4)
    b, h, c, affine = shape
    assert nbytes == (2 * b * h * h * c + (2 * c if affine else 0)) * 4 \
        + 2 * b * c * 4
    assert [k for k, _ in checks] == ["instance_norm_nhwc"] + [
        "instance_norm_nhwc.stats"] * 2


def test_trainer_phase_on_the_cpu(tmp_path, monkeypatch):
    """Phase 14 end to end on the CPU at 32x32, batch 2, 5 images a domain,
    with K13's dispatcher counted as its launches are on the card: every
    check holds but the last run's, since on the CPU ``tpu_layout: auto``
    is NHWC."""
    from cyclegan_tpu_torch import kernels

    for name, value in (("DEVICE", "cpu"), ("SIZE", 32), ("BATCH", 2),
                        ("CLI_IMAGES", 5)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "failures", [])
    plain = cuda_norm._instance_norm_nhwc

    def counted(*args):
        kernels.launches["instance_norm_nhwc"] += 1
        return plain(*args)

    monkeypatch.setattr(cuda_norm, "_instance_norm_nhwc", counted)
    launches, metrics = chip_smoke.trainer_cli(tmp_path)
    assert [f.split(":")[0] for f in chip_smoke.failures] == ["trainer auto"]
    assert metrics["reload_differences"] == []
    assert metrics["resumed_step"] == 6 and metrics["resumed_current_epoch"] \
        == 3
    assert set(launches["trainer_cli_nhwc"]) == {"instance_norm_nhwc"}
    assert sorted(metrics["png_decode_ms_by_row_filter"]) == list(range(5))
    runs = metrics["runs"]
    assert [runs[r]["step"] for r in ("nhwc", "resume", "auto")] == [4, 6, 2]


@pytest.mark.parametrize("config,model_dir,point", [
    ("model_instances/converged256/model_config.yaml", chip_smoke.MODEL_DIR,
     chip_smoke.UNET_NHWC_F32_POINT),
    ("configs/resnet.yaml", None, chip_smoke.RESNET_F32_POINT)])
def test_nhwc_f32_points_are_kink_free(config, model_dir, point):
    """Phases 12-13's f32 comparison points in the NHWC layout with
    ``pallas_norm``: no ReLU or LeakyReLU input within KINK_MARGIN."""
    model_cfg = yaml2namespace(config)
    x = chip_smoke.f32_point_inputs(point)
    grads, kink = chip_smoke.nearest_kink(lambda: chip_smoke.step_grads(
        model_cfg, "cpu", "float32", x, model_dir, point["seed"],
        point.get("beta"), tpu_layout=False, pallas_norm=True))
    assert kink > chip_smoke.KINK_MARGIN
    flat = [chip_smoke._flat(g) for g in grads.values()]
    assert all(bool(torch.isfinite(g).all()) and g.norm() > 0 for g in flat)


@pytest.mark.parametrize("name,family", [
    ("void (anonymous namespace)::norm_act_kernel<__nv_bfloat16, 8, true, "
     "false, 1>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16*, float*, float*, int, int, int, "
     "int, int, int, float, float)", "instance_norm_act"),
    ("void (anonymous namespace)::norm_act_bwd_kernel<float, 4, false, 2>("
     "float const*, float const*, float const*, float const*, float const*,"
     " float const*, float*, float*, float*, int, int, int, int, int, int, "
     "float)", "instance_norm_act_bwd"),
    ("_ZN48_GLOBAL__N__2c46ab61_15_norm_act_bwd_cu_3b2fb43b19norm_act_bwd_"
     "kernelI13__nv_bfloat16Li8ELb1ELi1EEEvPKT_", "instance_norm_act_bwd")])
def test_trace_families_name_the_norm_kernels(name, family):
    """K2's and K6's kernels, templated on the slot width, the register
    design and the activation, fall into their own families in the device
    trace, not into "other"."""
    assert chip_smoke.trace_family(name) == family


@pytest.mark.parametrize("name,family", [
    ("void (anonymous namespace)::concat_up2_kernel<__nv_bfloat16, 8, 4>("
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, int, int, "
     "int)", "concat_up2"),
    ("_ZN46_GLOBAL__N__3cda8ef4_13_concat_up2_cu_3b2fb43b17concat_up2_kernel"
     "IfLi1ELi1EEEvPKT_S3_PS1_iii", "concat_up2"),
    ("void (anonymous namespace)::reflect_fold_kernel<__nv_bfloat16, 8>("
     "__nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int, int)",
     "reflect_fold"),
    ("_ZN48_GLOBAL__N__242500a3_15_reflect_fold_cu_3b2fb43b19reflect_fold_"
     "kernelIfLi1EEEvPKT_PS1_iiiii", "reflect_fold"),
    ("void (anonymous namespace)::dup2x2_kernel<__nv_bfloat16, 4>("
     "__nv_bfloat16 const*, __nv_bfloat16*, int, int, float)", "dup2x2"),
    ("void (anonymous namespace)::split_pool2_kernel<float, 4, 2>("
     "float const*, float*, float*, int, int, int)", "split_pool2")])
def test_trace_families_name_the_junction_and_fold_kernels(name, family):
    """K4's, K7's, K8's and K10's kernels, templated on the type and the
    unit widths of the vector and element paths, fall into their own
    families in the device trace, not into "other" or K11's "concat2"."""
    assert chip_smoke.trace_family(name) == family


def _norm_case(deterministic):
    """make_case stand-in: a K2 whose second bf16 run differs from its
    first by one bf16 step unless ``deterministic``, within tolerance of
    the plain version."""
    runs = []

    def make_case(name, shape, dtype, seed):
        x = torch.linspace(-1.0, 1.0, 64).to(dtype)

        def kernel():  # runs 1 and 2: bf16, then run 3: f32
            runs.append(1)
            bump = 0.0 if deterministic or len(runs) != 2 else 2.0 ** -8
            return (x + bump,)
        return (kernel, lambda: (x,), None, 0, 0,
                [("instance_norm_act", 1.0)])
    return make_case


@pytest.mark.parametrize("deterministic", [True, False])
def test_phase_2_requires_the_same_bits_twice(deterministic, monkeypatch):
    """Phase 2 runs every bf16 K2 and K6 case twice and fails unless the
    outputs are bit-identical; a difference within the tolerance of the
    plain version fails all the same."""
    monkeypatch.setattr(chip_smoke, "make_case", _norm_case(deterministic))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "failures", [])
    shapes = {"instance_norm_act": collections.Counter(
        {(1, 8, 8, "relu", True): 1})}
    chip_smoke.check_kernels(shapes)
    differ = [f for f in chip_smoke.failures if "two runs differ" in f]
    assert len(differ) == (0 if deterministic else 1)
    assert all("bf16" in f for f in differ)
    assert len(chip_smoke.failures) == len(differ)


def test_phase_3_reports_the_share_of_the_bound_and_l2(monkeypatch):
    """Each phase-3 row carries its share of the bound (bound over kernel
    ms) and whether the launch's bytes fit the 50 MB L2."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, *a, **k: 0.25)
    small, large = (2, 8, 4, "relu", True), (8, 256, 32, "none", False)
    paths = {"step": {"instance_norm_act": collections.Counter(
        {small: 2}), "instance_norm_act_bwd": collections.Counter(
        {small: 2})}}
    rows = chip_smoke.time_kernels(paths, torch.float32)
    assert {r["kernel"] for r in rows} == {"instance_norm_act",
                                           "instance_norm_act_bwd"}
    for r in rows:
        assert r["bound_share"] == pytest.approx(r["bound_ms"] / 0.25)
        assert r["fits_l2"] and r["per_step"] == {"step": 2}
        assert r["copy_ms"] is None  # K3, K4, K7, K8, K10, K13 have a floor
    b, h, c = large[:3]
    # K6 at the U-Net's largest launch moves x, gz and dx: 3 x 32 MiB
    assert 3 * b * h * c * h * 2 > chip_smoke.L2_BYTES


def test_phase_3_times_a_copy_floor_for_the_junction_and_the_fold(
        monkeypatch):
    """K3's, K4's, K7's, K8's, K10's and K13's phase-3 rows carry
    ``copy_ms``, the time of a ``copy_`` that moves the launch's bytes (half
    read, half written), and the kernel entries sum it over the step's
    launches; other kernels' rows (K11 here) carry none."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    copies = []

    def time_ms(fn, *a, **k):
        if "copy_" not in fn.__code__.co_names:
            return 0.25          # a kernel, plain or library call
        out = fn()
        assert out.dtype == torch.uint8
        copies.append(out.numel())
        return 0.5
    monkeypatch.setattr(chip_smoke, "time_ms", time_ms)
    paths = {"step": {"concat_up2": collections.Counter({(2, 8, 4, 6): 3}),
                      "reflect_fold": collections.Counter({(2, 8, 5, 1): 2}),
                      "dup2x2": collections.Counter({(2, 4, 4): 1}),
                      "split_pool2": collections.Counter({(2, 8, 4, 6): 3}),
                      "sum2x2": collections.Counter({(2, 8, 4): 1}),
                      "instance_norm_nhwc": collections.Counter(
                          {(2, 8, 16, True): 1}),
                      "concat2": collections.Counter({(2, 8, 4, 6): 1})}}
    rows = chip_smoke.time_kernels(paths, torch.float32)
    by_name = {r["kernel"]: r for r in rows}
    assert by_name["concat2"]["copy_ms"] is None
    floored = ("concat_up2", "reflect_fold", "dup2x2", "split_pool2",
               "sum2x2", "instance_norm_nhwc")
    for name in floored:
        assert by_name[name]["copy_ms"] == 0.5
    assert sorted(copies) == sorted(by_name[n]["bytes"] // 2
                                    for n in floored)
    mine = [r for r in rows if r["kernel"] == "reflect_fold"]
    total = chip_smoke._sums([(r, 2) for r in mine], 2)
    assert total["copy_ms"] == pytest.approx(1.0)
    assert chip_smoke._sums([(by_name["concat2"], 1)], 1)["copy_ms"] is None


@pytest.mark.parametrize("name", ["concat_up2", "reflect_fold", "dup2x2",
                                  "split_pool2"])
def test_edge_junction_and_fold_shapes_are_cases_of_the_library_function(
        name, monkeypatch):
    """Every EDGE_JUNCTION_SHAPES, EDGE_DUP_SHAPES and EDGE_FOLD_SHAPES
    case builds on the CPU in f32 (inputs one element off alignment where
    its last entry is 1), and its library yardstick computes the plain
    version's function."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    edges = {**chip_smoke.EDGE_JUNCTION_SHAPES, **chip_smoke.EDGE_DUP_SHAPES,
             **chip_smoke.EDGE_FOLD_SHAPES}
    outputs = 2 if name == "split_pool2" else 1
    offs = set()
    for shape in edges[name]:
        _, plain, library, nbytes, _, checks = chip_smoke.make_case(
            name, shape, torch.float32, 0)
        want = plain()
        got = library()
        got = list(got) if isinstance(got, tuple) else [got]
        if name in ("reflect_fold", "dup2x2"):
            got[0] = got[0].permute(0, 2, 1, 3)
        if name == "split_pool2":
            got[1] = got[1].permute(0, 2, 1, 3)
        assert len(got) == len(want) == outputs
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        assert nbytes > 0 and checks == [(name, 1.0)] * outputs
        offs.add(shape[-1])
    assert offs == {0, 1}


def test_off_view_is_one_element_off_alignment():
    t = torch.arange(24, dtype=torch.float32).view(2, 3, 4)
    v = chip_smoke.off_view(t)
    assert torch.equal(v, t) and v.is_contiguous()
    assert v.data_ptr() % 16 == 4


def _path_case(took):
    """make_case stand-in: a K4, K7, K8 or K10 whose kernel tallies the path
    ``took`` in ``kernels.paths``, equal to its plain version."""
    from cyclegan_tpu_torch import kernels

    def make_case(name, shape, dtype, seed):
        x = torch.linspace(-1.0, 1.0, 16).to(dtype)

        def kernel():
            kernels.paths[f"{name}.{took}"] += 1
            return (x,)
        return (kernel, lambda: (x,), None, 0, 0, [(name, 1.0)])
    return make_case


@pytest.mark.parametrize("took", ["vector", "element"])
def test_phase_2_holds_each_junction_and_fold_case_to_its_path(took,
                                                               monkeypatch):
    """Phase 2 fails a K4, K7, K8 or K10 case that took another path than
    its geometry gives (a recipe's launch: the vector path), and records
    the paths it saw, which main() requires to be both in both dtypes."""
    monkeypatch.setattr(chip_smoke, "make_case", _path_case(took))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "failures", [])
    monkeypatch.setattr(chip_smoke, "paths_run",
                        collections.defaultdict(set))
    shapes = {"concat_up2": collections.Counter({(8, 64, 64, 128): 6}),
              "reflect_fold": collections.Counter({(8, 64, 128, 1): 108}),
              "dup2x2": collections.Counter({(8, 128, 16): 12}),
              "split_pool2": collections.Counter({(8, 64, 64, 128): 6})}
    chip_smoke.check_kernels(shapes)
    wrong = [f for f in chip_smoke.failures if "path" in f]
    assert len(wrong) == (0 if took == "vector" else 8)
    assert len(chip_smoke.failures) == len(wrong)
    assert chip_smoke.paths_run == {
        (name, dtype): {took} for name in shapes
        for dtype in (torch.bfloat16, torch.float32)}


@pytest.mark.parametrize("name", ["instance_norm_act",
                                  "instance_norm_act_bwd"])
def test_edge_norm_shapes_are_cases_of_the_library_function(name,
                                                             monkeypatch):
    """Every EDGE_NORM_SHAPES case builds on the CPU in f32, and its
    library yardstick computes the plain version's function."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    seen = set()
    for shape in chip_smoke.EDGE_NORM_SHAPES[name]:
        b, h, c, act, affine = shape
        seen.update([act, affine])
        _, plain, library, nbytes, _, checks = chip_smoke.make_case(
            name, shape, torch.float32, 0)
        want = plain()
        got = library()
        if name == "instance_norm_act":
            torch.testing.assert_close(got.permute(0, 2, 1, 3), want[0],
                                       rtol=1e-4, atol=1e-4)
        else:
            torch.testing.assert_close(got[0].permute(0, 2, 1, 3), want[0],
                                       rtol=1e-4, atol=1e-4)
        assert nbytes > 0 and len(checks) == 3
    assert seen == {"relu", "leaky_relu", "none", True, False}


@pytest.mark.parametrize("config,plan,step_kw", [
    ("configs/unet_patchgan.yaml", chip_smoke.train_launches, {}),
    ("model_instances/converged256/model_config.yaml",
     lambda cfg, b, s: chip_smoke.train_launches(cfg, b, s, fuse_apps=True),
     {"fuse_apps": True}),
    ("model_instances/converged256/model_config.yaml",
     chip_smoke.remat_launches, {"remat": True}),
    ("configs/resnet.yaml",
     lambda cfg, b, s: chip_smoke.resnet_train_launches(cfg, b, s,
                                                        fuse_apps=True),
     {"fuse_apps": True}),
    ("model_instances/converged256/model_config.yaml",
     chip_smoke.nhwc_train_launches,
     {"paired": True, "tpu_layout": False, "pallas_norm": True}),
], ids=["unet_patchgan", "unet_fused", "unet_remat", "resnet_fused",
        "unet_paired"])
def test_option_launch_plans_match_a_recorded_step(config, plan, step_kw,
                                                   monkeypatch):
    """Phases 15-18's plans: the fifth recipe (PatchGAN discriminators),
    the fused steps (two generator applications at batch 2N), the remat
    step (each generator forward again in the backward) and the paired
    step (K13 once per twin through its vmap rule)."""
    model_cfg = yaml2namespace(config)
    seen = _record_train_step(monkeypatch, model_cfg, 2, 32, **step_kw)
    want = plan(model_cfg, 2, 32)
    assert set(seen) == set(want)
    for name, shapes in want.items():
        assert collections.Counter(seen[name]) == \
            collections.Counter(shapes), name


def test_option_launch_counts():
    """Per batch-8 256x256 step (the fifth recipe at its batch 4)."""
    unet = yaml2namespace("model_instances/converged256/model_config.yaml")
    counts = {k: len(v) for k, v in chip_smoke.train_launches(
        unet, 8, 256, fuse_apps=True).items()}
    assert counts == {"conv_same": 246, "conv_dw": 104,
                      "instance_norm_act": 116, "instance_norm_act_bwd": 116,
                      "sum2x2": 24, "dup2x2": 24, "concat_up2": 24,
                      "split_pool2": 24}
    remat = chip_smoke.remat_launches(unet, 8, 256)
    assert (len(remat["conv_same"]), len(remat["instance_norm_act"])) == (
        304 + 6 * 15, 144 + 6 * 14)
    assert (16, 256, 3, 16, 4, False, 1) in chip_smoke.train_launches(
        unet, 8, 256, fuse_apps=True)["conv_same"]
    patchgan = chip_smoke.train_launches(
        yaml2namespace("configs/unet_patchgan.yaml"), 4, 256)
    assert {k: len(v) for k, v in patchgan.items()} == {
        "conv_same": 188, "conv_dw": 94, "instance_norm_act": 102,
        "instance_norm_act_bwd": 102, "sum2x2": 18, "dup2x2": 18,
        "concat_up2": 18, "split_pool2": 18}
    assert (4, 32, 256, 1, 1, True, 0) in patchgan["conv_same"]
    resnet = chip_smoke.resnet_train_launches(
        yaml2namespace("configs/resnet.yaml"), 8, 256, fuse_apps=True)
    assert {k: len(resnet[k]) for k in ("conv_reflect", "reflect_fold")} == {
        "conv_reflect": 80, "reflect_fold": 78}


def test_unet_patchgan_f32_point_is_kink_free():
    """Phase 15's f32 comparison point: no ReLU or LeakyReLU input of the
    full-width CPU step within KINK_MARGIN of zero."""
    point = chip_smoke.UNET_PATCHGAN_F32_POINT
    model_cfg = yaml2namespace("configs/unet_patchgan.yaml")
    x = chip_smoke.f32_point_inputs(point)
    _, kink = chip_smoke.nearest_kink(lambda: chip_smoke.step_grads(
        model_cfg, "cpu", "float32", x, None, point["seed"], point["beta"]))
    assert kink > chip_smoke.KINK_MARGIN


def test_export_512_plan_is_the_serving_forward_at_512():
    """Phase 21 checks and times K1-K4 at the 512x512 forward's launches:
    the U-Net plan's 15/14/3/3 at side 512, the stem at full size."""
    cfg = yaml2namespace("model_instances/converged256/model_config.yaml")
    plan = chip_smoke.serve_launches(cfg.generator, 8, chip_smoke.EXPORT_SIZE)
    assert chip_smoke._times(plan, 3) == {
        "conv_same": 45, "instance_norm_act": 42, "sum2x2": 9,
        "concat_up2": 9}
    assert plan["conv_same"][0] == (8, 512, 3, 16, 4, False, 1)
    assert (8, 512, 16, "relu", True) in plan["instance_norm_act"]
    assert plan["concat_up2"][-1] == (8, 512, 16, 64)
    assert chip_smoke._server_timing(
        {"Server-Timing": "decode;dur=1.500, stylize;dur=2.000"}) == {
        "decode": 1.5, "stylize": 2.0}


def test_serving_phases_on_the_cpu(tmp_path, monkeypatch):
    """Phases 20-23 end to end on the CPU at 32x32 (export at 64), batch 2,
    a copy of converged256 whose train config says 32, with the serving
    kernels' dispatchers counted as their launches are on the card and
    "auto" resolved as on the card (NHCW in bf16): every check holds."""
    import shutil

    from cyclegan_tpu_torch import kernels
    from cyclegan_tpu_torch.apps import inference

    model = tmp_path / "model"
    model.mkdir()
    for name in ("checkpoint.npz", "model_config.yaml"):
        shutil.copy(chip_smoke.MODEL_DIR / name, model / name)
    (model / "train_config.yaml").write_text("image_size: 32\n")
    for name, value in (("DEVICE", "cpu"), ("SIZE", 32), ("BATCH", 2),
                        ("EXPORT_SIZE", 64), ("EXPORT_IMAGES", 3),
                        ("HTTP_REQUESTS", 2), ("HTTP_PAETH", 1),
                        ("HTTP_CONCURRENT", 2), ("HTTP_ROUNDS", 1),
                        ("STRESS_THREADS", 2), ("STRESS_CALLS", 2),
                        ("TIMED_REPS", 1), ("MODEL_DIR", model)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "failures", [])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, *a, **k: 0.25)
    monkeypatch.setattr(chip_smoke, "device_trace", lambda *a, **k: None)
    for module, name, key in (
            (cuda_conv, "_conv_same", "conv_same"),
            (cuda_norm_act, "_instance_norm_act", "instance_norm_act"),
            (cuda_resize, "sum2x2", "sum2x2"),
            (cuda_concat, "_concat_up2", "concat_up2")):
        def counted(*args, _plain=getattr(module, name), _key=key,
                    **kwargs):
            kernels.launches[_key] += 1
            return _plain(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)
    init = inference.InferenceSession.__init__

    def card_auto(self, model_dir, compute_dtype="float32",
                  tpu_layout="auto", spatial_devices=0, device="cuda"):
        if tpu_layout == "auto":
            tpu_layout = compute_dtype == "bfloat16"
        init(self, model_dir, compute_dtype, tpu_layout, spatial_devices,
             device)

    monkeypatch.setattr(inference.InferenceSession, "__init__", card_auto)
    cfg = yaml2namespace(model / "model_config.yaml")
    per_forward = {"conv_same": 15, "instance_norm_act": 14, "sum2x2": 3,
                   "concat_up2": 3}

    with layout.nhwc():  # the phases run outside any layout scope
        launches, metrics = chip_smoke.serving_layouts(cfg, None)
        assert launches["unet_serve_auto"] == chip_smoke._times(
            {k: [None] * n for k, n in per_forward.items()}, 2)
        assert metrics["nhwc"]["launches"] == {}
        records, launched, plan, forwards, _ = chip_smoke.export_512(
            cfg, tmp_path, None)
        assert forwards == 2 and launched == chip_smoke._times(plan, 2)
        launches, metrics = chip_smoke.http_server(cfg)
        assert metrics["concurrent"]["mismatches"] == 0
        assert set(metrics["filter_0"]["server_ms"]) == {
            "decode", "resize", "stylize", "encode"}
        assert metrics["jpeg_without_decoder"]["status"] == 400
        assert metrics["stress"]["mismatches"] == 0
        launches, metrics = chip_smoke.evaluation(cfg, records)
        assert metrics["feature_rel_err"] <= chip_smoke.FEATURE_REL
    assert chip_smoke.failures == []
