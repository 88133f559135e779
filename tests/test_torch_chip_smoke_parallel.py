"""chip_smoke.py's phases 26 (data parallelism) and 27 (spatial sharding),
on the CPU.

The strips' launch plan (``spatial_launches``) is held against the
launches a 2-rank spatial train step really makes, recorded through the
plain versions the wrappers call on the CPU; and both phases run end to
end on gloo ranks at 32x32, batch 2, the group of one over gloo where the
card uses NCCL, with the kernels' dispatchers counted in every rank as
their launches are on the card: every check holds. So do phase 26 (c),
the ResNet recipe on the data ranks, and phase 27 (c) and (d), the
spatial HTTP server at 64x64 (its sessions' "auto" resolved as on the
card, NHCW in bf16) and the paired step on the strips.
"""

import collections

import pytest
import torch

import chip_smoke
from cyclegan_tpu_torch import kernels
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.ops import (cuda_concat, cuda_conv, cuda_norm_act,
                                    cuda_reflect, cuda_resize)
from cyclegan_tpu_torch.parallel import run_ranks

UNET = "model_instances/converged256/model_config.yaml"
# each NHCW dispatcher the Functions call and the kernel it launches
DISPATCHERS = [(cuda_conv, "_conv_same", "conv_same"),
               (cuda_conv, "conv_dw", "conv_dw"),
               (cuda_norm_act, "_instance_norm_act", "instance_norm_act"),
               (cuda_norm_act, "instance_norm_act_bwd",
                "instance_norm_act_bwd"),
               (cuda_resize, "sum2x2", "sum2x2"),
               (cuda_resize, "dup2x2", "dup2x2"),
               (cuda_concat, "_concat_up2", "concat_up2"),
               (cuda_concat, "split_pool2", "split_pool2"),
               (cuda_reflect, "_conv_reflect", "conv_reflect"),
               (cuda_reflect, "conv_reflect_dw", "conv_reflect_dw"),
               (cuda_reflect, "reflect_fold", "reflect_fold")]
SETTINGS = (("DEVICE", "cpu"), ("SIZE", 32), ("BATCH", 2),
            ("TIMED_REPS", 1), ("RANK_STEPS_TIMED", 1), ("BN_DP_SIZE", 16),
            ("SPATIAL_F32_POINT", {"size": 32, "batch": 1, "seed": 2,
                                   "beta": [3.0, 4.0]}),
            ("SPATIAL_KINK_FREE_POINT", {"size": 32, "batch": 1, "seed": 2,
                                         "beta": [3.0, 4.0]}),
            ("SPATIAL_SERVE_SIZE", 64), ("SPATIAL_SERVE_BATCH", 1),
            ("WORLD1_BACKEND", "gloo"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _count_dispatchers(patch=setattr):
    """Each dispatcher counted as its kernel's launch is on the card."""
    for module, name, key in DISPATCHERS:
        def counted(*args, _plain=getattr(module, name), _key=key,
                    **kwargs):
            kernels.launches[_key] += 1
            return _plain(*args, **kwargs)

        patch(module, name, counted)


def _record_worker(rank, world, cfg_path, batch, size):
    """The kernel launches of one f32 spatial train step on this rank's
    strips, recorded through the plain versions, keyed as the plans."""
    from cyclegan_tpu_torch import steps
    from cyclegan_tpu_torch.parallel import create_spatial_mesh, shard_batch

    seen = collections.defaultdict(list)

    def record(module, name, key, shape_of):
        plain = getattr(module, name)

        def wrapper(*args, **kwargs):
            seen[key].append(shape_of(*args, **kwargs))
            return plain(*args, **kwargs)

        setattr(module, name, wrapper)

    def side(x):
        return (x.shape[1], x.shape[3])

    def conv_shape(x, w, b=None, pad=None, grow=0):
        k = int(w.shape[0])
        return (x.shape[0], side(x), x.shape[2], w.shape[3], k,
                b is not None,
                cuda_conv.tf_same_pad(k)[0] if pad is None else pad)

    record(cuda_conv, "conv_same_plain", "conv_same", conv_shape)
    record(cuda_conv, "conv_dw_plain", "conv_dw",
           lambda x, g, k, pad: (x.shape[0], side(x), x.shape[2],
                                 g.shape[2], k, pad))
    record(cuda_norm_act, "instance_norm_act_plain", "instance_norm_act",
           lambda x, *a, **k: x.shape)
    record(cuda_resize, "sum2x2_plain", "sum2x2",
           lambda x, *a: (x.shape[0], side(x), x.shape[2]))
    record(cuda_resize, "dup2x2_plain", "dup2x2",
           lambda g, *a: (g.shape[0], side(g), g.shape[2]))
    record(cuda_concat, "concat_up2_plain", "concat_up2",
           lambda skip, x: (skip.shape[0], side(skip), skip.shape[2],
                            x.shape[2]))
    record(cuda_concat, "split_pool2_plain", "split_pool2",
           lambda g, c1: (g.shape[0], side(g), c1, g.shape[2] - c1))
    cfg = yaml2namespace(cfg_path)
    mesh = create_spatial_mesh(data=1, spatial=world)
    models = steps.build_models(cfg, seed=0)
    state = steps.init_train_state(
        models, yaml2namespace(chip_smoke.TRAIN_CONFIG), device="cpu")
    gen = torch.Generator().manual_seed(0)
    a, b = (torch.rand(batch, size, size, 3, generator=gen) * 2 - 1
            for _ in range(2))
    steps.make_train_step(cfg.loss, cfg.loss_weights, mesh=mesh,
                          spatial_axis="spatial", shard_map_dp=True)(
        state, *shard_batch(mesh, (a, b), spatial_axis="spatial"))
    return dict(seen)


def test_spatial_plan_matches_a_recorded_step():
    seen = run_ranks(_record_worker, 2, (UNET, 2, 32), timeout=240)
    plan = chip_smoke.spatial_launches(chip_smoke.train_launches(
        yaml2namespace(UNET), 2, 32), 2)
    for rank in seen:
        assert set(rank) == set(plan)
        for name, shapes in plan.items():
            assert collections.Counter(rank[name]) == \
                collections.Counter(shapes), name


def test_rank_plan_counts():
    cfg = yaml2namespace(UNET)
    plan = chip_smoke.spatial_launches(chip_smoke.train_launches(cfg, 8,
                                                                 256), 2)
    assert {k: len(v) for k, v in plan.items()} == {
        "conv_same": 304, "conv_dw": 134, "sum2x2": 30, "dup2x2": 30,
        "concat_up2": 30, "split_pool2": 30}
    # K1 on the k4 strips: 128 rows of the 256x256 image and its 3 halo
    # rows; the 1x1 head takes none
    assert (8, (131, 256), 3, 16, 4, False, 1) in plan["conv_same"]
    assert (8, (128, 256), 32, 3, 1, True, 0) in plan["conv_same"]
    assert (8, (64, 128), 16) in plan["dup2x2"]
    serve = chip_smoke.spatial_launches(chip_smoke.serve_launches(
        cfg.generator, 2, 512), 2)
    assert {k: len(v) for k, v in serve.items()} == {
        "conv_same": 15, "sum2x2": 3, "concat_up2": 3}
    assert sorted(serve["conv_same"], key=chip_smoke.shape_order)[0] == \
        (2, (35, 64), 64, 128, 4, False, 1)


def _trace_stub(run, out_dir, n, file_name):
    """``device_trace`` on the CPU: the calls it traces, no trace (the
    profiler's CUDA activity hangs on the CPU-only torch)."""
    for _ in range(n):
        run()


def _cpu_card():
    """What a spawned rank of the CPU rehearsal runs first: the
    dispatchers counted, the trace stubbed."""
    torch.set_num_threads(1)
    _count_dispatchers()
    chip_smoke.device_trace = _trace_stub


def test_parallel_phases_on_the_cpu(tmp_path, monkeypatch):
    for name, value in SETTINGS:
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "failures", [])
    _count_dispatchers(monkeypatch.setattr)
    cfg = yaml2namespace(UNET)
    plans = {"dp_nccl1_train": chip_smoke.train_launches(cfg, 2, 32),
             "dp_train": chip_smoke.train_launches(cfg, 1, 32),
             "spatial_train": chip_smoke.spatial_launches(
                 chip_smoke.train_launches(cfg, 2, 32), 2)}
    serve = chip_smoke.spatial_launches(chip_smoke.serve_launches(
        cfg.generator, 1, 64), 2)
    launches, metrics = chip_smoke.world1_nccl(
        cfg, plans["dp_nccl1_train"], tmp_path)
    assert chip_smoke.failures == []
    assert metrics == {"backend": "gloo", "bit_equal": True}
    launches, metrics = chip_smoke.data_parallel(cfg, plans["dp_train"],
                                                 prepare=_cpu_card)
    assert chip_smoke.failures == []
    assert launches == {k: len(v) for k, v in plans["dp_train"].items()}
    assert set(metrics["gradient_errors"]) == {
        "f32", "bn_global", "bn_global_stats", "bn_per_shard",
        "bn_per_shard_stats"}
    step, served, forwards, metrics = chip_smoke.spatial(
        cfg, plans["spatial_train"], serve, prepare=_cpu_card)
    assert chip_smoke.failures == []
    assert step == {k: len(v) for k, v in plans["spatial_train"].items()}
    assert served == {k: len(v) for k, v in serve.items()}
    assert forwards == 1 and metrics["quality"]
    assert set(metrics["gradient_errors"]) == {"full", "kink_free"}
    assert metrics["nearest_kink"]["kink_free"] > chip_smoke.KINK_MARGIN


def _card_auto():
    """``InferenceSession``'s "auto" layout as on the card: NHCW in
    bf16."""
    from cyclegan_tpu_torch.apps import inference

    init = inference.InferenceSession.__init__

    def card_auto(self, model_dir, compute_dtype="float32",
                  tpu_layout="auto", spatial_devices=0, device="cuda"):
        if tpu_layout == "auto":
            tpu_layout = compute_dtype == "bfloat16"
        init(self, model_dir, compute_dtype, tpu_layout, spatial_devices,
             device)

    inference.InferenceSession.__init__ = card_auto


def _cpu_card_auto():
    _cpu_card()
    _card_auto()


def test_more_parallel_phases_on_the_cpu(monkeypatch):
    """Phases 26 (c) and 27 (c, d) end to end on gloo ranks of the CPU."""
    for name, value in SETTINGS + (("SPATIAL_KINK_FREE_POINT", {
            "size": 32, "batch": 1, "seed": 29, "beta": [3.0, 4.0]}),):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "failures", [])
    _count_dispatchers(monkeypatch.setattr)
    resnet = yaml2namespace(chip_smoke.RESNET_CONFIG)
    plan = chip_smoke.resnet_train_launches(resnet, 1, 32)
    launches, metrics = chip_smoke.resnet_data_parallel(
        resnet, plan, prepare=_cpu_card)
    assert chip_smoke.failures == []
    assert launches == {k: len(v) for k, v in plan.items()}
    for errors in (metrics["gradient_errors"]["point"],
                   metrics["gradient_errors"]["rank_halves"]):
        assert set(errors) == {"g_AB", "g_BA", "d_A", "d_B"}
    cfg = yaml2namespace(UNET)
    http_plan = chip_smoke.spatial_launches(chip_smoke.serve_launches(
        cfg.generator, 1, 64), 2)
    served, paired, metrics = chip_smoke.spatial_server_paired(
        cfg, http_plan, prepare=_cpu_card_auto)
    assert chip_smoke.failures == []
    assert served == {k: len(v) for k, v in http_plan.items()}
    assert paired == {}
    assert metrics["quality"]
    assert set(metrics["paired"]["gradient_errors"]) == {
        "g_AB", "g_BA", "d_A", "d_B"}
