"""The U-GAT-IT cell's own pieces: the reference's weights against the
program's ``state_dict`` (strict), the step's work counted from the
reference walked on ``meta``, the two new readers on synthetic records,
and the two new kernel families against the kernel names the existing
train cells run, so that no kernel of theirs changes family."""

import json
import math
from pathlib import Path

import pytest
import torch

from benchmark import spec
from benchmark.drivers import ugatit_train as drv
from benchmark.reference import ugatit as ref

NEW_FAMILIES = ("ada_norm", "library_gemm")
SMALL = {"generator": {"type": "ugatit_generator", "ngf": 8, "n_res": 2,
                       "img_size": 128},
         "discriminator": {"type": "ugatit_discriminator", "ndf": 8,
                           "n_layers_global": 7, "n_layers_local": 5},
         "compute_dtype": "bfloat16", "batch_size": 2, "image_size": 128}
PEAK = {"flops": {"bfloat16": 1000.0}, "bytes_per_s": 100.0}


def test_weights_load_into_the_program_strictly():
    from cyclegan_tpu_torch.models import create_model

    weights = ref.make_weights(SMALL, 7, "cpu")
    for name in ref.NETWORKS:
        section = "generator" if name.startswith("g") else "discriminator"
        model = create_model(SMALL[section])
        model.load_state_dict(weights[name], strict=True)
        state = model.state_dict()
        assert {k: tuple(v.shape) for k, v in state.items()} == {
            k: tuple(v.shape) for k, v in weights[name].items()}


def test_weights_are_the_default_init():
    w = ref.make_weights(SMALL, 3, "cpu")["g_AB"]
    bound = 1 / math.sqrt(7 * 7 * 3)
    assert float(w["stem.w"].abs().max()) <= bound
    assert float(w["stem.w"].abs().max()) > 0.9 * bound
    assert torch.all(w["ada.0.norm1.rho"] == 0.9)
    assert torch.all(w["up.1.norm.rho"] == 0)
    u = ref.make_weights(SMALL, 3, "cpu")["d_A"]["global.blocks.2.u"]
    assert float(u.norm()) == pytest.approx(1.0)


def test_full_step_work():
    """The published configuration: about 17 TFLOP a step, the 268M-weight
    FC's passes in the Linear count, ten AdaLIN/ILN norms an
    application."""
    cfg = spec.load_json(spec.ROOT / "benchmark/configs/ugatit_full.json")
    work = drv.step_work(cfg, None)
    assert 16e12 < work["ops"] < 18e12
    g = drv.walk(cfg, "generator", 8, 256)
    assert len(g["ada"]) == 10
    assert (8, 1048576, 256) in g["linear"]
    d = drv.walk(cfg, "discriminator", 8, 256)
    assert len(d["power"]) == 16  # 9 global, 7 local


def test_passes_of_one_application():
    records = {"conv": [((1, 3, 6, 6), (3, 3, 3, 4), 1, (1, 4, 4, 4)),
                        ((1, 4, 6, 6), (3, 3, 4, 4), 1, (1, 4, 4, 4))],
               "linear": [(2, 16, 8)], "power": [(32,)],
               "ada": [((1, 4, 4, 4), True)]}
    frozen = drv.layer_passes(records, input_grad=True, param_grad=False)
    live = drv.layer_passes(records, input_grad=False, param_grad=True)
    # the first conv: forward, and dX only where the input needs one
    assert len(frozen["conv"]) == 4 and len(live["conv"]) == 5
    assert frozen["conv"][0]["ops"] == 2.0 * 16 * 9 * 3 * 4
    assert len(frozen["linear"]) == 2 + 3 and len(live["linear"]) == 3 + 3
    assert live["linear"][0] == {"ops": 2.0 * 2 * 16 * 8,
                                 "bytes": 2.0 * (32 + 128 + 16)}
    assert live["linear"][-1] == {"ops": 64.0, "bytes": 128.0}
    assert [p["bytes"] for p in live["ada"]] == [256.0, 384.0]


def _records(families, adalin=0.001, linear=0.004):
    return {"kind": "train", "traced_steps": 2,
            "adalin_least_s_per_step": adalin,
            "linear_least_s_per_step": linear,
            "trace": {"families": families}}


def test_new_readers():
    rec = _records({"ada_norm": 0.004, "library_gemm": 0.016})
    assert spec.metric_reader("adalin_roofline.train")(rec) == \
        pytest.approx(50.0)
    assert spec.metric_reader("linear_roofline.train")(rec) == \
        pytest.approx(50.0)


def test_new_readers_read_nothing_without_their_kernels():
    for rec in (_records({}), _records({"ada_norm": 0.0}),
                {"kind": "train", "traced_steps": 2,
                 "trace": {"families": {"ada_norm": 1.0,
                                        "library_gemm": 1.0}}},
                {"kind": "stylize"}):
        assert spec.metric_reader("adalin_roofline.train")(rec) is None
        assert spec.metric_reader("linear_roofline.train")(rec) is None


def test_new_families_take_their_kernels():
    table = spec.families()
    for name in ("void an::ada_norm_stats_kernel<__nv_bfloat16, 8>",
                 "an::ada_norm_bwd_finalize_kernel(float const*)"):
        assert spec.family_of(name, table) == "ada_norm"
    for name in ("nvjet_tst_128x224_64x4_2x1_v_bz_coopA_NTT",
                 "void gemv2T_kernel_val<int, int, float>",
                 "void cublasLt::splitKreduce_kernel<32, 16>",
                 "void cutlass::Kernel2<cutlass_75_tensorop_bf16_s1688gemm"
                 "_bf16_256x128_nn_align1>",
                 "void dot_kernel<float, 128, 0>"):
        assert spec.family_of(name, table) == "library_gemm"


@pytest.mark.parametrize("cell", ["unet256.train.b8", "resnet9.train.b8"])
def test_existing_kernels_keep_their_family(cell):
    """The kernels of one traced step of each existing train cell on the
    H100, and the names the ledger's breakdowns show, are classed as they
    were before the new families came."""
    names = json.loads((Path(__file__).parent
                        / "existing_kernel_names.json").read_text())
    table = spec.families()
    old = {k: v for k, v in table.items() if k not in NEW_FAMILIES}
    for name in names["cells"][cell] + names["ledger_other"]:
        assert spec.family_of(name, table) == spec.family_of(name, old), \
            name
        for fam in NEW_FAMILIES:
            assert not any(f in name for f in table[fam]["fragments"]), name


def test_rho_gap_reads_the_adalin_rho_leaves_alone():
    ref_grads = {"g_AB.ada.0.norm1.rho": 2.0, "g_AB.ada.0.norm2.rho": 2.0,
                 "g_BA.ada.1.norm1.rho": 2.0, "g_AB.up.0.norm.rho": 4.0,
                 "d_A.global.blocks.0.w": 8.0}
    reference = {"losses": [{"gAB_loss": 1.0}], "grads": ref_grads,
                 "change": dict(ref_grads)}
    program = {"losses": [{"gAB_loss": 1.0}],
               "grads": dict(ref_grads, **{"g_AB.ada.0.norm1.rho": 1.0,
                                           "g_AB.ada.0.norm2.rho": 1.0,
                                           "g_AB.up.0.norm.rho": 0.0}),
               "change": dict(ref_grads)}
    found = drv.numbers(program, reference)
    # the two AdaLIN leaves that moved by half of 2, the third not at all
    assert found["rho_grad_median_gap"] == pytest.approx(0.5)
    assert found["change_median_gap"] == 0.0
