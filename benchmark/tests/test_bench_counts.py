"""The convolution operation and byte counts against hand-counted small
convolutions, and the readers' arithmetic: a share of a roofline or a
peak is least time over measured time, with nothing returned where
nothing was measured."""


import pytest

from benchmark import flops, spec

PEAK = {"flops": {"bfloat16": 1000.0}, "bytes_per_s": 100.0}


def test_stride1_same_conv_by_hand():
    # 2 x 3 x 4 x 4 input, 3x3 kernel to 5 channels, SAME: out 2 x 5 x 4 x 4
    cfg = {"type": "simple_discriminator", "filters": [5], "kernels": [3],
           "normalization": "instancenorm"}
    rec = flops.conv_records(cfg, batch=2, size=4)
    # PatchGAN: its conv is stride 2 (out 2x2), then the 1x1 head 5 -> 1
    kind, x, k, cout, y = rec[0]
    assert (kind, x, k, cout, y) == ("conv", (2, 3, 4, 4), 3, 5, (2, 5, 2, 2))
    work = flops.conv_work(rec[0], 2)
    assert work["ops"] == 2 * (2 * 2 * 2) * 9 * 3 * 5
    assert work["bytes"] == 2 * (2 * 3 * 16 + 9 * 3 * 5 + 2 * 5 * 4)
    head = flops.conv_work(rec[1], 2)
    assert head["ops"] == 2 * (2 * 2 * 2) * 5 * 1


def test_transposed_conv_counts_its_adjoint():
    rec = ("convt", (1, 8, 4, 4), 3, 2, (1, 2, 8, 8))
    # each of the 16 input pixels meets the 3x3x8x2 kernel once
    assert flops.conv_work(rec, 2)["ops"] == 2 * 16 * 9 * 8 * 2


def test_resnet_generator_forward_at_paper_width():
    cfg = {"type": "resnet_generator", "filters": 64}
    ops = sum(flops.conv_work(r, 2)["ops"]
              for r in flops.conv_records(cfg, 1, 256))
    # the 18 residual convs at 64x64, 256 -> 256, 3x3 dominate
    residual = 18 * 2 * 64 * 64 * 9 * 256 * 256
    assert residual < ops < 1.25 * residual


def test_train_step_counts_three_passes_less_first_dx():
    cfg = {"generator": {"type": "resnet_generator", "filters": 8},
           "discriminator": {"type": "simple_discriminator",
                             "filters": [8], "kernels": [4],
                             "normalization": "instancenorm"},
           "compute_dtype": "bfloat16", "batch_size": 2, "image_size": 16}
    fwd_g = flops.generator_forward(cfg, 2, 16, PEAK)["ops"]
    d = sum(flops.conv_work(r, 2)["ops"] for r in flops.conv_records(
        cfg["discriminator"], 2, 16))
    first_g = flops.conv_work(flops.conv_records(cfg["generator"], 2, 16)[0],
                              2)["ops"]
    first_d = flops.conv_work(flops.conv_records(cfg["discriminator"], 2,
                                                 16)[0], 2)["ops"]
    want = 18 * fwd_g - 4 * first_g + 12 * d - 2 * first_d
    assert flops.train_step(cfg, PEAK)["ops"] == pytest.approx(want)


def test_least_time_is_the_larger_bound():
    assert flops.least_seconds(500.0, 10.0, PEAK, "bfloat16") == 0.5
    assert flops.least_seconds(10.0, 500.0, PEAK, "bfloat16") == 5.0


def test_peaks_of_the_card():
    h100 = flops.peaks("NVIDIA H100 80GB HBM3")
    assert h100["flops"]["bfloat16"] == 989e12
    assert h100["bytes_per_s"] == 3.35e12
    assert flops.peaks("some other card") is None


def _train_records(conv_s, least):
    return {"kind": "train", "steps": 10, "window_s": 2.0, "traced_steps": 2,
            "ops_per_step": 1e12, "conv_least_s_per_step": least,
            "peak": {"flops": {"bfloat16": 1e15}}, "dtype": "bfloat16",
            "host_issue_ms": [3.0, 1.0, 2.0],
            "trace": {"conv_s": conv_s, "busy_s": 0.5, "window_s": 2.0}}


def test_readers():
    rec = _train_records(conv_s=0.04, least=0.01)
    assert spec.metric_reader("conv_roofline.train")(rec) == \
        pytest.approx(50.0)
    assert spec.metric_reader("mfu.train")(rec) == pytest.approx(0.5)
    assert spec.metric_reader("host_issue_ms.train")(rec) == 2.0
    assert spec.metric_reader("device_idle.train")(rec) == \
        pytest.approx(75.0)


def test_roofline_is_full_only_at_the_least_time():
    rec = _train_records(conv_s=0.02, least=0.01)
    assert spec.metric_reader("conv_roofline.train")(rec) == \
        pytest.approx(100.0)


def test_readers_return_nothing_without_a_reading():
    rec = _train_records(conv_s=0.0, least=0.01)
    assert spec.metric_reader("conv_roofline.train")(rec) is None
    for name in ("mfu.stylize", "conv_roofline.stylize",
                 "device_idle.stylize"):
        assert spec.metric_reader(name)(rec) is None


def test_family_table():
    table = spec.families()
    assert spec.family_of("conv_same_tc_kernel<bf16>", table) == "conv_same"
    # the longest fragment wins: K9-dW's copies are not K5's
    assert spec.family_of("reflect_dw_shift_copies_kernel",
                          table) == "conv_reflect_dw"
    assert spec.family_of("norm_act_bwd_kernel", table) == \
        "instance_norm_act_bwd"
    assert spec.family_of("elementwise_kernel", table) == "other"
    assert all(table[f]["conv"] for f in ("conv_same", "conv_dw",
                                          "conv_reflect", "conv_reflect_dw",
                                          "library_conv"))
