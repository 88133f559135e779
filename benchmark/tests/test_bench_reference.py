"""The plain reference agrees with the program's plain (CPU) path at 32 x
32 for both configurations: a generator and a discriminator forward, the
train-time jitter from a given seed, and the first train step (losses and
per-leaf gradient norms) of the program's trainer against the
reference's, both in float32. The program is imported here only; the
reference never imports it."""

import tempfile

import numpy as np
import pytest
import torch

from benchmark import compare, data, spec
from benchmark.drivers import stylize, train
from benchmark.reference import nets
from benchmark.reference import step as ref_step

SIZE, BATCH, SEED = 32, 2, 2**31 + 11
CONFIGS = {"unet256": "unet256.train.b8", "resnet9_paper": "resnet9.train.b8"}


def small(cell_name, dtype="float32"):
    cell = spec.cell(cell_name)
    cell.config = dict(cell.config, image_size=SIZE, batch_size=BATCH,
                       compute_dtype=dtype)
    cell.traffic = dict(cell.traffic, records=3 * BATCH)
    return cell


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("section", ["generator", "discriminator"])
def test_forward_matches_the_program(config, section):
    from cyclegan_tpu_torch.models import create_model

    cfg = small(CONFIGS[config]).config
    weights = data.make_weights(cfg, SEED, "cpu")
    name = "g_AB" if section == "generator" else "d_A"
    model = create_model(cfg[section])
    model.load_state_dict(weights[name], strict=True)
    x = data.smooth_images(BATCH, SIZE, SEED, "cpu")
    unit = x.float() / 127.5 - 1.0
    with torch.no_grad():
        want = model(unit).permute(0, 3, 1, 2)  # NHWC in, NHWC out
        got = nets.forward(nets.Convs(), cfg[section], weights[name],
                           unit.permute(0, 3, 1, 2))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 1e-5


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
def test_jitter_matches_the_program(seed):
    from cyclegan_tpu_torch.data.augment import random_jitter_batch

    images = data.smooth_images(3, SIZE, seed, "cpu")
    want = random_jitter_batch(torch.Generator().manual_seed(seed), images,
                               SIZE)
    got = ref_step.jitter(torch.Generator().manual_seed(seed), images, SIZE)
    assert torch.equal(got.permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("config", CONFIGS)
def test_first_train_step_matches_the_program(config):
    cell = small(CONFIGS[config])
    cfg = cell.config
    recs = train.records(cfg, cell.traffic, SEED, "cpu")
    with tempfile.TemporaryDirectory() as folder:
        trainer = train.build_trainer(cfg, SEED, "cpu", folder)
        program = train.first_steps(trainer, recs, 1, BATCH)
    reference = train.reference_readings(cfg, SEED, recs, 1, "cpu")
    numbers = compare.train_numbers(program, reference)
    # identical float32 arithmetic in another order: the losses agree to
    # rounding, and so does the median leaf's gradient norm; the worst
    # leaf, a norm scale of the first levels whose gradient is a sum that
    # cancels, carries the rounding through the generators and the ReLU
    # kinks: up to 6e-3 at this size
    assert numbers["loss1_gap"] < 1e-5
    assert numbers["grad_median_gap"] < 1e-3
    assert numbers["grad_gap"] < 2e-2


def test_stylize_matches_the_program(tmp_path):
    cell = spec.cell("resnet9.stylize512.b8")
    cfg = dict(cell.config, compute_dtype="float32")
    stylize.write_model_folder(cfg, SEED, "cpu", tmp_path)
    session = stylize.open_session(cfg, tmp_path, "cpu")
    images = data.smooth_images(BATCH, SIZE, SEED, "cpu").numpy()
    got = session.stylize(images, "a2b")
    want = stylize.reference_answers(cfg, SEED, [images], "cpu")[0]
    gaps = compare.image_gaps([got], [want])
    assert gaps["worst_step"] <= 1 and gaps["mean_step"] < 0.01
