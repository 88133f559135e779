"""The check that decides ``correct`` fails what it must. Each test
drives a whole run of a cell here on the CPU at a small size, past the
harness's look for a card, once as it is and once with the timed path
broken underneath: a train step that leaves the state unchanged, one that
leaves half of the batch out (the mean over the rest), and an answer
altered where it is produced. The run as it is comes out correct, the
broken one not. The control, the reference in float8 in the program's
place, fails the limits too. The program runs float32 here: on the CPU
its bfloat16 is not the card's."""

import time

import numpy as np
import pytest

from benchmark import run, spec
from benchmark.drivers import stylize, train

SEED = 2**31 + 29


def small(name):
    cell = spec.cell(name)
    if cell.traffic["driver"] == "train":
        cell.config = dict(cell.config, image_size=32, batch_size=4,
                           compute_dtype="float32")
        cell.traffic = dict(cell.traffic, records=12)
    else:
        cell.config = dict(cell.config, compute_dtype="float32")
        cell.traffic = dict(cell.traffic, image_size=32, batch=2, pool=4,
                            sampled=2)
    return cell


def execute(cell):
    return run.execute(cell, SEED, seconds=1.0, trace=False, device="cpu",
                       start=time.perf_counter())


def break_step(monkeypatch, fault):
    import cyclegan_tpu_torch.trainer as trainer_mod

    make = trainer_mod.make_train_step

    def broken_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def unchanged(state, a, b):
            saved = {n: {k: p.detach().clone() for k, p in
                         m.named_parameters()}
                     for n, m in state.models.items()}
            metrics = step(state, a, b)
            for n, m in state.models.items():
                for k, p in m.named_parameters():
                    p.data.copy_(saved[n][k])
            return metrics

        def half(state, a, b):
            n = a.shape[0] // 2
            return step(state, a[:n], b[:n])

        return {"unchanged": unchanged, "half_batch": half}[fault]

    monkeypatch.setattr(trainer_mod, "make_train_step", broken_make)


TRAIN_CELLS = ["unet256.train.b8", "resnet9.train.b8"]
SERVED_CELLS = ["resnet9.stylize512.b8"]


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_train_sound_run_is_correct(name):
    out = execute(small(name))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_train_fault_is_not_correct(monkeypatch, name, fault):
    break_step(monkeypatch, fault)
    out = execute(small(name))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_train_control_fails_the_limits(name):
    cell = small(name)
    numbers = train.controls(cell, SEED, "cpu")
    for control in ("control_fp8", "fault_half_batch", "fault_unchanged"):
        assert any(numbers[control][k] > limit
                   for k, limit in cell.limits.items()), control


def alter_answers(monkeypatch):
    from cyclegan_tpu_torch.apps import inference

    stylize_fn = inference.InferenceSession.stylize

    def altered(self, images, direction="a2b"):
        out = stylize_fn(self, images, direction)
        out = np.array(out)
        out[0, :4, :4] = 255 - out[0, :4, :4]
        return out

    monkeypatch.setattr(inference.InferenceSession, "stylize", altered)


@pytest.mark.parametrize("name", SERVED_CELLS)
def test_served_sound_run_is_correct(name):
    out = execute(small(name))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0


@pytest.mark.parametrize("name", SERVED_CELLS)
def test_served_altered_answer_is_not_correct(monkeypatch, name):
    alter_answers(monkeypatch)
    out = execute(small(name))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", SERVED_CELLS)
def test_served_control_fails_the_limits(name):
    cell = small(name)
    numbers = stylize.controls(cell, SEED, "cpu")
    for control in ("control_fp8", "fault_altered"):
        assert any(numbers[control][k] > limit
                   for k, limit in cell.limits.items()), control
