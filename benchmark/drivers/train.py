"""The training driver: the program's trainer (``CycleGan``) stepping back to
back on seeded uint8 records, closed loop.

Set-up builds the trainer with the configuration's recipe, loads the
benchmark's seeded weights into its four networks, seeds its jitter
generator, and drives its first three steps through the window's own call
(``train_step_fn`` on batches put on the card by ``_put``), on rows that
all differ; those steps also warm every shape. It keeps what the check
needs: each step's losses, the per-leaf norms of the first gradient as
Adam received it (its first moment after one step over 1 - beta1) and of
the parameters' change over the three steps. The same trainer then runs
the window: steps until ``seconds`` have passed, the device synchronized
and the losses fetched at its end. Once the window has closed and the
memory peak is read, the trainer is freed and the plain reference follows
the same three steps from the same weights, batches and jitter seed.

Traffic keys: ``records`` (images per domain held on the host, a multiple
of the batch), ``check_steps`` (3), ``issue_steps`` and ``traced_steps``
(of the ``--trace 1`` run).
"""

from __future__ import annotations

import gc
import tempfile
import time
from typing import Dict

import torch

from benchmark import compare, data, flops
from benchmark import trace as tracing
from benchmark.reference import step as ref_step

NETWORKS = data.NETWORKS


def program_configs(cfg: dict, folder: str):
    """The program's model and train configs for the recipe in ``cfg``."""
    from cyclegan_tpu_torch.config import Namespace

    opt = {"name": "adam", "learning_rate": cfg["optimizer"]["learning_rate"],
           "beta_1": cfg["optimizer"]["beta_1"]}
    model = Namespace({
        "name": "benchmark", "new": True, "location": folder, "seed": 0,
        "generator": dict(cfg["generator"]),
        "discriminator": dict(cfg["discriminator"]),
        "loss": cfg["loss"], "loss_weights": dict(cfg["loss_weights"])})
    train = Namespace({
        "epochs": 1, "batch_size": int(cfg["batch_size"]),
        "image_size": int(cfg["image_size"]), "g_opt": opt,
        "d_opt": dict(opt), "compute_dtype": cfg["compute_dtype"],
        "tpu_layout": cfg["tpu_layout"], "display_every": 0,
        "nan_check": False})
    return model, train


def records(cfg: dict, traffic: dict, seed: int, device) -> tuple:
    """(a, b): uint8 NHWC records per domain, on the host."""
    n = int(traffic["records"])
    images = data.smooth_images(2 * n, int(cfg["image_size"]), seed, device)
    images = images.cpu().numpy()
    return images[:n], images[n:]


def batch(recs: tuple, i: int, size: int) -> tuple:
    a, b = recs
    lo = (i * size) % len(a)
    return a[lo:lo + size], b[lo:lo + size]


def build_trainer(cfg: dict, seed: int, device, folder: str):
    """The program's trainer with the benchmark's weights and jitter seed."""
    from cyclegan_tpu_torch.trainer import CycleGan

    model_cfg, train_cfg = program_configs(cfg, folder)
    trainer = CycleGan(model_cfg, train_cfg, device=device)
    weights = data.make_weights(cfg, seed, device)
    for n in NETWORKS:
        trainer.state.models[n].load_state_dict(weights[n], strict=True)
    trainer.state.generator.manual_seed(data.stream_seed(seed, "jitter"))
    return trainer


def first_gradient_norms(trainer) -> Dict[str, float]:
    """Per leaf, the norm of the gradient Adam took in its first step:
    its first moment over (1 - beta1); inf where it holds none."""
    out = {}
    for n in NETWORKS:
        opt = trainer.state.optimizers[n]
        beta1 = opt.param_groups[0]["betas"][0]
        for k, p in trainer.state.models[n].named_parameters():
            m = opt.state.get(p, {}).get("exp_avg")
            out[f"{n}.{k}"] = (float(m.float().norm()) / (1 - beta1)
                               if m is not None else float("inf"))
    return out


def first_steps(trainer, recs: tuple, steps: int, batch_size: int) -> dict:
    """The program's readings of its first ``steps`` steps."""
    start = {n: {k: p.detach().clone() for k, p in
                 trainer.state.models[n].named_parameters()}
             for n in NETWORKS}
    losses, grads = [], {}
    for i in range(steps):
        metrics = trainer.train_step_fn(
            trainer.state, *trainer._put(*batch(recs, i, batch_size)))
        losses.append({k: float(metrics[k]) for k in ref_step.LOSS_NAMES})
        if i == 0:
            grads = first_gradient_norms(trainer)
    change = {f"{n}.{k}": float((p.detach() - start[n][k]).norm())
              for n in NETWORKS
              for k, p in trainer.state.models[n].named_parameters()}
    return {"losses": losses, "grads": grads, "change": change}


def reference_readings(cfg: dict, seed: int, recs: tuple, steps: int,
                       device, precision: str = "f32", rows=None) -> dict:
    """The plain reference (or, with ``precision="fp8"``, the control)
    over the same first steps."""
    params = data.make_weights(cfg, seed, device)
    size = int(cfg["batch_size"])
    batches = [tuple(torch.from_numpy(x).to(device)
                     for x in batch(recs, i, size)) for i in range(steps)]
    losses, grads, change = ref_step.train(
        cfg, params, batches, data.stream_seed(seed, "jitter"), precision,
        rows)
    return {"losses": losses, "grads": grads, "change": change}


def readings(cell, seed: int, device) -> dict:
    """The program's numbers on one seed, without a window."""
    cfg, traffic = cell.config, cell.traffic
    steps = int(traffic["check_steps"])
    recs = records(cfg, traffic, seed, device)
    with tempfile.TemporaryDirectory() as folder:
        trainer = build_trainer(cfg, seed, device, folder)
        program = first_steps(trainer, recs, steps, int(cfg["batch_size"]))
        del trainer
    _free(device)
    reference = reference_readings(cfg, seed, recs, steps, device)
    for key in ("grads", "change"):
        print(f"seed {seed} worst {key}: "
              f"{compare.worst_leaves(program, reference, key)}", flush=True)
    return compare.train_numbers(program, reference)


def controls(cell, seed: int, device) -> dict:
    """{name: numbers} of the control (the reference in float8 in the
    program's place), of the faults a train cell can have, planted in
    the reference put in the program's place (half of each batch left
    out, the mean over the rest; the state left unchanged), and of the
    witness: the reference in bfloat16, the configuration's own
    precision."""
    cfg, traffic = cell.config, cell.traffic
    steps = int(traffic["check_steps"])
    recs = records(cfg, traffic, seed, device)
    reference = reference_readings(cfg, seed, recs, steps, device)
    half = slice(0, int(cfg["batch_size"]) // 2)
    out = {}
    for name, kw in (("control_fp8", {"precision": "fp8"}),
                     ("fault_half_batch", {"rows": half}),
                     ("witness_bf16", {"precision": "bf16"})):
        other = reference_readings(cfg, seed, recs, steps, device, **kw)
        out[name] = compare.train_numbers(other, reference)
        print(f"seed {seed} {name} worst grads: "
              f"{compare.worst_leaves(other, reference, 'grads')}",
              flush=True)
        _free(device)
    unchanged = dict(reference, change={k: 0.0 for k in reference["change"]})
    out["fault_unchanged"] = compare.train_numbers(unchanged, reference)
    return out


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        start: float) -> dict:
    cfg, traffic = cell.config, cell.traffic
    bsz = int(cfg["batch_size"])
    check_steps = int(traffic["check_steps"])
    marks = [("start", start), ("imports", time.perf_counter())]
    with tempfile.TemporaryDirectory() as folder:
        recs = records(cfg, traffic, seed, device)
        marks.append(("records", time.perf_counter()))
        trainer = build_trainer(cfg, seed, device, folder)
        marks.append(("trainer", time.perf_counter()))
        program = first_steps(trainer, recs, check_steps, bsz)
        step, state = trainer.train_step_fn, trainer.state

        _sync(device)
        t0 = time.perf_counter()
        marks.append(("first steps", t0))
        setup_s = t0 - start
        print(f"setup_s {setup_s:.4f}: " + ", ".join(
            f"{name} {b - a:.3f} s" for (_, a), (name, b)
            in zip(marks, marks[1:])), flush=True)
        done = 0
        while True:
            metrics = step(state, *trainer._put(
                *batch(recs, check_steps + done, bsz)))
            done += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
        last = {k: float(metrics[k]) for k in ref_step.LOSS_NAMES}
        window_s = time.perf_counter() - t0
        print(f"window: {done} steps in {window_s:.4f} s, last losses "
              f"{last}", flush=True)

        records_out = {"kind": "train", "steps": done, "window_s": window_s}
        if trace:
            nxt = check_steps + done
            issue = []
            for i in range(int(traffic["issue_steps"])):
                _sync(device)
                t1 = time.perf_counter()
                step(state, *trainer._put(*batch(recs, nxt + i, bsz)))
                issue.append((time.perf_counter() - t1) * 1e3)
            _sync(device)
            nxt += len(issue)
            n_traced = int(traffic["traced_steps"])

            def traced():
                for i in range(n_traced):
                    step(state, *trainer._put(*batch(recs, nxt + i, bsz)))

            records_out.update(trace=tracing.profile(traced),
                               traced_steps=n_traced, host_issue_ms=issue)
            peak = flops.peaks(torch.cuda.get_device_name(0))
            work = flops.train_step(cfg, peak)
            records_out.update(ops_per_step=work["ops"],
                               conv_least_s_per_step=work["least_s"],
                               peak=peak, dtype=cfg["compute_dtype"])
            print(f"host issue ms: {issue}; trace: "
                  f"{ {k: v for k, v in records_out['trace'].items() if k != 'families'} }",
                  flush=True)
        memory_peak = (torch.cuda.max_memory_allocated()
                       if torch.device(device).type == "cuda" else 0)
        del step, state, trainer, metrics
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    reference = reference_readings(cfg, seed, recs, check_steps, device)
    print(f"reference: {time.perf_counter() - t_ref:.2f} s; program losses "
          f"{program['losses']}; reference losses {reference['losses']}",
          flush=True)
    numbers = compare.train_numbers(program, reference)
    print(f"readings: {numbers}", flush=True)
    return {
        "end_to_end": {"train_img_s": bsz * done / window_s,
                       "setup_s": setup_s},
        "records": records_out,
        "checks": compare.checks(numbers, cell.limits),
        "attempted": done, "failed": 0,
        "device": {"memory_peak_bytes": int(memory_peak)},
    }

