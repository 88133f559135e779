"""The U-GAT-IT training driver: the program's trainer (``CycleGan``) with a
U-GAT-IT configuration stepping back to back on seeded uint8 records,
closed loop, as ``drivers/train.py`` drives the CycleGAN recipes.

A new network family comes with its own driver and reference
(``reference/ugatit.py``): ``data.py`` and ``reference/nets.py`` make and
walk the CycleGAN networks only. So this driver takes the weights from
``reference/ugatit.make_weights`` (PyTorch's default init, as the authors'
code leaves a fresh model, ``u`` buffers included), gives the program's
Adam the configuration's epsilon and weight decay, checks the
first three steps against ``reference/ugatit.train`` and counts the work
of the step from that reference walked on the ``meta`` device:

- ``ops_per_step``: 2 x multiply-adds of every convolution and Linear
  pass (forward; input gradient, left out for a network's first layer
  where its input needs none; weight gradient, left out where the
  application's parameters are frozen: the discriminators' generator
  view);
- ``conv_least_s_per_step``: the convolutions' least time, each pass
  max(operations / peak, bytes / bandwidth), every input read once and
  every output written once at 2 bytes;
- ``linear_least_s_per_step``: the same for the Linear passes and the
  power iterations' three f32 matrix-vector products a weight
  (W^T u, W v, and sigma's W v);
- ``adalin_least_s_per_step``: the AdaLIN and ILN passes' bytes (forward
  x in and y out, backward x and dy in and dx out, 2 bytes each) over the
  bandwidth.

Set-up, window, trace and check are ``drivers/train.py``'s: the first
``check_steps`` through the window's own call, the window, with ``--trace
1`` the issue steps and a profiled stretch, then the trainer freed and
the reference run from the same weights, batches and jitter seed.
"""

from __future__ import annotations

import gc
import math
import re
import statistics
import tempfile
import time
from typing import Dict

import torch

from benchmark import compare, data, flops
from benchmark import trace as tracing
from benchmark.drivers import train as base
from benchmark.reference import ugatit as ref

NETWORKS = ref.NETWORKS
ELEMENT = 2  # bytes of a bf16 activation or weight
F32 = 4


def program_configs(cfg: dict, folder: str):
    """The program's model and train configs for the recipe in ``cfg``."""
    from cyclegan_tpu_torch.config import Namespace

    opt = dict(cfg["optimizer"])
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


def build_trainer(cfg: dict, seed: int, device, folder: str):
    """The program's trainer with the reference's weights and the jitter
    seed."""
    from cyclegan_tpu_torch.trainer import CycleGan

    model_cfg, train_cfg = program_configs(cfg, folder)
    trainer = CycleGan(model_cfg, train_cfg, device=device)
    weights = ref.make_weights(cfg, data.stream_seed(seed, "weights"),
                               device)
    for n in NETWORKS:
        trainer.state.models[n].load_state_dict(weights[n], strict=True)
    del weights
    trainer.state.generator.manual_seed(data.stream_seed(seed,
                                                              "jitter"))
    return trainer


def reference_readings(cfg: dict, seed: int, recs: tuple, steps: int,
                       device, precision: str = "f32", rows=None,
                       ada_rho_one: bool = False) -> dict:
    """The plain reference (or a control or fault) over the first steps."""
    params = ref.make_weights(cfg, data.stream_seed(seed, "weights"),
                              device)
    size = int(cfg["batch_size"])
    batches = [tuple(torch.from_numpy(x).to(device)
                     for x in base.batch(recs, i, size))
               for i in range(steps)]
    losses, grads, change = ref.train(
        cfg, params, batches, data.stream_seed(seed, "jitter"),
        precision, rows, ada_rho_one)
    return {"losses": losses, "grads": grads, "change": change}


# the leaves that AdaLIN's layer branch alone moves: every AdaLIN rho
# (d/drho = sum gamma (xhat_in - xhat_ln) g); ILN's rho is not AdaLIN's
ADA_RHO = re.compile(r"^g_(AB|BA)\.ada\.\d+\.norm[12]\.rho$")


def numbers(program: dict, reference: dict) -> Dict[str, float]:
    """``compare.train_numbers`` and ``rho_grad_median_gap``: the median
    AdaLIN rho leaf's gap of first-gradient norms (``compare.leaf_gaps``
    over those leaves alone). The other numbers are medians over all 148
    leaves, most of which AdaLIN does not reach (the discriminators, the
    encoders, the CAM's BCE at weight 1000, which dominates the
    generators' losses), so they do not see a fault in AdaLIN alone."""
    out = compare.train_numbers(program, reference)
    keys = [k for k in reference["grads"] if ADA_RHO.match(k)]
    out["rho_grad_median_gap"] = (statistics.median(compare.leaf_gaps(
        program["grads"], reference["grads"], keys)) if keys else math.inf)
    return out


def readings(cell, seed: int, device) -> dict:
    """The program's numbers on one seed, without a window."""
    cfg, traffic = cell.config, cell.traffic
    steps = int(traffic["check_steps"])
    recs = base.records(cfg, traffic, seed, device)
    with tempfile.TemporaryDirectory() as folder:
        trainer = build_trainer(cfg, seed, device, folder)
        program = base.first_steps(trainer, recs, steps,
                                   int(cfg["batch_size"]))
        del trainer
    base._free(device)
    reference = reference_readings(cfg, seed, recs, steps, device)
    for key in ("grads", "change"):
        print(f"seed {seed} worst {key}: "
              f"{compare.worst_leaves(program, reference, key)}", flush=True)
    return numbers(program, reference)


def controls(cell, seed: int, device) -> dict:
    """{name: numbers} of the control (the reference in float8 in the
    program's place), the faults (half of each batch left out; the state
    left unchanged; AdaLIN without its layer branch, every AdaLIN rho fixed
    at 1) and the witness (the reference in bfloat16)."""
    cfg, traffic = cell.config, cell.traffic
    steps = int(traffic["check_steps"])
    recs = base.records(cfg, traffic, seed, device)
    reference = reference_readings(cfg, seed, recs, steps, device)
    half = slice(0, int(cfg["batch_size"]) // 2)
    out = {}
    for name, kw in (("control_fp8", {"precision": "fp8"}),
                     ("fault_half_batch", {"rows": half}),
                     ("fault_rho_one", {"ada_rho_one": True}),
                     ("witness_bf16", {"precision": "bf16"})):
        other = reference_readings(cfg, seed, recs, steps, device, **kw)
        out[name] = numbers(other, reference)
        print(f"seed {seed} {name} worst grads: "
              f"{compare.worst_leaves(other, reference, 'grads')}",
              flush=True)
        base._free(device)
    unchanged = dict(reference, change={k: 0.0 for k in reference["change"]})
    out["fault_unchanged"] = numbers(unchanged, reference)
    return out


# ----------------------------------------------------------------------
# the work of a step
# ----------------------------------------------------------------------

# The train step's applications, as the program runs them: (network
# section, input needs a gradient, parameters need a gradient). Six
# generator applications; each discriminator on its reals, then on its
# fakes through the generator's view (parameters frozen, the fakes carry
# the gradient) and the discriminator's (fakes detached).
APPLICATIONS = (
    ("generator", False, True), ("generator", True, True),
    ("generator", False, True), ("generator", True, True),
    ("generator", False, True), ("generator", False, True),
    ("discriminator", False, True), ("discriminator", False, True),
    ("discriminator", True, False), ("discriminator", False, True),
    ("discriminator", True, False), ("discriminator", False, True),
)


def walk(cfg: dict, section: str, batch: int, size: int) -> dict:
    """The reference's records of one forward of ``section`` on ``meta``."""
    record: dict = {}
    table = (ref.generator_shapes(cfg["generator"]) if section == "generator"
             else ref.discriminator_shapes(cfg["discriminator"]))
    params = {k: torch.empty(s, device="meta") for k, s in table.items()}
    x = torch.empty((batch, 3, size, size), device="meta")
    o = ref.Ops(record=record)
    if section == "generator":
        ref.generator(o, cfg["generator"], params, x)
    else:
        ref.discriminator(o, cfg["discriminator"], params, x)
    return record


def _gemm(m: int, k: int, n: int) -> Dict[str, float]:
    return {"ops": 2.0 * m * k * n,
            "bytes": float((m * k + k * n + m * n) * ELEMENT)}


def layer_passes(records: dict, input_grad: bool, param_grad: bool
                 ) -> Dict[str, list]:
    """Every pass of one application: {"conv": [...], "linear": [...],
    "ada": [...]} of {"ops", "bytes"}; the first layer of the network
    (its first convolution) takes an input gradient only where its input
    needs one."""
    out = {"conv": [], "linear": [], "ada": []}
    for i, (xp, w, stride, y) in enumerate(records.get("conv", [])):
        k, cin, cout = w[0], w[2], w[3]
        macs = y[0] * y[2] * y[3] * k * k * cin * cout
        work = {"ops": 2.0 * macs, "bytes": float(
            (math.prod(xp) + math.prod(w) + math.prod(y)) * ELEMENT)}
        passes = 1 + int(param_grad) + int(i > 0 or input_grad)
        out["conv"] += [work] * passes
    for rows, k, n in records.get("linear", []):
        out["linear"] += [_gemm(rows, k, n)] * (2 + int(param_grad))
    for (n,) in records.get("power", []):
        out["linear"] += [{"ops": 2.0 * n, "bytes": float(n * F32)}] * 3
    for shape, _ in records.get("ada", []):
        nbytes = math.prod(shape) * ELEMENT
        out["ada"] += [{"ops": 0.0, "bytes": 2.0 * nbytes},
                       {"ops": 0.0, "bytes": 3.0 * nbytes}]
    return out


def step_work(cfg: dict, peak) -> Dict[str, float]:
    """``ops_per_step`` and the least seconds of the convolutions, the
    Linear passes and power iterations, and the AdaLIN/ILN passes."""
    batch, size = int(cfg["batch_size"]), int(cfg["image_size"])
    walks = {s: walk(cfg, s, batch, size)
             for s in ("generator", "discriminator")}
    sums = {"conv": [], "linear": [], "ada": []}
    for section, input_grad, param_grad in APPLICATIONS:
        for kind, passes in layer_passes(walks[section], input_grad,
                                         param_grad).items():
            sums[kind] += passes
    dtype = cfg["compute_dtype"]

    def least(passes):
        if peak is None:
            return None
        return sum(flops.least_seconds(p["ops"], p["bytes"], peak, dtype)
                   for p in passes)

    return {"ops": sum(p["ops"] for p in sums["conv"] + sums["linear"]),
            "conv_least_s": least(sums["conv"]),
            "linear_least_s": least(sums["linear"]),
            "adalin_least_s": least(sums["ada"])}


# ----------------------------------------------------------------------
# one run
# ----------------------------------------------------------------------

def run(cell, seed: int, seconds: float, trace: bool, device: str,
        start: float) -> dict:
    cfg, traffic = cell.config, cell.traffic
    bsz = int(cfg["batch_size"])
    check_steps = int(traffic["check_steps"])
    marks = [("start", start), ("imports", time.perf_counter())]
    with tempfile.TemporaryDirectory() as folder:
        recs = base.records(cfg, traffic, seed, device)
        marks.append(("records", time.perf_counter()))
        trainer = build_trainer(cfg, seed, device, folder)
        marks.append(("trainer", time.perf_counter()))
        program = base.first_steps(trainer, recs, check_steps, bsz)
        step, state = trainer.train_step_fn, trainer.state

        base._sync(device)
        t0 = time.perf_counter()
        marks.append(("first steps", t0))
        setup_s = t0 - start
        print(f"setup_s {setup_s:.4f}: " + ", ".join(
            f"{name} {b - a:.3f} s" for (_, a), (name, b)
            in zip(marks, marks[1:])), flush=True)
        done = 0
        while True:
            metrics = step(state, *trainer._put(
                *base.batch(recs, check_steps + done, bsz)))
            done += 1
            if time.perf_counter() - t0 >= seconds:
                break
        base._sync(device)
        last = {k: float(metrics[k]) for k in ref.LOSS_NAMES}
        window_s = time.perf_counter() - t0
        print(f"window: {done} steps in {window_s:.4f} s, last losses "
              f"{last}", flush=True)

        records_out = {"kind": "train", "steps": done, "window_s": window_s}
        if trace:
            nxt = check_steps + done
            issue = []
            for i in range(int(traffic["issue_steps"])):
                base._sync(device)
                t1 = time.perf_counter()
                step(state, *trainer._put(*base.batch(recs, nxt + i, bsz)))
                issue.append((time.perf_counter() - t1) * 1e3)
            base._sync(device)
            nxt += len(issue)
            n_traced = int(traffic["traced_steps"])

            def traced():
                for i in range(n_traced):
                    step(state, *trainer._put(*base.batch(recs, nxt + i,
                                                          bsz)))

            records_out.update(trace=tracing.profile(traced),
                               traced_steps=n_traced, host_issue_ms=issue)
            peak = flops.peaks(torch.cuda.get_device_name(0))
            work = step_work(cfg, peak)
            records_out.update(
                ops_per_step=work["ops"],
                conv_least_s_per_step=work["conv_least_s"],
                linear_least_s_per_step=work["linear_least_s"],
                adalin_least_s_per_step=work["adalin_least_s"],
                peak=peak, dtype=cfg["compute_dtype"])
            print(f"host issue ms: {issue}; trace: "
                  f"{ {k: v for k, v in records_out['trace'].items() if k != 'families'} }",
                  flush=True)
        on_card = torch.device(device).type == "cuda"
        allocated = torch.cuda.max_memory_allocated() if on_card else 0
        memory_peak = torch.cuda.max_memory_reserved() if on_card else 0
        print(f"memory: peak allocated {allocated}, peak reserved "
              f"{memory_peak} (with the step's graph pool)", flush=True)
        del step, state, trainer, metrics
        gc.collect()
        base._free(device)

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_ref = time.perf_counter()
    reference = reference_readings(cfg, seed, recs, check_steps, device)
    print(f"reference: {time.perf_counter() - t_ref:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() if on_card else 0}; program "
          f"losses {program['losses']}; reference losses "
          f"{reference['losses']}", flush=True)
    found = numbers(program, reference)
    print(f"readings: {found}", flush=True)
    return {
        "end_to_end": {"train_img_s": bsz * done / window_s,
                       "setup_s": setup_s},
        "records": records_out,
        "checks": compare.checks(found, cell.limits),
        "attempted": done, "failed": 0,
        "device": {"memory_peak_bytes": int(memory_peak)},
    }
