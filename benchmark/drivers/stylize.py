"""The batch stylization driver: one caller, closed loop, of the program's
``InferenceSession.stylize`` on batches of seeded uint8 images.

Set-up writes a checkpoint of the benchmark's seeded weights into a
temporary model folder (the program's own format, through its
``save_model_folder``), opens a session on it in the configuration's
serving dtype, and stylizes the first batch twice to warm every shape.
The window then stylizes batch after batch, cycling over a pool of
images held on the host, until ``seconds`` have passed; every call
returns its uint8 images to the host, so the window ends with the device
idle. A sample of the calls, drawn from the seed over all of them
(reservoir sampling), keeps its answer; once the window has closed and
the session is freed, the plain reference stylizes those inputs in
float32 and the answers are compared whole.

Traffic keys: ``image_size``, ``batch``, ``pool`` (images on the host, a
multiple of the batch), ``direction``, ``sampled`` (answers compared),
``traced_calls``.
"""

from __future__ import annotations

import gc
import random
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import compare, data, flops
from benchmark import trace as tracing
from benchmark.reference import step as ref_step

GENERATOR = {"a2b": "g_AB", "b2a": "g_BA"}


def write_model_folder(cfg: dict, seed: int, device, folder: Path) -> None:
    """The benchmark's weights as the program's model folder."""
    from cyclegan_tpu_torch.config import namespace2yaml
    from cyclegan_tpu_torch.models import create_model
    from cyclegan_tpu_torch.utils.checkpoint import save_model_folder

    weights = data.make_weights(cfg, seed, device)
    model_cfg = {"name": "benchmark", "generator": dict(cfg["generator"]),
                 "discriminator": dict(cfg["discriminator"]),
                 "loss": cfg["loss"], "loss_weights": dict(cfg["loss_weights"])}
    config_path = folder / "source_config.yaml"
    namespace2yaml(config_path, model_cfg)
    models = {}
    for n in data.NETWORKS:
        models[n] = create_model(cfg["generator" if n.startswith("g")
                                     else "discriminator"])
        models[n].load_state_dict({k: v.cpu() for k, v in weights[n].items()},
                                  strict=True)
    save_model_folder(folder, config_path, models)


def pool(traffic: dict, seed: int, device) -> np.ndarray:
    return data.smooth_images(int(traffic["pool"]), int(traffic["image_size"]),
                              seed, device).cpu().numpy()


def batch(images: np.ndarray, i: int, size: int) -> np.ndarray:
    lo = (i * size) % len(images)
    return images[lo:lo + size]


def open_session(cfg: dict, folder: Path, device):
    from cyclegan_tpu_torch.apps.inference import InferenceSession

    return InferenceSession(folder, compute_dtype=cfg["compute_dtype"],
                            tpu_layout=cfg["tpu_layout"], device=device)


def reference_answers(cfg: dict, seed: int, inputs, device,
                      precision: str = "f32", direction: str = "a2b"):
    params = data.make_weights(cfg, seed, device)[GENERATOR[direction]]
    return [ref_step.stylize(cfg["generator"], params,
                             torch.from_numpy(x).to(device),
                             precision).cpu().numpy() for x in inputs]


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        start: float) -> dict:
    cfg, traffic = cell.config, cell.traffic
    bsz, direction = int(traffic["batch"]), traffic["direction"]
    marks = [("start", start), ("imports", time.perf_counter())]
    images = pool(traffic, seed, device)
    marks.append(("pool", time.perf_counter()))
    sampler = random.Random(data.stream_seed(seed, "sample"))
    n_sampled = int(traffic["sampled"])
    with tempfile.TemporaryDirectory() as tmp:
        write_model_folder(cfg, seed, device, Path(tmp))
        marks.append(("checkpoint", time.perf_counter()))
        session = open_session(cfg, Path(tmp), device)
        marks.append(("session", time.perf_counter()))
    for _ in range(2):
        session.stylize(batch(images, 0, bsz), direction)

    t0 = time.perf_counter()
    marks.append(("warm-up", t0))
    setup_s = t0 - start
    print(f"setup_s {setup_s:.4f}: " + ", ".join(
        f"{name} {b - a:.3f} s" for (_, a), (name, b)
        in zip(marks, marks[1:])), flush=True)
    calls, kept = 0, []  # (call index, answer)
    while True:
        out = session.stylize(batch(images, calls, bsz), direction)
        if len(kept) < n_sampled:
            kept.append((calls, out))
        else:
            j = sampler.randrange(calls + 1)
            if j < n_sampled:
                kept[j] = (calls, out)
        calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    print(f"window: {calls} calls of {bsz} in {window_s:.4f} s", flush=True)

    records_out = {"kind": "stylize", "calls": calls, "window_s": window_s}
    if trace:
        n_traced = int(traffic["traced_calls"])

        def traced():
            for i in range(n_traced):
                session.stylize(batch(images, i, bsz), direction)

        peak = flops.peaks(torch.cuda.get_device_name(0))
        work = flops.generator_forward(cfg, bsz, int(traffic["image_size"]),
                                       peak)
        records_out.update(trace=tracing.profile(traced),
                           traced_calls=n_traced, ops_per_call=work["ops"],
                           conv_least_s_per_call=work["least_s"], peak=peak,
                           dtype=cfg["compute_dtype"])
        print(f"trace: { {k: v for k, v in records_out['trace'].items() if k != 'families'} }",
              flush=True)
    memory_peak = (torch.cuda.max_memory_allocated()
                   if torch.device(device).type == "cuda" else 0)
    del session, out
    _free(device)

    kept.sort(key=lambda x: x[0])
    inputs = [batch(images, i, bsz) for i, _ in kept]
    t_ref = time.perf_counter()
    reference = reference_answers(cfg, seed, inputs, device, "f32", direction)
    numbers = compare.image_gaps([a for _, a in kept], reference)
    print(f"reference: {time.perf_counter() - t_ref:.2f} s over calls "
          f"{[i for i, _ in kept]}; readings: {numbers}", flush=True)
    return {
        "end_to_end": {"stylize_img_s": bsz * calls / window_s,
                       "setup_s": setup_s},
        "records": records_out,
        "checks": compare.checks(numbers, cell.limits), "numbers": numbers,
        "attempted": calls, "failed": 0,
        "device": {"memory_peak_bytes": int(memory_peak)},
    }


def readings(cell, seed: int, device) -> dict:
    """The program's numbers on one seed: a short window at the cell's
    load (the window's calls and sample)."""
    out = run(cell, seed, seconds=2.0, trace=False, device=device,
              start=time.perf_counter())
    return out["numbers"]


def controls(cell, seed: int, device) -> dict:
    """{name: numbers} of the control (the reference in float8 in the
    program's place) and of an answer altered where it is produced (one
    image's top-left 16 x 16 pixels inverted)."""
    cfg, traffic = cell.config, cell.traffic
    bsz, direction = int(traffic["batch"]), traffic["direction"]
    images = pool(traffic, seed, device)
    inputs = [batch(images, i, bsz) for i in range(int(traffic["sampled"]))]
    reference = reference_answers(cfg, seed, inputs, device, "f32", direction)
    control = reference_answers(cfg, seed, inputs, device, "fp8", direction)
    witness = reference_answers(cfg, seed, inputs, device, "bf16", direction)
    altered = [r.copy() for r in reference]
    altered[0][0, :16, :16] = 255 - altered[0][0, :16, :16]
    return {"control_fp8": compare.image_gaps(control, reference),
            "witness_bf16": compare.image_gaps(witness, reference),
            "fault_altered": compare.image_gaps(altered, reference)}

