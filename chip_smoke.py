#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--out DIR]

from the root of the repository, on a machine with a CUDA card and nvcc.
It needs no network and writes only the kernel build
(``cyclegan_tpu_torch/kernels/build``) and, with ``--out``, the per-launch
details (``chip_smoke_detail.json``) and a profiler trace of the forward
(``forward_trace.json``) into DIR. Phases, each failing the run if it
fails:

1. the card (``nvidia-smi`` name and power limit) and the build of the
   four CUDA kernels from ``cyclegan_tpu_torch/kernels/csrc``;
2. every kernel against its plain PyTorch version on the card, at the
   shape of each of its launches in one forward of the default generator
   (256x256, batch 8), in bf16 and f32, with TF32 off;
3. each kernel's time at those shapes (CUDA events, median after warm-up)
   beside its plain version, one PyTorch library call for the same
   function, and the least time the card could take;
4. serving: ``InferenceSession`` on converged256, bf16, on the card,
   answers batch-8 and batch-1 requests in both directions; each forward
   must launch 15/14/3/3 conv/norm/pool/junction kernels, and the outputs
   are held against the plain f32 session on the CPU. Then serving img/s.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the kernels' numbers as JSON.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
MODEL_DIR = ROOT / "model_instances" / "converged256"
DEVICE = "cuda"
BATCH = 8
SIZE = 256
TIMED_REPS = 20

# H100 SXM published peaks (dense): HBM bytes/s and operations/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Kernel vs plain version on the card. conv and norm sum in f32 in another
# order and round once: in bf16 they may land one bf16 step apart (2^-8
# relative), in f32 a few f32 ulps of a sum of up to 3072 terms. The pool
# adds in the same order and the junction copies: exact.
TOL = {
    ("conv_same", torch.bfloat16): (1e-2, 1e-2),
    ("conv_same", torch.float32): (1e-4, 1e-4),
    ("instance_norm_act", torch.bfloat16): (1e-2, 1e-2),
    ("instance_norm_act", torch.float32): (1e-4, 1e-4),
    ("sum2x2", torch.bfloat16): (0.0, 0.0),
    ("sum2x2", torch.float32): (0.0, 0.0),
    ("concat_up2", torch.bfloat16): (0.0, 0.0),
    ("concat_up2", torch.float32): (0.0, 0.0),
}
SOURCES = {
    "conv_same": ("cyclegan_tpu_torch/kernels/csrc/conv_same.cu",
                  "cyclegan_tpu/ops/pallas_conv.py:479",
                  ["cyclegan_tpu/ops/pallas_conv.py:924"]),
    "instance_norm_act": ("cyclegan_tpu_torch/kernels/csrc/norm_act.cu",
                          "cyclegan_tpu/ops/pallas_norm_act.py:519",
                          ["cyclegan_tpu/ops/pallas_norm_act.py:396"]),
    "sum2x2": ("cyclegan_tpu_torch/kernels/csrc/sum2x2.cu",
               "cyclegan_tpu/ops/pallas_resize.py:152", []),
    "concat_up2": ("cyclegan_tpu_torch/kernels/csrc/concat_up2.cu",
                   "cyclegan_tpu/ops/pallas_concat.py:265", []),
}
# serving: card bf16 output vs the plain f32 session, in uint8 steps
SERVE_MEAN_MAX = 0.5
SERVE_FAR = 8            # a pixel this far off counts as an outlier...
SERVE_FAR_SHARE = 1e-3   # ...and at most this share of them may be
SERVE_F32_MAX = 1

failures = []


def fail(msg):
    failures.append(msg)
    print(f"FAIL {msg}", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def generator_launches(cfg, batch, size):
    """The kernel launches of one forward of the pooled U-Net, in order:
    conv (B, H, Cin, Cout, K, bias), norm (B, H, C), pool (B, H, C),
    junction (B, H, C1, C2) with H the output side."""
    filters, ks = list(cfg["filters"]), list(cfg["kernels"])
    conv, norm, pool, junction = [], [], [], []
    c, s, skips = 3, size, []

    def double_conv(cin, f, k, s):
        for ci in (cin, f):
            conv.append((batch, s, ci, f, k, False))
            norm.append((batch, s, f))

    for f, k in zip(filters[:-1], ks[:-1]):
        double_conv(c, f, k, s)
        skips.append((f, s))
        pool.append((batch, s, f))
        c, s = f, s // 2
    double_conv(c, filters[-1], ks[-1], s)
    c = filters[-1]
    for f, k, (skip_c, skip_s) in zip(filters[::-1][:-1], ks[:0:-1],
                                      skips[::-1]):
        junction.append((batch, skip_s, skip_c, c))
        double_conv(skip_c + c, f, k, skip_s)
        c = f
    conv.append((batch, size, c, int(cfg["output_channels"]), 1, True))
    return {"conv_same": conv, "instance_norm_act": norm, "sum2x2": pool,
            "concat_up2": junction}


def make_case(name, shape, dtype, seed):
    """Inputs of one launch, made on the card from a seed; returns
    (kernel call, plain call, library call, bytes, operations)."""
    from cyclegan_tpu_torch.ops import (cuda_concat, cuda_conv,
                                        cuda_norm_act, cuda_resize)

    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def rnd(*s, scale=1.0, offset=0.0):
        return (offset + scale * torch.randn(s, generator=g, device=DEVICE,
                                             dtype=torch.float32)).to(dtype)

    size = torch.finfo(dtype).bits // 8
    if name == "conv_same":
        B, H, cin, cout, k, has_bias = shape
        x = rnd(B, H, cin, H)
        w = rnd(k, k, cin, cout, scale=0.05)
        b = rnd(cout, scale=0.5) if has_bias else None
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        x_nchw = x.permute(0, 2, 1, 3)
        nbytes = (x.numel() + w.numel() + (cout if has_bias else 0)
                  + B * H * cout * H) * size
        ops = 2 * B * H * H * k * k * cin * cout
        return (lambda: cuda_conv.conv_same_cuda(x, w, b),
                lambda: cuda_conv.conv_same_plain(x, w, b),
                lambda: F.conv2d(x_nchw, w_oihw, b, padding="same"),
                nbytes, ops)
    if name == "instance_norm_act":
        B, H, c = shape
        x = rnd(B, H, c, H, scale=1.5, offset=0.5)
        gamma = rnd(c, scale=0.1, offset=1.0)
        beta = rnd(c, scale=0.1)
        x_nchw = x.permute(0, 2, 1, 3)
        n = x.numel()
        # Σx, Σx², then (x - mu)·a + b and the max: 7 per element
        return (lambda: cuda_norm_act.instance_norm_act_cuda(
                    x, gamma, beta, 1e-3, "relu"),
                lambda: cuda_norm_act.instance_norm_act_plain(
                    x, gamma, beta, 1e-3, "relu"),
                lambda: F.relu(F.instance_norm(x_nchw, weight=gamma,
                                               bias=beta, eps=1e-3)),
                (2 * n + 2 * c) * size, 7 * n)
    if name == "sum2x2":
        B, H, c = shape
        x = rnd(B, H, c, H)
        x_nchw = x.permute(0, 2, 1, 3)
        out = x.numel() // 4
        return (lambda: cuda_resize.sum2x2_cuda(x, 0.25),
                lambda: cuda_resize.sum2x2_plain(x, 0.25),
                lambda: F.avg_pool2d(x_nchw, 2),
                (x.numel() + out) * size, 4 * out)
    if name == "concat_up2":
        B, H, c1, c2 = shape
        skip = rnd(B, H, c1, H)
        x = rnd(B, H // 2, c2, H // 2)
        x_nchw = x.permute(0, 2, 1, 3)
        return (lambda: cuda_concat.concat_up2_cuda(skip, x),
                lambda: cuda_concat.concat_up2_plain(skip, x),
                lambda: torch.cat([skip, F.interpolate(
                    x_nchw, scale_factor=2,
                    mode="nearest").permute(0, 2, 1, 3)], dim=2),
                (skip.numel() + x.numel() + B * H * (c1 + c2) * H) * size,
                0)
    raise KeyError(name)


def time_ms(fn, reps=TIMED_REPS, warmup=3):
    """Median device time of one call, CUDA events around each call.

    A ~1 ms spin kernel ahead of each timed call keeps the card busy while
    the host issues it, so the events bracket the call's device work and
    not the wrapper's host time (~30 us, longer than the small kernels)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def check_kernels(launches):
    """Phase 2: kernel vs plain at every launch shape, bf16 and f32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    max_err = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, shapes in launches.items():
            rtol, atol = TOL[(name, dtype)]
            worst = 0.0
            for i, shape in enumerate(shapes):
                kernel, plain, _, _, _ = make_case(name, shape, dtype, i)
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                if got.shape != want.shape or got.dtype != want.dtype:
                    fail(f"{name} {shape} {dtype}: {tuple(got.shape)} "
                         f"{got.dtype} vs {tuple(want.shape)} {want.dtype}")
                    continue
                diff = (got.float() - want.float()).abs()
                limit = atol + rtol * want.float().abs()
                err = diff.max().item()
                worst = max(worst, err)
                if not bool(torch.isfinite(got.float()).all()):
                    fail(f"{name} {shape} {dtype}: non-finite output")
                if bool((diff > limit).any()):
                    fail(f"{name} {shape} {dtype}: max abs err {err} "
                         f"beyond rtol {rtol} atol {atol}")
            max_err[(name, dtype)] = worst
            print(f"check {name:17s} {str(dtype):14s} {len(shapes):2d} "
                  f"shapes  max_abs_err {worst:.3e}  (rtol {rtol}, "
                  f"atol {atol})", flush=True)
    return max_err


def time_kernels(launches, dtype=torch.bfloat16):
    """Phase 3: per launch, kernel / plain / library / bound ms."""
    rows = []
    for name, shapes in launches.items():
        for i, shape in enumerate(shapes):
            kernel, plain, library, nbytes, ops = make_case(
                name, shape, dtype, 1000 + i)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / PEAK_OPS[dtype] * 1e3
            row = {"kernel": name, "shape": list(shape),
                   "ms": time_ms(kernel), "plain_ms": time_ms(plain),
                   "library_ms": time_ms(library),
                   "bytes": nbytes, "operations": ops,
                   "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                   "bound_ms": max(bytes_ms, ops_ms)}
            rows.append(row)
            print(f"time {name:17s} {str(shape):28s} kernel "
                  f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f}  "
                  f"library {row['library_ms']:.4f}  bound "
                  f"{row['bound_ms']:.4f}", flush=True)
    return rows


def device_trace(forward, out_dir, n=5):
    """torch.profiler over ``n`` back-to-back generator forwards: device
    time per forward by kernel family, and the share of the window in which
    no kernel ran. Kernel spans come from the exported Chrome trace, kept
    in ``out_dir`` if given."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            forward()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(out_dir or tmp) / "forward_trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "kernel" and e.get("ph") == "X"]
    if not spans:
        print("trace: no kernel events, device time not measured")
        return None
    spans.sort()
    busy, end = 0.0, spans[0][0]
    for s, e, _ in spans:  # union of the kernel intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    window = max(e for _, e, _ in spans) - spans[0][0]
    families = {}
    for s, e, name in spans:
        family = next((k for k in ("conv_same", "norm_act", "sum2x2",
                                   "concat_up2") if k + "_kernel" in name),
                      "other: " + name[:60])
        families[family] = families.get(family, 0.0) + (e - s) / n / 1e3
    result = {"forwards": n, "window_ms": window / 1e3,
              "device_busy_ms_per_forward": busy / n / 1e3,
              "idle_share": 1.0 - busy / window,
              "kernels_per_forward": len(spans) / n,
              "ms_per_forward_by_kernel": families}
    print(f"trace: {json.dumps(result)}", flush=True)
    return result


def serve(cfg, out_dir):
    """Phase 4: the port's main path. Returns launches and metrics."""
    from cyclegan_tpu_torch import kernels
    from cyclegan_tpu_torch.apps.inference import InferenceSession

    per_forward = {name: len(v) for name, v in
                   generator_launches(cfg, 1, SIZE).items()}
    session = InferenceSession(MODEL_DIR, "bfloat16", device=DEVICE)
    rng = np.random.default_rng(0)
    images = {b: rng.integers(0, 256, (b, SIZE, SIZE, 3), dtype=np.uint8)
              for b in (BATCH, 1)}
    requests = [(BATCH, "a2b"), (BATCH, "b2a"), (1, "a2b"), (1, "b2a")]

    kernels.reset_launches()
    outputs = {}
    for b, direction in requests:
        before = dict(kernels.launches)
        outputs[(b, direction)] = session.stylize(images[b], direction)
        added = {k: kernels.launches[k] - before[k] for k in before}
        if added != per_forward:
            fail(f"serve {b} {direction}: launches {added}, expected "
                 f"{per_forward}")
    main_launches = dict(kernels.launches)
    print(f"serve main path launches {main_launches} over {len(requests)} "
          f"forwards ({per_forward} each)", flush=True)

    cpu32 = InferenceSession(MODEL_DIR, "float32", device="cpu")
    cpu16 = InferenceSession(MODEL_DIR, "bfloat16", device="cpu")
    card32 = InferenceSession(MODEL_DIR, "float32", device=DEVICE)
    quality = []
    for b, direction in requests:
        out = outputs[(b, direction)]
        ref = cpu32.stylize(images[b], direction).astype(int)
        if out.shape != images[b].shape or out.dtype != np.uint8:
            fail(f"serve {b} {direction}: output {out.shape} {out.dtype}")
        d = np.abs(out.astype(int) - ref)
        d_plain = np.abs(cpu16.stylize(images[b], direction).astype(int)
                         - ref)
        d32 = np.abs(card32.stylize(images[b], direction).astype(int) - ref)
        q = {"batch": b, "direction": direction,
             "bf16_card_vs_f32_cpu_max": int(d.max()),
             "bf16_card_vs_f32_cpu_mean": float(d.mean()),
             "bf16_card_share_beyond_8": float((d > SERVE_FAR).mean()),
             "bf16_cpu_vs_f32_cpu_max": int(d_plain.max()),
             "bf16_cpu_vs_f32_cpu_mean": float(d_plain.mean()),
             "f32_card_vs_f32_cpu_max": int(d32.max())}
        quality.append(q)
        print(f"serve quality {json.dumps(q)}", flush=True)
        if q["bf16_card_vs_f32_cpu_mean"] > SERVE_MEAN_MAX:
            fail(f"serve {b} {direction}: mean uint8 diff "
                 f"{q['bf16_card_vs_f32_cpu_mean']} > {SERVE_MEAN_MAX}")
        if q["bf16_card_share_beyond_8"] > SERVE_FAR_SHARE:
            fail(f"serve {b} {direction}: share of pixels > {SERVE_FAR} off "
                 f"{q['bf16_card_share_beyond_8']} > {SERVE_FAR_SHARE}")
        if q["bf16_card_vs_f32_cpu_max"] > max(
                SERVE_FAR, 1.5 * q["bf16_cpu_vs_f32_cpu_max"]):
            fail(f"serve {b} {direction}: max uint8 diff "
                 f"{q['bf16_card_vs_f32_cpu_max']} beyond 1.5x the plain "
                 f"bf16 session's {q['bf16_cpu_vs_f32_cpu_max']}")
        if q["f32_card_vs_f32_cpu_max"] > SERVE_F32_MAX:
            fail(f"serve {b} {direction}: f32 card vs cpu max "
                 f"{q['f32_card_vs_f32_cpu_max']} > {SERVE_F32_MAX}")

    # throughput at batch 8: whole requests on the host clock (uint8 in,
    # uint8 out), then the generator alone on CUDA events
    image = images[BATCH]
    for _ in range(3):
        session.stylize(image, "a2b")
    walls = []
    for _ in range(TIMED_REPS):
        t0 = time.perf_counter()
        session.stylize(image, "a2b")
        walls.append(time.perf_counter() - t0)
    from cyclegan_tpu_torch.data.augment import normalize
    from cyclegan_tpu_torch.ops import layout

    x = layout.to_nhcw(normalize(torch.as_tensor(image).to(DEVICE)).to(
        torch.bfloat16))
    model = session.models["g_AB"]
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(x))
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        model(x)
    torch.cuda.synchronize()
    enqueue = []  # host time to issue one forward, the card idle before
    with torch.inference_mode():
        for _ in range(TIMED_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(x)
            enqueue.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    trace = device_trace(lambda: model(x), out_dir)
    metrics = {
        "batch": BATCH, "size": SIZE, "compute_dtype": "bfloat16",
        "request_ms_median": statistics.median(walls) * 1e3,
        "img_per_s": BATCH / statistics.median(walls),
        "forward_ms_median": fwd_ms,
        "forward_img_per_s": BATCH / fwd_ms * 1e3,
        "forward_peak_mib": torch.cuda.max_memory_allocated() / 2**20,
        "forward_host_issue_ms_median": statistics.median(enqueue) * 1e3,
        "trace": trace,
        "quality": quality,
    }
    print(f"serve batch {BATCH}: {metrics['img_per_s']:.1f} img/s per "
          f"request (median {metrics['request_ms_median']:.2f} ms), "
          f"generator forward {fwd_ms:.3f} ms = "
          f"{metrics['forward_img_per_s']:.1f} img/s", flush=True)
    return main_launches, len(requests), metrics


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=None,
                        help="directory for per-launch details and the "
                             "forward's profiler trace")
    out_dir = parser.parse_args(argv).out
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    warnings.filterwarnings("ignore", message=".*padding='same'.*")
    from cyclegan_tpu_torch import kernels
    from cyclegan_tpu_torch.config import yaml2namespace
    from cyclegan_tpu_torch.kernels import _build

    card = smi_line()
    print(card, flush=True)
    build = _build.build_dir()
    print(f"kernels built in {_build.build_seconds:.1f} s "
          f"(0 = found built) into build/{build.name}", flush=True)
    for log in sorted(build.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {log.stem}: {line.strip()}")

    cfg = yaml2namespace(MODEL_DIR / "model_config.yaml").generator
    launches = generator_launches(cfg, BATCH, SIZE)
    counts = {k: len(v) for k, v in launches.items()}
    if counts != {"conv_same": 15, "instance_norm_act": 14, "sum2x2": 3,
                  "concat_up2": 3}:
        fail(f"generator launch plan {counts}")
    max_err = check_kernels(launches)
    rows = time_kernels(launches)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    main_launches, n_forwards, serving = serve(cfg, out_dir)

    entries = []
    for name in kernels.KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        source, replaces, also = SOURCES[name]
        bytes_ms = sum(r["bytes_ms"] for r in mine)
        ops_ms = sum(r["ops_ms"] for r in mine)
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "also_replaces": also,
            "launches": main_launches[name],
            "forwards": n_forwards,
            "launches_per_forward": len(mine),
            "max_abs_err": max_err[(name, torch.bfloat16)],
            "max_abs_err_f32": max_err[(name, torch.float32)],
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
            "library_ms": sum(r["library_ms"] for r in mine),
            "timing": "bf16, sum over one batch-8 256x256 forward's "
                      "launches of the median per launch",
        })
        if main_launches[name] == 0:
            fail(f"{name}: no launch on the main path")
    if out_dir is not None:
        (out_dir / "chip_smoke_detail.json").write_text(json.dumps(
            {"card": card, "kernels": entries, "launch_rows": rows,
             "serving": serving}, indent=1))
    print(json.dumps({"serving": {k: v for k, v in serving.items()
                                  if k != "quality"}}))
    print(json.dumps({"kernels": entries}))
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
