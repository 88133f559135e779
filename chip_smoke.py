#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--out DIR]

from the root of the repository, on a machine with a CUDA card and nvcc.
It needs no network and writes only the kernel build
(``cyclegan_tpu_torch/kernels/build``) and, with ``--out``, the per-launch
details (``chip_smoke_detail.json``) and profiler traces of the serving
forward and of the train step (``forward_trace.json``,
``train_trace.json``) into DIR. Phases, each failing the run if it fails:

1. the card (``nvidia-smi`` name and power limit) and the build of the
   eight CUDA kernels from ``cyclegan_tpu_torch/kernels/csrc``;
2. every kernel against its plain PyTorch version on the card, at every
   unique launch shape of one train step of the default recipe (batch 8,
   256x256; its generator forwards are the serving forward's launches),
   in bf16 and f32, with TF32 off: the forward kernels K1-K4, K1 at the
   input gradient's pad, K2's mu and rstd, and the backward kernels K5-K8;
3. each kernel's time at those shapes (CUDA events, median after warm-up)
   beside its plain version, one PyTorch library call for the same
   function where there is one, and the least time the card could take;
4. serving: ``InferenceSession`` on converged256, bf16, on the card,
   answers batch-8 and batch-1 requests in both directions; each forward
   must launch 15/14/3/3 conv/norm/pool/junction kernels, and the outputs
   are held against the plain f32 session on the CPU. Then serving img/s;
5. training, from converged256's four networks with fresh Adam: one bf16
   step at batch 8 (jitter inside) whose launches of every kernel equal
   the plan ``train_launches`` derives from the configs; the f32 gradients
   of a batch-2 step on the card against the plain f32 step on the CPU;
   the bf16 card step's gradient error against the CPU bf16 step's; five
   bf16 steps with finite losses that move every network; then train-step
   img/s, peak memory, host issue time and a profiler trace of 3 steps.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the kernels' numbers as JSON.
"""

from __future__ import annotations

import argparse
import collections
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
TRAIN_CONFIG = ROOT / "configs" / "training_config.yaml"
DEVICE = "cuda"
BATCH = 8
SIZE = 256
GRAD_BATCH = 2           # the card-vs-CPU gradient comparison
TIMED_REPS = 20
TRAIN_STEPS_TIMED = 10

# H100 SXM published peaks (dense): HBM bytes/s and operations/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Kernel vs plain version on the card: |got - want| <= rtol |want| + atol s,
# per output, with s the output's scale (1 unless stated). conv and norm sum
# in f32 in another order and round once: in bf16 they may land one bf16
# step apart (2^-8 relative), in f32 a few ulps of a sum of up to 3072
# terms. K2's statistics are f32 sums of up to 65,536 terms. conv_dw returns
# f32 sums of up to 524,288 products in both types: its scale is
# s = sum |x| |g| over the same terms. K6's dx and t1, t2 take the largest
# |value| of each output as s (its relu decision is made on the same f32
# v = gamma xhat + beta in both, so no element flips). The pool, its
# gradient and the junction's copy and adds are in the same order: exact.
TOL = {
    ("conv_same", torch.bfloat16): (1e-2, 1e-2),
    ("conv_same", torch.float32): (1e-4, 1e-4),
    ("instance_norm_act", torch.bfloat16): (1e-2, 1e-2),
    ("instance_norm_act", torch.float32): (1e-4, 1e-4),
    ("instance_norm_act.stats", torch.bfloat16): (1e-4, 1e-5),
    ("instance_norm_act.stats", torch.float32): (1e-4, 1e-5),
    ("sum2x2", torch.bfloat16): (0.0, 0.0),
    ("sum2x2", torch.float32): (0.0, 0.0),
    ("concat_up2", torch.bfloat16): (0.0, 0.0),
    ("concat_up2", torch.float32): (0.0, 0.0),
    ("conv_dw", torch.bfloat16): (0.0, 1e-5),
    ("conv_dw", torch.float32): (0.0, 1e-5),
    ("instance_norm_act_bwd", torch.bfloat16): (1e-2, 1e-2),
    ("instance_norm_act_bwd", torch.float32): (1e-4, 1e-4),
    ("instance_norm_act_bwd.sums", torch.bfloat16): (1e-3, 1e-4),
    ("instance_norm_act_bwd.sums", torch.float32): (1e-3, 1e-4),
    ("dup2x2", torch.bfloat16): (0.0, 0.0),
    ("dup2x2", torch.float32): (0.0, 0.0),
    ("split_pool2", torch.bfloat16): (0.0, 0.0),
    ("split_pool2", torch.float32): (0.0, 0.0),
}
_CSRC = "cyclegan_tpu_torch/kernels/csrc/"
SOURCES = {
    "conv_same": (_CSRC + "conv_same.cu",
                  "cyclegan_tpu/ops/pallas_conv.py:479",
                  ["cyclegan_tpu/ops/pallas_conv.py:924"]),
    "instance_norm_act": (_CSRC + "norm_act.cu",
                          "cyclegan_tpu/ops/pallas_norm_act.py:519",
                          ["cyclegan_tpu/ops/pallas_norm_act.py:396"]),
    "sum2x2": (_CSRC + "sum2x2.cu",
               "cyclegan_tpu/ops/pallas_resize.py:152", []),
    "concat_up2": (_CSRC + "concat_up2.cu",
                   "cyclegan_tpu/ops/pallas_concat.py:265", []),
    "conv_dw": (_CSRC + "conv_dw.cu",
                "cyclegan_tpu/ops/pallas_conv.py:686",
                ["cyclegan_tpu/ops/pallas_conv.py:991"]),
    "instance_norm_act_bwd": (_CSRC + "norm_act_bwd.cu",
                              "cyclegan_tpu/ops/pallas_norm_act.py:573",
                              ["cyclegan_tpu/ops/pallas_norm_act.py:457"]),
    "dup2x2": (_CSRC + "dup2x2.cu",
               "cyclegan_tpu/ops/pallas_resize.py:209", []),
    "split_pool2": (_CSRC + "split_pool2.cu",
                    "cyclegan_tpu/ops/pallas_concat.py:305", []),
}
# kernel-name fragments of the profiler trace -> kernel family
TRACE_FAMILIES = (
    ("conv_same_kernel", "conv_same"),
    ("conv_dw_partial_kernel", "conv_dw"), ("sum_splits_kernel", "conv_dw"),
    ("norm_act_bwd_kernel", "instance_norm_act_bwd"),
    ("norm_act_kernel", "instance_norm_act"),
    ("sum2x2_kernel", "sum2x2"), ("dup2x2_kernel", "dup2x2"),
    ("concat_up2_kernel", "concat_up2"),
    ("split_pool2_kernel", "split_pool2"),
)
# serving: card bf16 output vs the plain f32 session, in uint8 steps
SERVE_MEAN_MAX = 0.5
SERVE_FAR = 8            # a pixel this far off counts as an outlier...
SERVE_FAR_SHARE = 1e-3   # ...and at most this share of them may be
SERVE_F32_MAX = 1
# training: per network, |g_card - g_cpu| / |g_cpu| in f32, and the bf16
# card step's error at most this multiple of the plain bf16 step's
TRAIN_F32_REL = 1e-3
TRAIN_BF16_RATIO = 1.5

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


def tf_pad(k):
    return (k - 1) // 2


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


def train_launches(model_cfg, batch, size):
    """The kernel launches of one train step (``steps.make_train_step``),
    by kernel, as unordered lists of shapes:

    conv_same (B, H, Cin, Cout, K, bias, pad), conv_dw (B, H, Cin, Cout, K,
    pad), instance_norm_act[_bwd] (B, H, C), sum2x2 (B, H, C) with H the
    input side, dup2x2 (B, h, C) with h the pooled side, concat_up2 and
    split_pool2 (B, H, C1, C2).

    Forward: 6 generator and 6 discriminator applications (each fake
    batch's generator view and discriminator view are two applications).
    Backward, per application: K6 for every norm, K7 for every pool, K8 for
    every junction; K5 (dW) for every conv where the parameters train
    (not under the generator view); K1 at the transposed pad (dX) for
    every conv but the first, and for the first where the input needs a
    gradient: the generators applied to the fakes (the cycle) and the
    discriminators' generator view."""
    gen = generator_launches(model_cfg["generator"], batch, size)
    disc = generator_launches(model_cfg["discriminator"], batch, size)
    # (plan, parameters train, input needs a gradient)
    apps = ([(gen, True, False)] * 4 + [(gen, True, True)] * 2
            + [(disc, True, False)] * 4 + [(disc, False, True)] * 2)
    out = {name: [] for name in ("conv_same", "instance_norm_act", "sum2x2",
                                 "concat_up2", "conv_dw",
                                 "instance_norm_act_bwd", "dup2x2",
                                 "split_pool2")}
    for plan, params_train, input_grad in apps:
        for i, (b, h, cin, cout, k, bias) in enumerate(plan["conv_same"]):
            out["conv_same"].append((b, h, cin, cout, k, bias, tf_pad(k)))
            if i > 0 or input_grad:
                out["conv_same"].append(
                    (b, h, cout, cin, k, False, k - 1 - tf_pad(k)))
            if params_train:
                out["conv_dw"].append((b, h, cin, cout, k, tf_pad(k)))
        out["instance_norm_act"] += plan["instance_norm_act"]
        out["instance_norm_act_bwd"] += plan["instance_norm_act"]
        out["sum2x2"] += plan["sum2x2"]
        out["dup2x2"] += [(b, h // 2, c) for b, h, c in plan["sum2x2"]]
        out["concat_up2"] += plan["concat_up2"]
        out["split_pool2"] += plan["concat_up2"]
    return out


def make_case(name, shape, dtype, seed):
    """Inputs of one launch, made on the card from a seed. Returns
    (kernel call, plain call, library call or None, bytes, operations,
    checks): both calls return a tuple of outputs, and checks names each
    output's tolerance key and scale."""
    from cyclegan_tpu_torch.ops import (cuda_concat, cuda_conv,
                                        cuda_norm_act, cuda_resize)

    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def rnd(*s, scale=1.0, offset=0.0):
        return (offset + scale * torch.randn(s, generator=g, device=DEVICE,
                                             dtype=torch.float32)).to(dtype)

    size = torch.finfo(dtype).bits // 8
    nchw = lambda t: t.permute(0, 2, 1, 3)  # noqa: E731
    if name == "conv_same":
        B, H, cin, cout, k, has_bias, pad = shape
        x = rnd(B, H, cin, H)
        w = rnd(k, k, cin, cout, scale=0.05)
        b = rnd(cout, scale=0.5) if has_bias else None
        xp = F.pad(nchw(x), (pad, k - 1 - pad, pad, k - 1 - pad))
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        nbytes = (x.numel() + w.numel() + (cout if has_bias else 0)
                  + B * H * cout * H) * size
        return (lambda: (cuda_conv.conv_same_cuda(x, w, b, pad=pad),),
                lambda: (cuda_conv.conv_same_plain(x, w, b, pad=pad),),
                lambda: F.conv2d(xp, w_oihw, b),
                nbytes, 2 * B * H * H * k * k * cin * cout,
                [(name, 1.0)])
    if name == "conv_dw":
        B, H, cin, cout, k, pad = shape
        x = rnd(B, H, cin, H)
        gy = rnd(B, H, cout, H)
        xp = F.pad(nchw(x), (pad, k - 1 - pad, pad, k - 1 - pad))
        gy_nchw = nchw(gy)
        scale = cuda_conv.conv_dw_plain(x.abs(), gy.abs(), k, pad)
        return (lambda: (cuda_conv.conv_dw_cuda(x, gy, k, pad),),
                lambda: (cuda_conv.conv_dw_plain(x, gy, k, pad),),
                lambda: torch.nn.grad.conv2d_weight(
                    xp, (cout, cin, k, k), gy_nchw),
                (x.numel() + gy.numel()) * size + k * k * cin * cout * 4,
                2 * B * H * H * k * k * cin * cout, [(name, scale)])
    if name == "instance_norm_act":
        B, H, c = shape
        x = rnd(B, H, c, H, scale=1.5, offset=0.5)
        gamma = rnd(c, scale=0.1, offset=1.0)
        beta = rnd(c, scale=0.1)
        n = x.numel()
        # Σx, Σx², then (x - mu)·a + b and the max: 7 per element
        return (lambda: cuda_norm_act.instance_norm_act_cuda(
                    x, gamma, beta, 1e-3, "relu", with_stats=True),
                lambda: cuda_norm_act.instance_norm_act_plain(
                    x, gamma, beta, 1e-3, "relu", with_stats=True),
                lambda: F.relu(F.instance_norm(nchw(x), weight=gamma,
                                               bias=beta, eps=1e-3)),
                (2 * n + 2 * c) * size + 2 * B * c * 4, 7 * n,
                [(name, 1.0), (name + ".stats", 1.0),
                 (name + ".stats", 1.0)])
    if name == "instance_norm_act_bwd":
        B, H, c = shape
        x = rnd(B, H, c, H, scale=1.5, offset=0.5)
        gamma = rnd(c, scale=0.1, offset=1.0)
        beta = rnd(c, scale=0.1)
        gz = rnd(B, H, c, H)
        _, mu, rstd = cuda_norm_act.instance_norm_act_plain(
            x, gamma, beta, 1e-3, "relu", with_stats=True)
        leaves = [nchw(x).detach().clone().requires_grad_(True),
                  gamma.detach().clone().requires_grad_(True),
                  beta.detach().clone().requires_grad_(True)]
        y = F.relu(F.instance_norm(leaves[0], weight=leaves[1],
                                   bias=leaves[2], eps=1e-3))
        gz_nchw = nchw(gz)
        n = x.numel()
        want = cuda_norm_act.instance_norm_act_bwd_plain(
            x, gz, gamma, beta, mu, rstd, "relu")
        scales = [float(t.float().abs().max()) for t in want]
        # xhat, v, dv, the two sums and dx: 12 per element
        return (lambda: cuda_norm_act.instance_norm_act_bwd_cuda(
                    x, gz, gamma, beta, mu, rstd, "relu"),
                lambda: cuda_norm_act.instance_norm_act_bwd_plain(
                    x, gz, gamma, beta, mu, rstd, "relu"),
                lambda: torch.autograd.grad(y, leaves, gz_nchw,
                                            retain_graph=True),
                (3 * n + 2 * c) * size + 4 * B * c * 4, 12 * n,
                [(name, scales[0]), (name + ".sums", scales[1]),
                 (name + ".sums", scales[2])])
    if name == "sum2x2":
        B, H, c = shape
        x = rnd(B, H, c, H)
        out = x.numel() // 4
        return (lambda: (cuda_resize.sum2x2_cuda(x, 0.25),),
                lambda: (cuda_resize.sum2x2_plain(x, 0.25),),
                lambda: F.avg_pool2d(nchw(x), 2),
                (x.numel() + out) * size, 4 * out, [(name, 1.0)])
    if name == "dup2x2":
        B, h, c = shape
        gy = rnd(B, h, c, h)
        x_shape = torch.empty((B, c, 2 * h, 2 * h), dtype=dtype,
                              device=DEVICE)
        gy_nchw = nchw(gy)
        return (lambda: (cuda_resize.dup2x2_cuda(gy, 0.25),),
                lambda: (cuda_resize.dup2x2_plain(gy, 0.25),),
                lambda: torch.ops.aten.avg_pool2d_backward(
                    gy_nchw, x_shape, [2, 2], [2, 2], [0, 0], False, True,
                    None),
                5 * gy.numel() * size, gy.numel(), [(name, 1.0)])
    if name == "concat_up2":
        B, H, c1, c2 = shape
        skip = rnd(B, H, c1, H)
        x = rnd(B, H // 2, c2, H // 2)
        return (lambda: (cuda_concat.concat_up2_cuda(skip, x),),
                lambda: (cuda_concat.concat_up2_plain(skip, x),),
                lambda: torch.cat([skip, F.interpolate(
                    nchw(x), scale_factor=2,
                    mode="nearest").permute(0, 2, 1, 3)], dim=2),
                (skip.numel() + x.numel() + B * H * (c1 + c2) * H) * size,
                0, [(name, 1.0)])
    if name == "split_pool2":
        B, H, c1, c2 = shape
        gy = rnd(B, H, c1 + c2, H)
        pooled = B * (H // 2) * c2 * (H // 2)
        return (lambda: cuda_concat.split_pool2_cuda(gy, c1),
                lambda: cuda_concat.split_pool2_plain(gy, c1),
                None,
                (gy.numel() + B * H * c1 * H + pooled) * size, 3 * pooled,
                [(name, 1.0), (name, 1.0)])
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


def unique_shapes(plan):
    """{kernel: Counter(shape -> launches per step)}."""
    return {name: collections.Counter(shapes) for name, shapes in
            plan.items()}


def check_kernels(shapes):
    """Phase 2: kernel vs plain at every unique launch shape, bf16 and
    f32. Returns the largest absolute error per (kernel, dtype)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    max_err = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, counter in shapes.items():
            worst = 0.0
            for i, shape in enumerate(sorted(counter)):
                kernel, plain, _, _, _, checks = make_case(name, shape,
                                                           dtype, i)
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                for j, (a, b, (key, scale)) in enumerate(zip(got, want,
                                                             checks)):
                    rtol, atol = TOL[(key, dtype)]
                    if a.shape != b.shape or a.dtype != b.dtype:
                        fail(f"{name} {shape} {dtype} output {j}: "
                             f"{tuple(a.shape)} {a.dtype} vs "
                             f"{tuple(b.shape)} {b.dtype}")
                        continue
                    diff = (a.float() - b.float()).abs()
                    limit = atol * scale + rtol * b.float().abs()
                    err = diff.max().item()
                    worst = max(worst, err)
                    if not bool(torch.isfinite(a.float()).all()):
                        fail(f"{name} {shape} {dtype} output {j}: "
                             f"non-finite")
                    if bool((diff > limit).any()):
                        fail(f"{name} {shape} {dtype} output {j}: max abs "
                             f"err {err} beyond rtol {rtol} atol {atol} "
                             f"x scale")
            max_err[(name, dtype)] = worst
            print(f"check {name:22s} {str(dtype):14s} {len(counter):2d} "
                  f"shapes  max_abs_err {worst:.3e}", flush=True)
    return max_err


def time_kernels(shapes, dtype=torch.bfloat16):
    """Phase 3: per unique launch shape, kernel / plain / library / bound
    ms, with the shape's launches per train step."""
    rows = []
    for name, counter in shapes.items():
        for i, shape in enumerate(sorted(counter)):
            kernel, plain, library, nbytes, ops, _ = make_case(
                name, shape, dtype, 1000 + i)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / PEAK_OPS[dtype] * 1e3
            row = {"kernel": name, "shape": list(shape),
                   "per_step": counter[shape],
                   "ms": time_ms(kernel), "plain_ms": time_ms(plain),
                   "library_ms": None if library is None
                   else time_ms(library),
                   "bytes": nbytes, "operations": ops,
                   "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                   "bound_ms": max(bytes_ms, ops_ms)}
            rows.append(row)
            lib = ("-" if row["library_ms"] is None
                   else f"{row['library_ms']:.4f}")
            print(f"time {name:22s} {str(shape):32s} x{counter[shape]:<3d} "
                  f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f}"
                  f"  library {lib}  bound {row['bound_ms']:.4f}",
                  flush=True)
    return rows


def device_trace(run, out_dir, n, file_name):
    """torch.profiler over ``n`` back-to-back calls of ``run``: device time
    per call by kernel family, and the share of the window in which no
    kernel ran. Kernel spans come from the exported Chrome trace, kept in
    ``out_dir`` if given."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(out_dir or tmp) / file_name
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
        family = next((f for frag, f in TRACE_FAMILIES if frag in name),
                      "other: " + name[:60])
        families[family] = families.get(family, 0.0) + (e - s) / n / 1e3
    result = {"calls": n, "window_ms": window / 1e3,
              "device_busy_ms_per_call": busy / n / 1e3,
              "idle_share": 1.0 - busy / window,
              "kernels_per_call": len(spans) / n,
              "ms_per_call_by_kernel": dict(sorted(
                  families.items(), key=lambda kv: -kv[1]))}
    print(f"trace {file_name}: {json.dumps(result)}", flush=True)
    return result


def serve(cfg, out_dir):
    """Phase 4: serving. Returns launches and metrics."""
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
        added = {k: kernels.launches[k] - before[k] for k in before
                 if kernels.launches[k] != before[k] or k in per_forward}
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
    with torch.inference_mode():
        trace = device_trace(lambda: model(x), out_dir, 5,
                             "forward_trace.json")
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


def _train_state(model_cfg, device):
    """converged256's four networks (f32 masters) with fresh Adam."""
    from cyclegan_tpu_torch.config import yaml2namespace
    from cyclegan_tpu_torch.steps import build_models, init_train_state
    from cyclegan_tpu_torch.utils.checkpoint import load_pytree
    from cyclegan_tpu_torch.weights import (load_jax_params,
                                            models_to_jax_params)

    models = build_models(model_cfg)
    restored = load_pytree(MODEL_DIR / "checkpoint.npz",
                           {"params": models_to_jax_params(models)})
    load_jax_params(models, restored["params"])
    return init_train_state(models, yaml2namespace(TRAIN_CONFIG), 0, device)


def _flat_grads(state):
    """{network: all its gradients as one f32 CPU vector}."""
    return {name: torch.cat([p.grad.detach().float().reshape(-1).cpu()
                             for p in model.parameters()])
            for name, model in state.models.items()}


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def train(model_cfg, out_dir):
    """Phase 5: training. Returns launches and metrics."""
    from cyclegan_tpu_torch import kernels
    from cyclegan_tpu_torch.data.augment import (normalize,
                                                 random_jitter_batch)
    from cyclegan_tpu_torch.steps import make_train_step

    def jitter(generator, a, b):
        return (random_jitter_batch(generator, a, SIZE),
                random_jitter_batch(generator, b, SIZE))

    plan = {k: len(v) for k, v in train_launches(model_cfg, BATCH,
                                                 SIZE).items()}
    noise = torch.Generator(device=DEVICE).manual_seed(0)
    batch = [torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=noise,
                           dtype=torch.uint8, device=DEVICE)
             for _ in range(2)]
    state = _train_state(model_cfg, DEVICE)
    start = {name: [p.detach().clone() for p in m.parameters()]
             for name, m in state.models.items()}
    step16 = make_train_step(model_cfg["loss"], model_cfg["loss_weights"],
                             "bfloat16", preprocess=jitter)

    # 5.1: the main path, one bf16 step with the counts zeroed around it
    kernels.reset_launches()
    metrics = step16(state, *batch)
    torch.cuda.synchronize()
    main_launches = dict(kernels.launches)
    print(f"train main path launches {main_launches} in one step (plan "
          f"{plan})", flush=True)
    if main_launches != plan:
        fail(f"train step launches {main_launches}, plan {plan}")

    # 5.2-5.3: gradients of one batch-2 step (no jitter) against the plain
    # f32 step on the CPU
    x = [normalize(t[:GRAD_BATCH]) for t in batch]
    grads = {}
    for device, dtype in (("cpu", "float32"), (DEVICE, "float32"),
                          (DEVICE, "bfloat16"), ("cpu", "bfloat16")):
        s = _train_state(model_cfg, device)
        make_train_step(model_cfg["loss"], model_cfg["loss_weights"],
                        dtype)(s, *(t.to(device) for t in x))
        grads[(device, dtype)] = _flat_grads(s)
    ref = grads[("cpu", "float32")]
    grad_errors = {}
    for name in ref:
        e = {"f32_card_vs_f32_cpu": _rel(grads[(DEVICE, "float32")][name],
                                         ref[name]),
             "bf16_card_vs_f32_cpu": _rel(grads[(DEVICE, "bfloat16")][name],
                                          ref[name]),
             "bf16_cpu_vs_f32_cpu": _rel(grads[("cpu", "bfloat16")][name],
                                         ref[name])}
        grad_errors[name] = e
        print(f"train gradients {name}: {json.dumps(e)}", flush=True)
        if not e["f32_card_vs_f32_cpu"] <= TRAIN_F32_REL:
            fail(f"train {name}: f32 gradient error "
                 f"{e['f32_card_vs_f32_cpu']} > {TRAIN_F32_REL}")
        if not e["bf16_card_vs_f32_cpu"] <= (TRAIN_BF16_RATIO
                                             * e["bf16_cpu_vs_f32_cpu"]):
            fail(f"train {name}: bf16 gradient error "
                 f"{e['bf16_card_vs_f32_cpu']} beyond {TRAIN_BF16_RATIO}x "
                 f"the plain bf16 step's {e['bf16_cpu_vs_f32_cpu']}")

    # 5.4: five bf16 steps: finite losses, every network moves
    losses = [metrics]
    for _ in range(4):
        losses.append(step16(state, *batch))
    losses = [{k: float(v) for k, v in m.items()} for m in losses]
    print(f"train losses {json.dumps(losses)}", flush=True)
    if not all(np.isfinite(v) for m in losses for v in m.values()):
        fail("train: non-finite loss")
    moved = {name: max(float((p.detach() - p0).abs().max())
                       for p, p0 in zip(m.parameters(), start[name]))
             for name, m in state.models.items()}
    print(f"train largest parameter change after 5 steps {moved}")
    if not all(v > 0 for v in moved.values()):
        fail(f"train: a network did not move {moved}")

    # 5.5: throughput as cyclegan_tpu_torch.bench measures it
    for _ in range(2):
        step16(state, *batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS_TIMED):
        step16(state, *batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_STEPS_TIMED
    torch.cuda.reset_peak_memory_stats()
    step16(state, *batch)
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    issue = []  # host time to issue one step, the card idle before
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step16(state, *batch)
        issue.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    trace = device_trace(lambda: step16(state, *batch), out_dir, 3,
                         "train_trace.json")
    result = {"batch": BATCH, "size": SIZE, "compute_dtype": "bfloat16",
              "step_ms": step_s * 1e3, "img_per_s": BATCH / step_s,
              "peak_mib": peak_mib,
              "host_issue_ms_median": statistics.median(issue) * 1e3,
              "gradient_errors": grad_errors, "losses": losses,
              "trace": trace}
    print(f"train batch {BATCH}: {result['img_per_s']:.2f} img/s "
          f"({result['step_ms']:.1f} ms per step), peak "
          f"{peak_mib:.0f} MiB, host issue "
          f"{result['host_issue_ms_median']:.1f} ms", flush=True)
    return main_launches, result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=None,
                        help="directory for per-launch details and the "
                             "profiler traces")
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

    model_cfg = yaml2namespace(MODEL_DIR / "model_config.yaml")
    serve_plan = generator_launches(model_cfg.generator, BATCH, SIZE)
    if {k: len(v) for k, v in serve_plan.items()} != {
            "conv_same": 15, "instance_norm_act": 14, "sum2x2": 3,
            "concat_up2": 3}:
        fail(f"generator launch plan {serve_plan}")
    shapes = unique_shapes(train_launches(model_cfg, BATCH, SIZE))
    max_err = check_kernels(shapes)
    rows = time_kernels(shapes)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    serve_launches, n_forwards, serving = serve(model_cfg.generator, out_dir)
    train_launches_run, training = train(model_cfg, out_dir)

    serve_shapes = {name: collections.Counter(
        s + ((tf_pad(s[4]),) if name == "conv_same" else ()) for s in v)
        for name, v in serve_plan.items()}
    entries = []
    for name in kernels.KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        per_step = lambda key: sum(r[key] * r["per_step"]  # noqa: E731
                                   for r in mine)
        source, replaces, also = SOURCES[name]
        library = (None if any(r["library_ms"] is None for r in mine)
                   else per_step("library_ms"))
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "also_replaces": also,
            "launches": train_launches_run[name],
            "max_abs_err": max_err[(name, torch.bfloat16)],
            "max_abs_err_f32": max_err[(name, torch.float32)],
            "ms": per_step("ms"),
            "plain_ms": per_step("plain_ms"),
            "bound_ms": per_step("bound_ms"),
            "bound_by": ("operations" if per_step("ops_ms")
                         > per_step("bytes_ms") else "bytes"),
            "library_ms": library,
            "timing": "bf16, sum over one batch-8 256x256 train step's "
                      "launches of the median per launch shape",
        }
        if name in serve_shapes:
            rows_by_shape = {tuple(r["shape"]): r for r in mine}
            served = [(rows_by_shape[s], n)
                      for s, n in serve_shapes[name].items()]
            entry["serve"] = {
                "launches": serve_launches[name], "forwards": n_forwards,
                "launches_per_forward": sum(n for _, n in served),
                **{key: sum(r[key] * n for r, n in served)
                   for key in ("ms", "plain_ms", "bound_ms",
                               "library_ms")}}
        entries.append(entry)
        if train_launches_run[name] == 0:
            fail(f"{name}: no launch on the train step")
    if out_dir is not None:
        (out_dir / "chip_smoke_detail.json").write_text(json.dumps(
            {"card": card, "kernels": entries, "launch_rows": rows,
             "serving": serving, "training": training}, indent=1))
    print(json.dumps({"serving": {k: v for k, v in serving.items()
                                  if k != "quality"}}))
    print(json.dumps({"training": {k: v for k, v in training.items()
                                   if k != "losses"}}))
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
