#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--out DIR]

from the root of the repository, on a machine with a CUDA card and nvcc.
It needs no network and writes only the kernel build
(``cyclegan_tpu_torch/kernels/build``), temporary model and data folders,
and, with ``--out``, the per-launch details (``chip_smoke_detail.json``)
and profiler traces of each serving forward and train step
(``*_trace.json``) into DIR.
Five recipes at full width and depth, 256x256, batch 8 (the fifth at its
own batch 4): the default U-Net recipe (``configs/cycle.yaml`` =
converged256), the canonical ResNet recipe (``configs/resnet.yaml``:
ResNet-9 generator, filters 32, PatchGAN 64/128/256), the
transpose-expansion U-Nets (``configs/unet_transpose.yaml``), the strided
U-Net generator with the default U-Net discriminator
(``configs/strided_unet.yaml``) and the default U-Net generator with
PatchGAN discriminators (``configs/unet_patchgan.yaml``). Phases, each
failing the run if it fails:

1. the card (``nvidia-smi`` name and power limit) and the build of the
   CUDA kernels from ``cyclegan_tpu_torch/kernels/csrc``; ``cuobjdump
   -sass`` of the built ``conv_dw`` library must hold wgmma (``HGMMA``) and
   TMA load (``UTMALDG``) instructions, that of ``conv_same`` wgmma;
2. every kernel against its plain PyTorch version on the card, at every
   unique launch shape of one train step of each recipe (their generator
   forwards are the serving forwards' launches), in bf16 and f32, with
   TF32 off: K1-K4, K1 at the input gradient's pad and on the reflect
   conv's padded dY, K2's mu and rstd, K2 and K6 with and without
   gamma/beta and with ReLU, none and LeakyReLU, K5-K8, the reflect
   conv's K9, K9-dW and K10, the channel concat K11 and its split K12, and
   the NHWC instance norm K13 (with its mean and rstd) at every norm of
   the NHWC train steps of phases 12-13, affine and not; bf16 K5 and K9-dW
   must run their TMA design there, and ``conv_dw_simt`` (their CUDA-core
   design, which f32 runs) is held at the same shapes in bf16 too; bf16 K1
   and K9 must run their tensor-core design, and ``conv_same_simt`` (their
   CUDA-core design, which f32 runs) is held at every K1 and K9 shape in
   bf16 too (K1 at pad p and grow p is the reflect conv's input gradient,
   which writes dY's zero pad itself); then K1, K9 and ``conv_same_simt``
   at ``EDGE_CONV_SHAPES``, beyond the plans, where the tensor-core design
   cuts the K tap rows into runs or tiles N; then K2 and K6 at
   ``EDGE_NORM_SHAPES`` (a ragged W, planes split over a cluster, a launch
   of one plane, a plane past the on-chip budget that streams); every bf16
   K2, K6 and K13 case runs twice and must give bit-identical outputs;
   then K4 and K8 at ``EDGE_JUNCTION_SHAPES``, K7 at ``EDGE_DUP_SHAPES``,
   K10 at ``EDGE_FOLD_SHAPES`` and K3 at ``EDGE_POOL_SHAPES`` (odd channel
   counts, an odd C w, both halos on every row, p = 0, every unaligned
   source offset, inputs one element off alignment); each K3, K4, K7, K8
   and K10 case must take the path (16- or 8-byte units, or one element a
   unit) its geometry gives, and both paths must run in both dtypes; then
   K13 at ``EDGE_NHWC_NORM_SHAPES`` (C of no whole vector, clusters, a
   tile past the on-chip budget, one sample), each case on the path its
   geometry gives (resident, streamed or element), all three in both
   dtypes;
3. each kernel's time at those shapes (CUDA events, median after warm-up)
   beside its plain version, one PyTorch library call for the same
   function where there is one, and the least time the card could take,
   with the share of that bound the kernel reaches and whether the launch's
   bytes fit the 50 MB L2 (the timing repeats the same inputs without a
   flush, so such a launch may read from L2 and pass the HBM bound); K3,
   K4, K7, K8, K10 and K13 also beside a ``copy_`` of the launch's bytes
   (``copy_ms``), the floor of a launch that only moves data;
   the CUDA-core designs ``conv_dw_simt`` and ``conv_same_simt`` timed in
   bf16 on the launches of K5/K9-dW and K1/K9;
4. U-Net serving: ``InferenceSession`` on converged256, bf16, on the card,
   answers batch-8 and batch-1 requests in both directions; each forward
   must launch 15/14/3/3 conv/norm/pool/junction kernels (no
   ``conv_same_simt`` launch), and the outputs
   are held against the plain f32 session on the CPU. Then serving img/s;
5. U-Net training, from converged256's four networks with fresh Adam: one
   bf16 step at batch 8 (jitter inside) whose launches of every kernel
   equal the plan ``train_launches`` derives from the configs; the f32
   gradients of a batch-2 step on the card against the plain f32 step on
   the CPU; the bf16 card step's gradient error against the CPU bf16
   step's; five bf16 steps with finite losses that move every network;
   then train-step img/s, peak memory, host issue time and a profiler
   trace of 3 steps; a ``conv_dw_simt`` or ``conv_same_simt`` launch in the
   bf16 step fails it;
6. ResNet training, as phase 5 from seeded random weights, against the
   plan ``resnet_train_launches``; its f32 gradients are compared at
   ``RESNET_F32_POINT`` (full width and depth, batch 1 at 16x16, a seed
   where no ReLU or LeakyReLU input of the CPU step lies within
   ``KINK_MARGIN`` of zero, asserted) with TF32 on, PyTorch's default, so
   that the check covers the port turning it off for its library convs;
7. ResNet serving: the networks phase 6 trained, saved by the port into a
   model folder, served as phase 4 (20 reflect-conv and 23 norm launches
   per forward);
8. transpose-expansion U-Net training, as phase 6 against the plan
   ``train_launches`` derives (K11 and K12 30 each per step), its f32
   gradients compared at ``UNET_F32_POINT`` (batch 1 at 32x32, every
   affine norm's beta at +-(3..4), kink-free, asserted);
9. its serving, as phase 7 (15/17/3/3 conv/norm/pool/concat launches per
   forward);
10. strided U-Net training, as phase 8 (K11 and K12 18 each per step, the
    discriminators' K4 and K8 12 each);
11. its serving, as phase 7 (6 norm and 3 concat launches per forward);
12. U-Net training in the NHWC layout with ``pallas_norm``, as phase 5:
    library convolutions (cuDNN), every instance norm on K13 (144 launches
    per step, ``nhwc_train_launches``) and no launch of K1-K12, its f32
    gradients at ``UNET_NHWC_F32_POINT`` (converged256 with every beta at
    +-(3..4), batch 1 at 32x32, kink-free, asserted);
13. ResNet training in the NHWC layout with ``pallas_norm``, as phase 6
    (156 K13 launches per step), its f32 gradients at ``RESNET_F32_POINT``;
14. the trainer through its CLI (``cyclegan_tpu_torch.train.main``) on
    TFRecords the port writes (seeded uint8 images, ``CLI_IMAGES`` per
    domain): ``configs/cycle.yaml`` at batch 8, two epochs in NHWC with
    ``pallas_norm`` (K13 only), a reload that must give back the saved
    parameters, Adam moments, step and generator, one more epoch from the
    checkpoint (the step and ``current_epoch`` carry on), then one epoch
    with ``tpu_layout: auto``, which is NHCW on the card (K1-K8, no K13);
15. the fifth recipe, ``configs/unet_patchgan.yaml`` (the default U-Net
    generator, PatchGAN 64/128/256 discriminators), as phase 6 at its own
    batch 4 (``PATCHGAN_BATCH``) against ``train_launches``' plan (the
    generator's and ``_patchgan_apps``'), its f32 gradients at
    ``UNET_PATCHGAN_F32_POINT``, then served from the folder it saves, as
    phase 7;
16. the default recipe's step options (``unet_options``): ``fuse_apps``
    (4 generator applications, two at batch 16: its own plan; f32
    gradients against the unfused step within ``FUSED_F32_REL`` at
    ``UNET_F32_POINT``; both timed), ``remat`` (the plan plus each
    generator forward again; its gradients against the plain step's;
    peak memory below the plain step's, asserted) and dropout in the
    generators (the plain plan, five finite steps that move every
    network, a training-mode forward with drawn masks against the CPU's);
17. the ResNet recipe with ``fuse_apps`` (``resnet_fuse_apps``): its plan,
    and both ways timed;
18. the paired step (``paired``), NHWC, with and without ``pallas_norm``:
    K13 as the NHWC plan or no kernel at all, every vmapped convolution
    through ``LibraryConv``'s batching rule and every vmapped norm
    through K13's (counted), its gradients against the unpaired step's at
    ``UNET_NHWC_F32_POINT`` (f32 within TRAIN_F32_REL, bf16 within RATIO
    times the unpaired step's error), both ways timed;
19. the trainer CLI on phase 14's records (``trainer_options``):
    ``steps_per_call`` 3 over 4 batches (a chunk and a ragged single
    step), ``profile_dir`` (a non-empty Chrome trace), AdaBelief
    generators and RMSprop discriminators, NHCW; a reload that gives back
    every optimizer slot, the step and both generators exactly, and one
    more epoch from the checkpoint.

Phase 2 checks, and phase 3 times, every unique launch shape of every
plan, the option phases' batch-16 and batch-4 shapes included.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the kernels' numbers as JSON.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import json
import math
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
RESNET_CONFIG = ROOT / "configs" / "resnet.yaml"
TRANSPOSE_CONFIG = ROOT / "configs" / "unet_transpose.yaml"
STRIDED_CONFIG = ROOT / "configs" / "strided_unet.yaml"
PATCHGAN_CONFIG = ROOT / "configs" / "unet_patchgan.yaml"
PATCHGAN_BATCH = 4       # the recipe's own batch (its header)
DEVICE = "cuda"
BATCH = 8
SIZE = 256
GRAD_BATCH = 2           # the card-vs-CPU gradient comparison
CLI_IMAGES = 40          # per domain: 32 train and 8 validation images
TIMED_REPS = 20
TRAIN_STEPS_TIMED = 10
ALT_ROUNDS = 4           # option phases: rounds of steps, the ways in turn
ALT_STEPS = 4

# H100 SXM published peaks (dense): HBM bytes/s and operations/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
L2_BYTES = 50e6

# Kernel vs plain version on the card: |got - want| <= rtol |want| + atol s,
# per output, with s the output's scale (1 unless stated). conv and norm sum
# in f32 in another order and round once: in bf16 they may land one bf16
# step apart (2^-8 relative), in f32 a few ulps of a sum of up to 3072
# terms. K2's statistics are f32 sums of up to 65,536 terms. conv_dw returns
# f32 sums of up to 524,288 products in both types: its scale is
# s = sum |x| |g| over the same terms. K6's dx and t1, t2 take the largest
# |value| of each output as s (its relu decision is made on the same f32
# v = gamma xhat + beta in both, so no element flips). The pool, its
# gradient, the junction's copy and adds and the concat and split copies
# are in the same order: exact.
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
    ("conv_reflect", torch.bfloat16): (1e-2, 1e-2),
    ("conv_reflect", torch.float32): (1e-4, 1e-4),
    ("conv_reflect_dw", torch.bfloat16): (0.0, 1e-5),
    ("conv_reflect_dw", torch.float32): (0.0, 1e-5),
    ("conv_dw_simt", torch.bfloat16): (0.0, 1e-5),
    ("conv_dw_simt", torch.float32): (0.0, 1e-5),
    ("conv_same_simt", torch.bfloat16): (1e-2, 1e-2),
    ("conv_same_simt", torch.float32): (1e-4, 1e-4),
    ("reflect_fold", torch.bfloat16): (0.0, 0.0),
    ("reflect_fold", torch.float32): (0.0, 0.0),
    ("concat2", torch.bfloat16): (0.0, 0.0),
    ("concat2", torch.float32): (0.0, 0.0),
    ("split2", torch.bfloat16): (0.0, 0.0),
    ("split2", torch.float32): (0.0, 0.0),
    ("instance_norm_nhwc", torch.bfloat16): (1e-2, 1e-2),
    ("instance_norm_nhwc", torch.float32): (1e-4, 1e-4),
    ("instance_norm_nhwc.stats", torch.bfloat16): (1e-4, 1e-5),
    ("instance_norm_nhwc.stats", torch.float32): (1e-4, 1e-5),
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
    "conv_reflect": (_CSRC + "conv_same.cu",
                     "cyclegan_tpu/ops/pallas_conv.py:1130", []),
    "conv_reflect_dw": (_CSRC + "conv_dw.cu",
                        "cyclegan_tpu/ops/pallas_conv.py:1130", []),
    "reflect_fold": (_CSRC + "reflect_fold.cu",
                     "cyclegan_tpu/ops/pallas_conv.py:1130", []),
    "concat2": (_CSRC + "concat2.cu",
                "cyclegan_tpu/ops/pallas_concat.py:106", []),
    "split2": (_CSRC + "concat2.cu",
               "cyclegan_tpu/ops/pallas_concat.py:140", []),
    "instance_norm_nhwc": (_CSRC + "instance_norm_nhwc.cu",
                           "cyclegan_tpu/ops/pallas_norm.py:120", []),
    "conv_dw_simt": (_CSRC + "conv_dw.cu",
                     "cyclegan_tpu/ops/pallas_conv.py:686",
                     ["cyclegan_tpu/ops/pallas_conv.py:991",
                      "cyclegan_tpu/ops/pallas_conv.py:1130"]),
    "conv_same_simt": (_CSRC + "conv_same.cu",
                       "cyclegan_tpu/ops/pallas_conv.py:479",
                       ["cyclegan_tpu/ops/pallas_conv.py:924",
                        "cyclegan_tpu/ops/pallas_conv.py:1130"]),
}
# what a library yardstick is where it is not one call
LIBRARY_NOTES = {
    "split2": "two calls: g[:, :, :c1].contiguous() and "
              "g[:, :, c1:].contiguous(), timed together",
    "split_pool2": "two calls: g[:, :, :c1].contiguous() and "
                   "aten.upsample_nearest2d_backward on the NCHW view of "
                   "g[:, :, c1:], timed together",
}
# K5's and K9-dW's CUDA-core design, timed in bf16 on the launches of
# conv_dw and conv_reflect_dw (a shape with pad -1 is a conv_reflect_dw
# launch): what the PR 2/3 design takes in the same run
SIMT = "conv_dw_simt"
# K1's and K9's CUDA-core design, timed in bf16 on the launches of
# conv_same and conv_reflect (a shape with pad -1 is a conv_reflect
# launch): what the first design of K1 and K9 takes in the same run
SIMT_SAME = "conv_same_simt"
# kernels whose bf16 outputs phase 2 requires bit-identical run to run
DETERMINISTIC = ("instance_norm_act", "instance_norm_act_bwd",
                 "instance_norm_nhwc")
# kernel-name fragments of the profiler trace -> kernel family
TRACE_FAMILIES = (
    ("conv_same_tc_kernel", "conv_same"), ("conv_same_pack_kernel", "conv_same"),
    ("conv_reflect_tc_kernel", "conv_reflect"),
    ("conv_reflect_pack_kernel", "conv_reflect"),
    ("conv_same_simt_kernel", SIMT_SAME),
    ("conv_reflect_simt_kernel", SIMT_SAME),
    ("conv_reflect_dw_tma_kernel", "conv_reflect_dw"),
    ("reflect_dw_shift_copies_kernel", "conv_reflect_dw"),
    ("reflect_sum_splits_kernel", "conv_reflect_dw"),
    ("conv_reflect_dw_partial_kernel", SIMT),
    ("reflect_fold_kernel", "reflect_fold"),
    ("conv_dw_tma_kernel", "conv_dw"), ("dw_shift_copies_kernel", "conv_dw"),
    ("conv_dw_partial_kernel", SIMT), ("sum_splits_kernel", "conv_dw"),
    ("norm_act_bwd_kernel", "instance_norm_act_bwd"),
    ("norm_act_kernel", "instance_norm_act"),
    ("sum2x2_kernel", "sum2x2"), ("dup2x2_kernel", "dup2x2"),
    ("concat_up2_kernel", "concat_up2"),
    ("split_pool2_kernel", "split_pool2"),
    ("concat2_kernel", "concat2"), ("split2_kernel", "split2"),
    ("instance_norm_nhwc_kernel", "instance_norm_nhwc"),
    ("partial_sums_kernel", "instance_norm_nhwc"),
    ("normalize_kernel", "instance_norm_nhwc"),
    # the library convolutions (stride 2, transposed) of the ResNet recipe
    # and the transpose-expansion and strided U-Nets
    ("cudnn", "library conv"), ("xmma", "library conv"),
    ("cutlass", "library conv"), ("grad", "library conv"),
    ("conv", "library conv"),
)
# serving: card bf16 output vs the plain f32 session, in uint8 steps: the
# mean, the share of pixels more than SERVE_FAR off and the worst pixel
# each within the absolute bound, or within RATIO times the plain bf16
# session's own where that is larger (the plain bf16 ResNet session is
# itself about half a step off on average: bf16 rounding through 20 convs
# and 23 norms)
SERVE_MEAN_MAX = 0.5
SERVE_FAR = 8            # a pixel this far off counts as an outlier...
SERVE_FAR_SHARE = 1e-3   # ...and at most this share of them may be
SERVE_F32_MAX = 1
# training: per network, |g_card - g_cpu| / |g_cpu| in f32 within
# TRAIN_F32_REL over every parameter but the pre-norm biases, and each
# pre-norm bias's largest |g_card - g_cpu| within TRAIN_F32_REL |g_cpu| of
# the whole network (its gradient is zero up to rounding, see
# ``pre_norm_bias``); the bf16 card step's error within RATIO times the
# plain bf16 step's
TRAIN_F32_REL = 1e-3
RATIO = 1.5
# The ResNet's f32 comparison point: seeded weights and input, batch 1 at
# 16x16. Every norm of the recipe is non-affine, so its ReLU and LeakyReLU
# inputs straddle zero in every channel; two f32 implementations may put an
# input within rounding of a kink on either side, and one such flip moves a
# gradient by more than TRAIN_F32_REL. At 256x256 there are millions of
# them; at this point none lies within KINK_MARGIN (asserted).
RESNET_F32_POINT = {"size": 16, "batch": 1, "seed": 354}
# The transpose-expansion and strided U-Nets' f32 point: seeded weights
# with every affine norm's beta moved to +-(3..4), so that whole channels
# sit on either side of the ReLU kink (as the CPU step tests of the default
# recipe do), and seeded input, batch 1 at 32x32; no ReLU input within
# KINK_MARGIN of zero (asserted).
UNET_F32_POINT = {"size": 32, "batch": 1, "seed": 0, "beta": [3.0, 4.0]}
# The NHWC U-Net's f32 point (phase 12), converged256 with the betas moved
# likewise: at batch 2, 256² the cuDNN step on an H100 put d_A 1.09e-3
# from the CPU's (kinks), and seed 0 leaves a ReLU input only 1.5e-5 from
# its kink in NHWC, seed 2 1.5e-4.
UNET_NHWC_F32_POINT = {"size": 32, "batch": 1, "seed": 2, "beta": [3.0, 4.0]}
# The unet_patchgan recipe's f32 point (phase 15): seeded weights with the
# U-Net's betas moved likewise, batch 1 at 16x16; its PatchGAN norms are
# non-affine, and seed 4 leaves no ReLU or LeakyReLU input within 1.3e-4
# of its kink on the CPU (seeds 0-11 searched; 3 and 10 come within 1e-5).
UNET_PATCHGAN_F32_POINT = {"size": 16, "batch": 1, "seed": 4,
                           "beta": [3.0, 4.0]}
KINK_MARGIN = 1e-5
# fuse_apps on the card (phase 16): the fused step's f32 gradients against
# the unfused step's; the same math, with the batch sums of the fused
# applications' weight gradients in another order
FUSED_F32_REL = 1e-5
# Phase 2's K1 and K9 shapes beyond the plans, as the plans key them: two
# stages of all K*K taps' weights do not fit 227 KB (k7 32->128, k4
# 64->256), so the tensor-core design runs the tap rows in shorter runs; Cout
# past 256 takes two N tiles.
EDGE_CONV_SHAPES = {
    "conv_same": [(2, 64, 32, 128, 7, True, 3), (2, 32, 64, 256, 4, False, 2),
                  (2, 32, 64, 320, 3, True, 1)],
    "conv_reflect": [(2, 64, 32, 128, 7, True)],
}
# Phase 2's K2 and K6 shapes beyond the plans, (B, H, C, act, affine) with
# W = H, as the plans key them (cuda_norm_act.norm_act_geometry): a ragged W
# (one-element slots, streamed, in bf16; 3 slots a row in f32); W = 48 (6
# slots a row) with two planes to a CTA in bf16; eight 16x16 planes to a
# CTA; 15 planes, each split over a cluster (B*C a multiple of no cluster
# size); one plane over a cluster of 8, the whole launch; a plane past the
# on-chip budget, whose CTAs stream their rows
EDGE_NORM_SHAPES = {
    name: [(2, 12, 5, "relu", True), (16, 48, 48, "leaky_relu", True),
           (16, 16, 256, "none", True), (3, 128, 5, "none", False),
           (1, 256, 1, "relu", True), (2, 512, 16, "leaky_relu", False)]
    for name in ("instance_norm_act", "instance_norm_act_bwd")}

# Phase 2's K4 and K8 shapes beyond the plans, (B, H, C1, C2, off) with
# W = H: W/2 = 18 (not a whole 16-byte unit of a channel: the vector path
# holds, as its map needs only whole rows); odd C1 and C2 at W = 34 (rows
# of neither whole 16- nor 8-byte units: the element path); and the inputs
# (K4's skip and x, K8's g) as views one element off an aligned base
# (off = 1: the element path)
EDGE_JUNCTION_SHAPES = {
    name: [(2, 36, 8, 16, 0), (2, 34, 3, 5, 0), (2, 64, 16, 32, 1)]
    for name in ("concat_up2", "split_pool2")}
# Phase 2's K7 shapes beyond the plans, (B, h, C, off) with w = h: an odd
# C w (x rows of no whole 8-byte unit: the element path); w = 9 at C = 8
# (the vector path: units cross channel edges, as the map needs only whole
# rows); and x as a view one element off an aligned base (off = 1: the
# element path)
EDGE_DUP_SHAPES = {"dup2x2": [(2, 17, 3, 0), (2, 9, 8, 0), (2, 32, 16, 1)]}
# Phase 2's K10 shapes beyond the plans, (B, H, C, p, off) with W = H
# (cuda_reflect.reflect_fold_geometry): p = 3 at H = W = 4, every row and
# column with both halos (bf16: W is no whole 16-byte unit, the element
# path); p = 7 at H = W = 8, both halos on most rows and every unit of the
# vector path; the vector path's unaligned source offsets of 2 and 6
# elements (p = 2) and 4 (p = 4) in bf16, which the recipes (odd offsets
# only) do not reach; an odd C at W = 30 (the element path); p = 0, a
# copy; dxp as a view one element off an aligned base (off = 1: the
# element path)
EDGE_FOLD_SHAPES = {
    "reflect_fold": [(2, 4, 16, 3, 0), (2, 8, 16, 7, 0), (2, 32, 8, 2, 0),
                     (2, 16, 8, 4, 0), (2, 30, 5, 2, 0), (2, 16, 8, 0, 0),
                     (2, 32, 16, 1, 1)]}
# Phase 2's K3 shapes beyond the plans, (B, H, C, off) with W = H
# (cuda_resize.sum2x2_geometry): an odd C with an odd W/2 (x rows of no
# whole 16-byte unit: the element path); an odd C whose rows are whole
# units (the vector path: units cross channel edges); W/2 = 10 at C = 8
# (the vector path); x as a view one element off an aligned base (off = 1:
# the element path)
EDGE_POOL_SHAPES = {"sum2x2": [(2, 18, 3, 0), (2, 16, 3, 0), (2, 20, 8, 0),
                               (2, 32, 16, 1)]}
# Phase 2's K13 shapes beyond the plans, (N, H, C, affine) with W = H
# (cuda_norm.instance_norm_nhwc_geometry): C of no whole 16-byte vector
# (one-element slots on the two-launch design), in one row split and in
# 11; a tile of 4 vectors on one CTA, resident; a tile over a cluster of 4
# (bf16) or 8 (f32); one sample's tile over a cluster of 8 (bf16) or 16
# (f32); one sample past the on-chip budget (512x512), streamed in 256
# (bf16) or 512 (f32) row splits; affine on and off
EDGE_NHWC_NORM_SHAPES = {"instance_norm_nhwc": [
    (2, 12, 5, True), (2, 48, 5, False), (2, 8, 256, True),
    (2, 64, 16, False), (1, 128, 8, True), (1, 512, 8, False)]}
# kernels with several paths (``kernels.paths``): phase 2 must run each of
# them, in both dtypes
PATH_KERNELS = {
    **{name: {"vector", "element"} for name in (
        "concat_up2", "reflect_fold", "dup2x2", "split_pool2", "sum2x2")},
    "instance_norm_nhwc": {"resident", "streamed", "element"}}
# kernels that phase 3 times beside a ``copy_`` of the launch's bytes
COPY_FLOOR = ("concat_up2", "reflect_fold", "dup2x2", "split_pool2",
              "sum2x2", "instance_norm_nhwc")

failures = []
# {(kernel, dtype): the paths phase 2 saw it take}
paths_run = collections.defaultdict(set)
STARTED = time.perf_counter()


def stamp(what):
    print(f"{what} done at {time.perf_counter() - STARTED:.0f} s", flush=True)


def fail(msg):
    failures.append(msg)
    print(f"FAIL {msg}", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sass_counts(lib, ops):
    """How many instructions of each of ``ops`` ``cuobjdump -sass`` finds in
    the shared library ``lib``."""
    from cyclegan_tpu_torch.kernels import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    words = [line.split() for line in text.splitlines()]
    return {op: sum(1 for w in words for t in w if t.startswith(op + ".")
                    or t == op) for op in ops}


def tf_pad(k):
    return (k - 1) // 2


def generator_launches(cfg, batch, size):
    """The kernel launches of one forward of a U-Net (``unet_generator`` of
    either expansion, or ``strided_unet``), in order, by kernel: conv (B,
    H, Cin, Cout, K, bias), norm (B, H, C, act, affine), pool (B, H, C),
    junction and concat (B, H, C1, C2) with H the output side. Kernels
    that do not launch are left out. Conv-transposes and stride-2 convs
    are library calls."""
    if cfg["type"] == "strided_unet":
        return strided_launches(cfg, batch, size)
    filters, ks = list(cfg["filters"]), list(cfg["kernels"])
    conv, norm, pool, junction, concat = [], [], [], [], []
    c, s, skips = 3, size, []

    def double_conv(cin, f, k, s):
        for ci in (cin, f):
            conv.append((batch, s, ci, f, k, False))
            norm.append((batch, s, f, "relu", True))

    for f, k in zip(filters[:-1], ks[:-1]):
        double_conv(c, f, k, s)
        skips.append((f, s))
        pool.append((batch, s, f))
        c, s = f, s // 2
    double_conv(c, filters[-1], ks[-1], s)
    c = filters[-1]
    for f, k, (skip_c, skip_s) in zip(filters[::-1][:-1], ks[:0:-1],
                                      skips[::-1]):
        if cfg["expansion"] == "upsample":
            junction.append((batch, skip_s, skip_c, c))
        else:  # conv-transpose to f channels, its norm, then the concat
            c = f
            norm.append((batch, skip_s, f, "relu", True))
            concat.append((batch, skip_s, skip_c, f))
        double_conv(skip_c + c, f, k, skip_s)
        c = f
    conv.append((batch, size, c, int(cfg["output_channels"]), 1, True))
    plan = {"conv_same": conv, "instance_norm_act": norm, "sum2x2": pool,
            "concat_up2": junction, "concat2": concat}
    return {name: shapes for name, shapes in plan.items() if shapes}


def strided_launches(cfg, batch, size):
    """The kernel launches of one ``strided_unet`` forward, in order: a
    norm after each stride-2 down conv; per up level the concat of the skip
    and the conv-transpose's f channels, then a norm over both. Its convs
    are all library calls."""
    filters = list(cfg["filters"])
    norm, concat, skips, s = [], [], [], size
    for f in filters[:-1]:
        s //= 2
        norm.append((batch, s, f, "relu", True))
        skips.append((f, s))
    for f, (skip_c, skip_s) in zip(filters[::-1][:-1], skips[::-1]):
        concat.append((batch, skip_s, skip_c, f))
        norm.append((batch, skip_s, skip_c + f, "relu", True))
    return {"instance_norm_act": norm, "concat2": concat}


def serve_launches(cfg, batch, size):
    """``generator_launches`` with each conv's pad: the serving forward's
    launches as the train plans key them."""
    plan = generator_launches(cfg, batch, size)
    if "conv_same" in plan:
        plan["conv_same"] = [s + (tf_pad(s[4]),) for s in plan["conv_same"]]
    return plan


# each forward kernel of the U-Nets' plans and the kernel of its backward
BACKWARD = {"instance_norm_act": "instance_norm_act_bwd", "sum2x2": "dup2x2",
            "concat_up2": "split_pool2", "concat2": "split2"}


def generator_apps(batch, fuse_apps=False):
    """(batch, input needs a gradient) of each generator application of a
    train step: 6 at ``batch``, the two on the fakes (the cycle) with an
    input gradient; with ``fuse_apps`` 4, the translation and identity
    applications of each generator as one at 2 ``batch``."""
    if fuse_apps:
        return [(2 * batch, False)] * 2 + [(batch, True)] * 2
    return [(batch, False)] * 4 + [(batch, True)] * 2


def _unet_apps(apps, out):
    """Add the launches of U-Net applications ``apps`` ((forward plan,
    parameters train, input needs a gradient)) to ``out``."""
    for plan, params_train, input_grad in apps:
        for i, (b, h, cin, cout, k, bias) in enumerate(
                plan.get("conv_same", [])):
            out["conv_same"].append((b, h, cin, cout, k, bias, tf_pad(k)))
            if i > 0 or input_grad:
                out["conv_same"].append(
                    (b, h, cout, cin, k, False, k - 1 - tf_pad(k)))
            if params_train:
                out["conv_dw"].append((b, h, cin, cout, k, tf_pad(k)))
        for name, shapes in plan.items():
            if name == "conv_same":
                continue
            out[name] += shapes
            out[BACKWARD[name]] += ([(b, h // 2, c) for b, h, c in shapes]
                                    if name == "sum2x2" else shapes)


def _patchgan_apps(disc, out):
    """Add the launches of the 6 PatchGAN applications of a train step
    (``disc``: one forward's plan) to ``out``: its 1x1 head on K1 forward
    and dX in every application, K5 where the parameters train (not the
    2 generator views); every norm and its backward."""
    for params_train in [True] * 4 + [False] * 2:
        for b, h, cin, cout, k, bias in disc["conv_same"]:
            out["conv_same"].append((b, h, cin, cout, k, bias, 0))
            out["conv_same"].append((b, h, cout, cin, k, False, 0))
            if params_train:
                out["conv_dw"].append((b, h, cin, cout, k, 0))
        out["instance_norm_act"] += disc["instance_norm_act"]
        out["instance_norm_act_bwd"] += disc["instance_norm_act"]


def train_launches(model_cfg, batch, size, fuse_apps=False):
    """The kernel launches of one train step (``steps.make_train_step``)
    of a recipe of U-Net generators (the default, ``unet_patchgan``,
    ``configs/unet_transpose.yaml``, ``configs/strided_unet.yaml``), by
    kernel, as unordered lists of shapes:

    conv_same (B, H, Cin, Cout, K, bias, pad), conv_dw (B, H, Cin, Cout, K,
    pad), instance_norm_act[_bwd] (B, H, C, act, affine), sum2x2 (B, H, C)
    with H the input side, dup2x2 (B, h, C) with h the pooled side,
    concat_up2, split_pool2, concat2 and split2 (B, H, C1, C2).

    Forward: the generator applications of ``generator_apps`` (6, or 4
    with ``fuse_apps``) and 6 discriminator applications (each fake
    batch's generator view and discriminator view are two applications).
    Backward, per application: K6 for every norm, K7 for every pool, K8 for
    every junction, K12 for every concat; K5 (dW) for every conv where the
    parameters train (not under the generator view); K1 at the transposed
    pad (dX) for every conv but the first, and for the first where the
    input needs a gradient: the generators applied to the fakes (the
    cycle) and the discriminators' generator view. A PatchGAN
    discriminator's launches are ``_patchgan_apps``'."""
    apps = [(generator_launches(model_cfg["generator"], b, size), True,
             input_grad)
            for b, input_grad in generator_apps(batch, fuse_apps)]
    out = collections.defaultdict(list)
    disc_cfg = model_cfg["discriminator"]
    if disc_cfg["type"] == "simple_discriminator":
        _patchgan_apps(patchgan_launches(disc_cfg, batch, size), out)
    else:
        disc = generator_launches(disc_cfg, batch, size)
        apps += [(disc, True, False)] * 4 + [(disc, False, True)] * 2
    _unet_apps(apps, out)
    return dict(out)


def remat_launches(model_cfg, batch, size):
    """``train_launches`` of the default recipe's step with ``remat``:
    each of the 6 generator applications runs its forward again in the
    backward (``serve_launches``, keyed as the train plans)."""
    out = collections.defaultdict(list, train_launches(model_cfg, batch,
                                                       size))
    forward = serve_launches(model_cfg["generator"], batch, size)
    for name, shapes in forward.items():
        out[name] += shapes * 6
    return dict(out)


RESNET_KERNELS = ("conv_reflect", "conv_reflect_dw", "reflect_fold",
                  "conv_same", "conv_dw", "instance_norm_act",
                  "instance_norm_act_bwd")


def resnet_generator_launches(cfg, batch, size):
    """The kernel launches of one forward of the ResNet generator, in
    order: reflect conv (B, H, Cin, Cout, K, bias) and norm (B, H, C, act,
    affine). Its stride-2 and transposed convs are library calls."""
    f = int(cfg["filters"])
    s4 = size // 4
    conv = ([(batch, size, 3, f, 7, True)]
            + [(batch, s4, 4 * f, 4 * f, 3, True)] * 18
            + [(batch, size, f, 3, 7, True)])
    norm = ([(batch, size, f, "relu", False),
             (batch, size // 2, 2 * f, "relu", False),
             (batch, s4, 4 * f, "relu", False)]
            + [(batch, s4, 4 * f, "relu", False),
               (batch, s4, 4 * f, "none", False)] * 9
            + [(batch, size // 2, 2 * f, "relu", False),
               (batch, size, f, "relu", False)])
    return {"conv_reflect": conv, "instance_norm_act": norm}


def patchgan_launches(cfg, batch, size):
    """The kernel launches of one PatchGAN forward: a norm with
    LeakyReLU(0.2) after each stride-2 (library) conv, then the 1x1 head
    on K1, (B, H, Cin, Cout, K, bias) with H the side it runs at."""
    norm, s = [], size
    for f in cfg["filters"]:
        s //= 2
        norm.append((batch, s, int(f), "leaky_relu", False))
    head = [(batch, s, int(cfg["filters"][-1]), 1, 1, True)]
    return {"conv_same": head, "instance_norm_act": norm}


def resnet_train_launches(model_cfg, batch, size, fuse_apps=False):
    """The kernel launches of one train step of the ResNet recipe, by
    kernel, as unordered lists of shapes: conv_reflect (B, H, Cin, Cout,
    K, bias), conv_reflect_dw (B, H, Cin, Cout, K), reflect_fold (B, H, C,
    p) with H the folded side, and conv_same, conv_dw, instance_norm_act
    and its backward as ``train_launches`` gives them.

    Applications as there (the generator's of ``generator_apps``, 6
    discriminators). Every reflect conv runs K9 and, where the parameters
    train (every generator application), K9-dW; its input gradient, for
    every conv but the first and for the first where the input needs a
    gradient, is K1 on dY at pad p and grow p (B, H, Cout, Cin, K, False,
    p, p: output side H + 2p, channels Cin) and then K10.
    The PatchGAN's head is K1 (K = 1) forward and dX in every application,
    K5 where the parameters train."""
    out = collections.defaultdict(list)
    for b, input_grad in generator_apps(batch, fuse_apps):
        gen = resnet_generator_launches(model_cfg["generator"], b, size)
        for i, (b, h, cin, cout, k, bias) in enumerate(gen["conv_reflect"]):
            p = k // 2
            out["conv_reflect"].append((b, h, cin, cout, k, bias))
            out["conv_reflect_dw"].append((b, h, cin, cout, k))
            if i > 0 or input_grad:
                out["conv_same"].append((b, h, cout, cin, k, False, p, p))
                out["reflect_fold"].append((b, h, cin, p))
        out["instance_norm_act"] += gen["instance_norm_act"]
        out["instance_norm_act_bwd"] += gen["instance_norm_act"]
    _patchgan_apps(patchgan_launches(model_cfg["discriminator"], batch,
                                     size), out)
    return {name: out[name] for name in RESNET_KERNELS}


def forward_norms(cfg, batch, size):
    """The instance norms of one forward of any network, in order, as
    (B, H, C, affine)."""
    if cfg["type"] == "resnet_generator":
        plan = resnet_generator_launches(cfg, batch, size)
    elif cfg["type"] == "simple_discriminator":
        plan = patchgan_launches(cfg, batch, size)
    else:
        plan = generator_launches(cfg, batch, size)
    return [(b, h, c, affine)
            for b, h, c, _, affine in plan.get("instance_norm_act", [])]


def nhwc_train_launches(model_cfg, batch, size):
    """The kernel launches of one NHWC train step with ``pallas_norm``
    (``make_train_step(tpu_layout=False, pallas_norm=True)``): K13, one
    per instance norm of each of the 6 generator and 6 discriminator
    applications, (B, H, C, affine). Its backward is torch ops and its
    convolutions are the library's: nothing else launches."""
    return {"instance_norm_nhwc":
            forward_norms(model_cfg["generator"], batch, size) * 6
            + forward_norms(model_cfg["discriminator"], batch, size) * 6}


def make_case(name, shape, dtype, seed):
    """Inputs of one launch, made on the card from a seed. Returns
    (kernel call, plain call, library call or None, bytes, operations,
    checks): both calls return a tuple of outputs, and checks names each
    output's tolerance key and scale."""
    from cyclegan_tpu_torch.ops import (cuda_concat, cuda_conv, cuda_norm,
                                        cuda_norm_act, cuda_reflect,
                                        cuda_resize)

    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def rnd(*s, scale=1.0, offset=0.0):
        return (offset + scale * torch.randn(s, generator=g, device=DEVICE,
                                             dtype=torch.float32)).to(dtype)

    size = torch.finfo(dtype).bits // 8
    nchw = lambda t: t.permute(0, 2, 1, 3)  # noqa: E731
    if name == "conv_same" or (name == SIMT_SAME and shape[6] >= 0):
        B, H, cin, cout, k, has_bias, pad = shape[:7]
        grow = shape[7] if len(shape) > 7 else 0
        ho = H + 2 * grow
        x = rnd(B, H, cin, H)
        w = rnd(k, k, cin, cout, scale=0.05)
        b = rnd(cout, scale=0.5) if has_bias else None
        before, after = pad + grow, k - 1 - pad + grow
        xp = F.pad(nchw(x), (before, after, before, after))
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        nbytes = (x.numel() + w.numel() + (cout if has_bias else 0)
                  + B * ho * cout * ho) * size
        kernel = (cuda_conv.conv_same_cuda if name == "conv_same"
                  else cuda_conv.conv_same_simt_cuda)
        return (lambda: (kernel(x, w, b, pad=pad, grow=grow),),
                lambda: (cuda_conv.conv_same_plain(x, w, b, pad=pad,
                                                   grow=grow),),
                lambda: F.conv2d(xp, w_oihw, b),
                nbytes, 2 * B * ho * ho * k * k * cin * cout,
                [(name, 1.0)])
    if name == "conv_dw" or (name == SIMT and shape[5] >= 0):
        B, H, cin, cout, k, pad = shape
        x = rnd(B, H, cin, H)
        gy = rnd(B, H, cout, H)
        xp = F.pad(nchw(x), (pad, k - 1 - pad, pad, k - 1 - pad))
        gy_nchw = nchw(gy)
        scale = cuda_conv.conv_dw_plain(x.abs(), gy.abs(), k, pad)
        kernel = (cuda_conv.conv_dw_cuda if name == "conv_dw"
                  else cuda_conv.conv_dw_simt_cuda)
        return (lambda: (kernel(x, gy, k, pad),),
                lambda: (cuda_conv.conv_dw_plain(x, gy, k, pad),),
                lambda: torch.nn.grad.conv2d_weight(
                    xp, (cout, cin, k, k), gy_nchw),
                (x.numel() + gy.numel()) * size + k * k * cin * cout * 4,
                2 * B * H * H * k * k * cin * cout, [(name, scale)])
    if name in ("conv_reflect", SIMT_SAME):
        B, H, cin, cout, k, has_bias = shape[:6]
        x = rnd(B, H, cin, H)
        w = rnd(k, k, cin, cout, scale=0.05)
        b = rnd(cout, scale=0.5) if has_bias else None
        xp = F.pad(nchw(x), (k // 2,) * 4, mode="reflect")
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        nbytes = (x.numel() + w.numel() + (cout if has_bias else 0)
                  + B * H * cout * H) * size
        kernel = (cuda_reflect.conv_reflect_cuda if name == "conv_reflect"
                  else cuda_reflect.conv_reflect_simt_cuda)
        return (lambda: (kernel(x, w, b),),
                lambda: (cuda_reflect.conv_reflect_plain(x, w, b),),
                lambda: F.conv2d(xp, w_oihw, b),
                nbytes, 2 * B * H * H * k * k * cin * cout,
                [(name, 1.0)])
    if name in ("conv_reflect_dw", SIMT):
        B, H, cin, cout, k = shape[:5]
        x = rnd(B, H, cin, H)
        gy = rnd(B, H, cout, H)
        xp = F.pad(nchw(x), (k // 2,) * 4, mode="reflect")
        gy_nchw = nchw(gy)
        scale = cuda_reflect.conv_reflect_dw_plain(x.abs(), gy.abs(), k)
        kernel = (cuda_reflect.conv_reflect_dw_cuda
                  if name == "conv_reflect_dw"
                  else cuda_reflect.conv_reflect_dw_simt_cuda)
        # bytes: x and g read once, dW written once (the shifted copies of
        # the TMA design are the kernel's own traffic, not the function's)
        return (lambda: (kernel(x, gy, k),),
                lambda: (cuda_reflect.conv_reflect_dw_plain(x, gy, k),),
                lambda: torch.nn.grad.conv2d_weight(
                    xp, (cout, cin, k, k), gy_nchw),
                (x.numel() + gy.numel()) * size + k * k * cin * cout * 4,
                2 * B * H * H * k * k * cin * cout, [(name, scale)])
    if name == "reflect_fold":
        B, H, c, p = shape[:4]
        dxp = rnd(B, H + 2 * p, c, H + 2 * p)
        if len(shape) > 4 and shape[4]:
            dxp = off_view(dxp)
        out = B * H * c * H
        x_like = torch.empty((B, c, H, H), dtype=dtype, device=DEVICE)
        dxp_nchw = nchw(dxp)
        # every element of dxp is added into one output once; the library's
        # adjoint of reflect padding is the same function
        return (lambda: (cuda_reflect.reflect_fold_cuda(dxp, p),),
                lambda: (cuda_reflect.reflect_fold_plain(dxp, p),),
                lambda: torch.ops.aten.reflection_pad2d_backward(
                    dxp_nchw, x_like, [p] * 4),
                (dxp.numel() + out) * size, dxp.numel() - out,
                [(name, 1.0)])
    if name in ("instance_norm_act", "instance_norm_act_bwd"):
        B, H, c, act, affine = shape
        x = rnd(B, H, c, H, scale=1.5, offset=0.5)
        gamma = rnd(c, scale=0.1, offset=1.0) if affine else None
        beta = rnd(c, scale=0.1) if affine else None
        n = x.numel()
        nparams = 2 * c if affine else 0

        def library_act(y):
            if act == "relu":
                return F.relu(y)
            if act == "leaky_relu":
                return F.leaky_relu(y, 0.2)
            return y

    if name == "instance_norm_act":
        # Σx, Σx², then (x - mu)·a + b and the activation: 7 per element
        return (lambda: cuda_norm_act.instance_norm_act_cuda(
                    x, gamma, beta, 1e-3, act, with_stats=True),
                lambda: cuda_norm_act.instance_norm_act_plain(
                    x, gamma, beta, 1e-3, act, with_stats=True),
                lambda: library_act(F.instance_norm(
                    nchw(x), weight=gamma, bias=beta, eps=1e-3)),
                (2 * n + nparams) * size + 2 * B * c * 4, 7 * n,
                [(name, 1.0), (name + ".stats", 1.0),
                 (name + ".stats", 1.0)])
    if name == "instance_norm_act_bwd":
        gz = rnd(B, H, c, H)
        _, mu, rstd = cuda_norm_act.instance_norm_act_plain(
            x, gamma, beta, 1e-3, act, with_stats=True)
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (nchw(x), gamma, beta) if t is not None]
        y = library_act(F.instance_norm(
            leaves[0], weight=leaves[1] if affine else None,
            bias=leaves[2] if affine else None, eps=1e-3))
        gz_nchw = nchw(gz)
        want = cuda_norm_act.instance_norm_act_bwd_plain(
            x, gz, gamma, beta, mu, rstd, act)
        scales = [float(t.float().abs().max()) for t in want]
        # xhat, v, dv, the two sums and dx: 12 per element
        return (lambda: cuda_norm_act.instance_norm_act_bwd_cuda(
                    x, gz, gamma, beta, mu, rstd, act),
                lambda: cuda_norm_act.instance_norm_act_bwd_plain(
                    x, gz, gamma, beta, mu, rstd, act),
                lambda: torch.autograd.grad(y, leaves, gz_nchw,
                                            retain_graph=True),
                (3 * n + nparams) * size + 4 * B * c * 4, 12 * n,
                [(name, scales[0]), (name + ".sums", scales[1]),
                 (name + ".sums", scales[2])])
    if name == "sum2x2":
        B, H, c = shape[:3]
        x = rnd(B, H, c, H)
        if len(shape) > 3 and shape[3]:
            x = off_view(x)
        out = x.numel() // 4
        return (lambda: (cuda_resize.sum2x2_cuda(x, 0.25),),
                lambda: (cuda_resize.sum2x2_plain(x, 0.25),),
                lambda: F.avg_pool2d(nchw(x), 2),
                (x.numel() + out) * size, 4 * out, [(name, 1.0)])
    if name == "dup2x2":
        B, h, c = shape[:3]
        gy = rnd(B, h, c, h)
        if len(shape) > 3 and shape[3]:
            gy = off_view(gy)
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
        B, H, c1, c2 = shape[:4]
        skip = rnd(B, H, c1, H)
        x = rnd(B, H // 2, c2, H // 2)
        if len(shape) > 4 and shape[4]:
            skip, x = off_view(skip), off_view(x)
        return (lambda: (cuda_concat.concat_up2_cuda(skip, x),),
                lambda: (cuda_concat.concat_up2_plain(skip, x),),
                lambda: torch.cat([skip, F.interpolate(
                    nchw(x), scale_factor=2,
                    mode="nearest").permute(0, 2, 1, 3)], dim=2),
                (skip.numel() + x.numel() + B * H * (c1 + c2) * H) * size,
                0, [(name, 1.0)])
    if name == "split_pool2":
        B, H, c1, c2 = shape[:4]
        gy = rnd(B, H, c1 + c2, H)
        if len(shape) > 4 and shape[4]:
            gy = off_view(gy)
        pooled = B * (H // 2) * c2 * (H // 2)
        g_nchw = nchw(gy[:, :, c1:])
        return (lambda: cuda_concat.split_pool2_cuda(gy, c1),
                lambda: cuda_concat.split_pool2_plain(gy, c1),
                lambda: (gy[:, :, :c1].contiguous(),
                         torch.ops.aten.upsample_nearest2d_backward(
                             g_nchw, [H, H], [B, c2, H // 2, H // 2])),
                (gy.numel() + B * H * c1 * H + pooled) * size, 3 * pooled,
                [(name, 1.0), (name, 1.0)])
    if name == "concat2":
        B, H, c1, c2 = shape
        a = rnd(B, H, c1, H)
        b = rnd(B, H, c2, H)
        return (lambda: (cuda_concat.concat2_cuda(a, b),),
                lambda: (cuda_concat.concat2_plain(a, b),),
                lambda: torch.cat([a, b], dim=2),
                2 * B * H * (c1 + c2) * H * size, 0, [(name, 1.0)])
    if name == "split2":
        B, H, c1, c2 = shape
        gy = rnd(B, H, c1 + c2, H)
        return (lambda: cuda_concat.split2_cuda(gy, c1),
                lambda: cuda_concat.split2_plain(gy, c1),
                lambda: (gy[:, :, :c1].contiguous(),
                         gy[:, :, c1:].contiguous()),
                2 * gy.numel() * size, 0, [(name, 1.0), (name, 1.0)])
    if name == "instance_norm_nhwc":
        B, H, c, affine = shape
        x = rnd(B, H, H, c, scale=1.5, offset=0.5)
        gamma = rnd(c, scale=0.1, offset=1.0) if affine else None
        beta = rnd(c, scale=0.1) if affine else None
        n = x.numel()
        # x read and y written once, gamma, beta, mean and rstd; Σx, Σx²,
        # (x - mean)·rstd [·γ + β]: 5 operations per element, 7 affine
        return (lambda: cuda_norm.instance_norm_nhwc_cuda(
                    x, gamma, beta, 1e-3),
                lambda: cuda_norm.instance_norm_nhwc_plain(
                    x, gamma, beta, 1e-3),
                lambda: F.instance_norm(x.permute(0, 3, 1, 2), weight=gamma,
                                        bias=beta, eps=1e-3),
                (2 * n + (2 * c if affine else 0)) * size + 2 * B * c * 4,
                (7 if affine else 5) * n,
                [(name, 1.0), (name + ".stats", 1.0),
                 (name + ".stats", 1.0)])
    raise KeyError(name)


def off_view(t):
    """t's values in a contiguous view one element past a 16-byte aligned
    base, so no kernel may read it in 16-byte units."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.reshape(-1))
    return buf[1:].view(t.shape)


@contextlib.contextmanager
def no_tf32():
    """TF32 off for the plain versions' and the library's f32 calls in
    phases 2 and 3; PyTorch's defaults again after, for the main paths."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


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


def check_kernels(shapes, label=""):
    """Phase 2: kernel vs plain at every unique launch shape, bf16 and
    f32. Returns the largest absolute error per (kernel, dtype). bf16 K5
    and K9-dW must run their TMA design (no ``conv_dw_simt`` launch), bf16
    K1 and K9 their tensor-core design (no ``conv_same_simt`` launch); bf16
    K2 and K6 must give the same bits in a second run."""
    from cyclegan_tpu_torch import kernels

    max_err = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, counter in shapes.items():
            worst = 0.0
            for i, shape in enumerate(sorted(counter)):
                kernel, plain, _, _, _, checks = make_case(name, shape,
                                                           dtype, i)
                simt = kernels.launches[SIMT]
                simt_same = kernels.launches[SIMT_SAME]
                before = collections.Counter(kernels.paths)
                got, want = kernel(), plain()
                if name in PATH_KERNELS:
                    took = {k.split(".")[1] for k in kernels.paths
                            if k.startswith(name + ".")
                            and kernels.paths[k] != before[k]}
                    paths_run[(name, dtype)].update(took)
                    if took != {expected_path(name, shape, dtype)}:
                        fail(f"{name} {shape} {dtype} took the {took} "
                             f"path, not the one its geometry gives")
                if dtype == torch.bfloat16 and name in DETERMINISTIC:
                    again = kernel()
                    if not all(torch.equal(a, b) for a, b in zip(got,
                                                                  again)):
                        fail(f"{name} {shape} bf16: two runs differ")
                torch.cuda.synchronize()
                if (dtype == torch.bfloat16 and name in (
                        "conv_dw", "conv_reflect_dw")
                        and kernels.launches[SIMT] != simt):
                    fail(f"{name} {shape} bf16 ran the CUDA-core design, "
                         f"not the TMA one")
                if (dtype == torch.bfloat16 and name in (
                        "conv_same", "conv_reflect")
                        and kernels.launches[SIMT_SAME] != simt_same):
                    fail(f"{name} {shape} bf16 ran the CUDA-core design, "
                         f"not the tensor-core one")
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
            rtol, atol = TOL[(name, dtype)]
            print(f"check {label}{name:22s} {str(dtype):14s} "
                  f"{len(counter):2d} "
                  f"shapes  max_abs_err {worst:.3e}  bound |d| <= {rtol:g} "
                  f"|plain| + {atol:g} x scale", flush=True)
    return max_err


def expected_path(name, shape, dtype):
    """The path that K3's, K4's, K7's, K8's, K10's or K13's geometry gives
    a phase-2 case: ``vector`` or ``element``, and for K13 ``resident``,
    ``streamed`` or ``element``. The entry after the sizes (the fifth,
    K3's and K7's fourth), where there is one, puts the inputs one element
    off alignment; K13's cases are aligned."""
    from cyclegan_tpu_torch.ops import (cuda_concat, cuda_norm, cuda_reflect,
                                        cuda_resize)

    esize = torch.finfo(dtype).bits // 8
    if name == "instance_norm_nhwc":
        B, H, c = shape[:3]
        return cuda_norm.instance_norm_nhwc_geometry(B, H * H, c,
                                                     esize)["path"]
    sizes = 3 if name in ("dup2x2", "sum2x2") else 4
    aligned = not (len(shape) > sizes and shape[sizes])
    if name == "dup2x2":
        B, h, c = shape[:3]
        geo = cuda_resize.dup2x2_geometry(B, h, c, h, esize, aligned)
    elif name == "sum2x2":
        B, H, c = shape[:3]
        geo = cuda_resize.sum2x2_geometry(B, H, c, H, esize, aligned)
    elif name in ("concat_up2", "split_pool2"):
        B, H, c1, c2 = shape[:4]
        geo = cuda_concat.concat_up2_geometry(B, H, c1, c2, H, esize,
                                              aligned)
    else:
        B, H, c, p = shape[:4]
        geo = cuda_reflect.reflect_fold_geometry(B, H, c, H, p, esize,
                                                 aligned)
    return "vector" if geo["vec"] else "element"


def time_kernels(paths, dtype=torch.bfloat16):
    """Phase 3: per unique launch shape of the train steps ``paths``
    ({path: {kernel: Counter(shape -> launches per step)}}), kernel /
    plain / library / bound ms, with the shape's launches per step of each
    path; for ``COPY_FLOOR``'s kernels also ``copy_ms``, a ``copy_`` that
    moves the launch's bytes (half read, half written): what a launch of
    pure data movement takes on the card."""
    rows = []
    for name, shapes in union_shapes(paths).items():
        for i, shape in enumerate(shapes):
            kernel, plain, library, nbytes, ops, _ = make_case(
                name, shape, dtype, 1000 + i)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / PEAK_OPS[dtype] * 1e3
            per_step = {path: plan.get(name, {}).get(shape, 0)
                        for path, plan in paths.items()}
            row = {"kernel": name, "shape": list(shape),
                   "per_step": per_step,
                   "ms": time_ms(kernel), "plain_ms": time_ms(plain),
                   "library_ms": None if library is None
                   else time_ms(library),
                   "bytes": nbytes, "operations": ops,
                   "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                   "bound_ms": max(bytes_ms, ops_ms),
                   "fits_l2": nbytes <= L2_BYTES}
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["copy_ms"] = None
            if name in COPY_FLOOR:
                src = torch.empty(nbytes // 2, dtype=torch.uint8,
                                  device=DEVICE)
                dst = torch.empty_like(src)
                row["copy_ms"] = time_ms(lambda: dst.copy_(src))
            rows.append(row)
            lib = ("-" if row["library_ms"] is None
                   else f"{row['library_ms']:.4f}")
            copy = ("" if row["copy_ms"] is None
                    else f"  copy {row['copy_ms']:.4f}")
            print(f"time {name:22s} {str(shape):36s} {per_step} "
                  f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f}"
                  f"  library {lib}{copy}  bound {row['bound_ms']:.4f} "
                  f"({100 * row['bound_share']:.1f}% of it"
                  f"{', bytes fit L2' if row['fits_l2'] else ''})",
                  flush=True)
    return rows


def with_simt(plan):
    """``plan`` ({kernel: Counter(shape -> launches)}) with ``conv_dw_simt``
    at the shapes of its conv_dw launches and of its conv_reflect_dw
    launches (pad -1), and ``conv_same_simt`` likewise at those of its
    conv_same and conv_reflect launches, as many: the CUDA-core designs on
    the same work."""
    out = dict(plan)
    for simt_name, same, reflect in ((SIMT, "conv_dw", "conv_reflect_dw"),
                                     (SIMT_SAME, "conv_same",
                                      "conv_reflect")):
        simt = collections.Counter()
        for shape, n in plan.get(same, {}).items():
            simt[shape] += n
        for shape, n in plan.get(reflect, {}).items():
            simt[shape + (-1,)] += n
        if simt:
            out[simt_name] = simt
    return out


def union_shapes(paths):
    """{kernel: sorted unique shapes over every path's plan}."""
    out = {}
    for plan in paths.values():
        for name, counter in plan.items():
            out.setdefault(name, set()).update(counter)
    return {name: sorted(shapes) for name, shapes in out.items()}


def trace_family(name):
    """The kernel family of a profiler kernel name: the first fragment of
    ``TRACE_FAMILIES`` it holds, else "other: " and the name."""
    return next((f for frag, f in TRACE_FAMILIES if frag in name),
                "other: " + name[:60])


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
        family = trace_family(name)
        families[family] = families.get(family, 0.0) + (e - s) / n / 1e3
    result = {"calls": n, "window_ms": window / 1e3,
              "device_busy_ms_per_call": busy / n / 1e3,
              "idle_share": 1.0 - busy / window,
              "kernels_per_call": len(spans) / n,
              "ms_per_call_by_kernel": dict(sorted(
                  families.items(), key=lambda kv: -kv[1]))}
    print(f"trace {file_name}: {json.dumps(result)}", flush=True)
    return result


def serve(label, model_dir, forward_plan, out_dir):
    """Phases 4 and 7: serving the generators of ``model_dir``, each
    forward launching the kernels of ``forward_plan`` ({kernel: shapes}).
    Returns the main path's launches, the number of forwards and
    metrics."""
    from cyclegan_tpu_torch import kernels
    from cyclegan_tpu_torch.apps.inference import InferenceSession

    per_forward = {name: len(v) for name, v in forward_plan.items()}
    session = InferenceSession(model_dir, "bfloat16", device=DEVICE)
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
            fail(f"{label} {b} {direction}: launches {added}, expected "
                 f"{per_forward}")
        if added.get(SIMT_SAME):
            fail(f"{label} {b} {direction}: {added[SIMT_SAME]} conv launches "
                 f"on the CUDA-core design in bf16 serving, none expected")
    main_launches = dict(kernels.launches)
    print(f"{label} main path launches {main_launches} over "
          f"{len(requests)} forwards ({per_forward} each)", flush=True)

    cpu32 = InferenceSession(model_dir, "float32", device="cpu")
    cpu16 = InferenceSession(model_dir, "bfloat16", device="cpu")
    card32 = InferenceSession(model_dir, "float32", device=DEVICE)
    quality = []
    for b, direction in requests:
        out = outputs[(b, direction)]
        ref = cpu32.stylize(images[b], direction).astype(int)
        if out.shape != images[b].shape or out.dtype != np.uint8:
            fail(f"{label} {b} {direction}: output {out.shape} {out.dtype}")
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
        print(f"{label} quality {json.dumps(q)}", flush=True)
        q["bf16_cpu_share_beyond_8"] = float((d_plain > SERVE_FAR).mean())
        mean_max = max(SERVE_MEAN_MAX,
                       RATIO * q["bf16_cpu_vs_f32_cpu_mean"])
        share_max = max(SERVE_FAR_SHARE,
                        RATIO * q["bf16_cpu_share_beyond_8"])
        if q["bf16_card_vs_f32_cpu_mean"] > mean_max:
            fail(f"{label} {b} {direction}: mean uint8 diff "
                 f"{q['bf16_card_vs_f32_cpu_mean']} > {mean_max}")
        if q["bf16_card_share_beyond_8"] > share_max:
            fail(f"{label} {b} {direction}: share of pixels > {SERVE_FAR} off "
                 f"{q['bf16_card_share_beyond_8']} > {share_max}")
        if q["bf16_card_vs_f32_cpu_max"] > max(
                SERVE_FAR, RATIO * q["bf16_cpu_vs_f32_cpu_max"]):
            fail(f"{label} {b} {direction}: max uint8 diff "
                 f"{q['bf16_card_vs_f32_cpu_max']} beyond 1.5x the plain "
                 f"bf16 session's {q['bf16_cpu_vs_f32_cpu_max']}")
        if q["f32_card_vs_f32_cpu_max"] > SERVE_F32_MAX:
            fail(f"{label} {b} {direction}: f32 card vs cpu max "
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
    # the generator alone runs in the session's NHCW layout scope
    with torch.inference_mode(), layout.nhcw():
        fwd_ms = time_ms(lambda: model(x))
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode(), layout.nhcw():
        model(x)
    torch.cuda.synchronize()
    enqueue = []  # host time to issue one forward, the card idle before
    with torch.inference_mode(), layout.nhcw():
        for _ in range(TIMED_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(x)
            enqueue.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    with torch.inference_mode(), layout.nhcw():
        trace = device_trace(lambda: model(x), out_dir, 5,
                             f"{label}_forward_trace.json")
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
    print(f"{label} batch {BATCH}: {metrics['img_per_s']:.1f} img/s per "
          f"request (median {metrics['request_ms_median']:.2f} ms), "
          f"generator forward {fwd_ms:.3f} ms = "
          f"{metrics['forward_img_per_s']:.1f} img/s", flush=True)
    return main_launches, len(requests), metrics


def _train_state(model_cfg, device, model_dir=None, seed=0, beta=None):
    """The four networks (f32 masters) with fresh Adam: from the
    checkpoint in ``model_dir``, or random weights from ``seed`` without
    one; with ``beta`` = (lo, hi), every affine norm's beta drawn from
    +-(lo..hi) by the same seed."""
    from cyclegan_tpu_torch.config import yaml2namespace
    from cyclegan_tpu_torch.steps import build_models, init_train_state
    from cyclegan_tpu_torch.utils.checkpoint import load_pytree
    from cyclegan_tpu_torch.weights import (load_jax_params,
                                            models_to_jax_params)

    models = build_models(model_cfg, seed=seed)
    if model_dir is not None:
        restored = load_pytree(model_dir / "checkpoint.npz",
                               {"params": models_to_jax_params(models)})
        load_jax_params(models, restored["params"])
    if beta is not None:
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            for name in sorted(models):
                for key, p in models[name].named_parameters():
                    if key.endswith("beta"):
                        p.copy_(torch.from_numpy(
                            rng.choice([-1.0, 1.0], p.shape)
                            * rng.uniform(*beta, p.shape)))
    return init_train_state(models, yaml2namespace(TRAIN_CONFIG), 0, device)


def _grads(state):
    """{network: {parameter: its gradient, f32 on the CPU}}."""
    return {name: {key: p.grad.detach().float().cpu()
                   for key, p in model.named_parameters()}
            for name, model in state.models.items()}


def _flat(grads, keys=None):
    return torch.cat([grads[k].reshape(-1)
                      for k in (grads if keys is None else keys)])


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def pre_norm_bias(key):
    """Whether a parameter is a conv bias whose output an instance norm
    takes whole: the norm removes any per-channel constant, so its gradient
    is zero up to rounding. That is every bias of the recipes but the
    heads' (``head``, ``last``) and the strided U-Net's bottom conv's, which
    a conv-transpose takes first."""
    return key.endswith(".b") and key.split(".")[0] not in (
        "head", "last", "bottom")


def f32_errors(got, want):
    """(|got - want| / |want| over the parameters that are not pre-norm
    biases, the largest |got - want| of a pre-norm bias over |want| of the
    whole network)."""
    rest = [k for k in want if not pre_norm_bias(k)]
    biases = [float((got[k] - want[k]).abs().max()) for k in want
              if pre_norm_bias(k)]
    return (_rel(_flat(got, rest), _flat(want, rest)),
            max(biases, default=0.0) / float(_flat(want).norm()))


def step_grads(model_cfg, device, dtype, x, model_dir=None, seed=0,
               beta=None, **step_kw):
    """The gradients one train step (no jitter) leaves on inputs ``x``;
    ``step_kw`` picks the layout (``make_train_step``'s ``tpu_layout`` and
    ``pallas_norm``)."""
    from cyclegan_tpu_torch.steps import make_train_step

    s = _train_state(model_cfg, device, model_dir, seed, beta)
    make_train_step(model_cfg["loss"], model_cfg["loss_weights"], dtype,
                    **step_kw)(s, *(t.to(device) for t in x))
    return _grads(s)


def f32_point_inputs(point):
    """The (real_a, real_b) batches of an f32 comparison point, normalized
    uint8 noise from its seed."""
    from cyclegan_tpu_torch.data.augment import normalize

    rng = np.random.default_rng(point["seed"])
    shape = (point["batch"], point["size"], point["size"], 3)
    return [normalize(torch.from_numpy(rng.integers(0, 256, shape,
                                                    dtype=np.uint8)))
            for _ in range(2)]


def nearest_kink(run):
    """``run()``'s result on the CPU, and the smallest |input| of any ReLU
    or LeakyReLU it met: the output of a norm (gamma x_hat + beta where
    affine) before its activation, fused (NHCW) or not (NHWC)."""
    from cyclegan_tpu_torch.ops import cuda_norm_act
    from cyclegan_tpu_torch.ops import norm as norm_ops

    plain = cuda_norm_act.instance_norm_act_plain
    activation = norm_ops.activation
    nearest = [math.inf]

    def recording_activation(y, act, alpha):
        if act != "none":
            nearest[0] = min(nearest[0],
                             float(y.detach().float().abs().min()))
        return activation(y, act, alpha)

    def recording(x, gamma, beta, eps=1e-3, act="relu", alpha=0.2,
                  with_stats=False):
        out, mu, rstd = plain(x, gamma, beta, eps, act, alpha,
                              with_stats=True)
        if act != "none":
            v = (x.float() - mu[:, None, :, None]) * rstd[:, None, :, None]
            if gamma is not None:
                v = v * gamma.float()[:, None] + beta.float()[:, None]
            nearest[0] = min(nearest[0], float(v.abs().min()))
        return (out, mu, rstd) if with_stats else out

    cuda_norm_act.instance_norm_act_plain = recording
    norm_ops.activation = recording_activation
    try:
        result = run()
    finally:
        cuda_norm_act.instance_norm_act_plain = plain
        norm_ops.activation = activation
    return result, nearest[0]


def train(label, model_cfg, plan, model_dir, out_dir, f32_point=None,
          batch_size=BATCH, **step_kw):
    """Phases 5, 6, 8, 10, 12, 13 and 15: training ``model_cfg`` from
    ``model_dir``'s weights (seeded random weights if None) at batch
    ``batch_size`` against the launch ``plan`` ({kernel: shapes}) of one
    step, in the layout ``step_kw`` gives ``make_train_step`` (NHCW by
    default; phases 12 and 13 pass ``tpu_layout=False, pallas_norm=True``).
    The f32 gradients are compared on the step's first GRAD_BATCH images,
    or at ``f32_point`` where given (inputs, and weights where there is no
    ``model_dir``, from its seed, with its betas where it names them;
    asserted kink-free).
    Returns the main path's launches, metrics and the trained state."""
    from cyclegan_tpu_torch import kernels
    from cyclegan_tpu_torch.data.augment import (normalize,
                                                 random_jitter_batch)
    from cyclegan_tpu_torch.steps import make_train_step

    def jitter(generator, a, b):
        return (random_jitter_batch(generator, a, SIZE),
                random_jitter_batch(generator, b, SIZE))

    plan = {k: len(v) for k, v in plan.items()}
    noise = torch.Generator(device=DEVICE).manual_seed(0)
    batch = [torch.randint(0, 256, (batch_size, SIZE, SIZE, 3),
                           generator=noise,
                           dtype=torch.uint8, device=DEVICE)
             for _ in range(2)]
    state = _train_state(model_cfg, DEVICE, model_dir)
    start = {name: [p.detach().clone() for p in m.parameters()]
             for name, m in state.models.items()}
    step16 = make_train_step(model_cfg["loss"], model_cfg["loss_weights"],
                             "bfloat16", preprocess=jitter, **step_kw)

    # 5.1: the main path, one bf16 step with the counts zeroed around it
    kernels.reset_launches()
    metrics = step16(state, *batch)
    torch.cuda.synchronize()
    main_launches = {k: v for k, v in kernels.launches.items()
                     if v or k in plan}
    print(f"{label} main path launches {main_launches} in one step (plan "
          f"{plan})", flush=True)
    if main_launches != plan:
        fail(f"{label} step launches {main_launches}, plan {plan}")
    if kernels.launches[SIMT]:
        fail(f"{label}: {kernels.launches[SIMT]} dW launches on the CUDA-core "
             f"design in a bf16 step, none expected")
    if kernels.launches[SIMT_SAME]:
        fail(f"{label}: {kernels.launches[SIMT_SAME]} conv launches on the "
             f"CUDA-core design in a bf16 step, none expected")

    # 5.2-5.3: gradients of one batch-2 step (no jitter) against the plain
    # f32 step on the CPU; the f32 comparison with PyTorch's default TF32
    # setting, which the port must override where it matters
    x = [normalize(t[:GRAD_BATCH]) for t in batch]
    grads = {(device, dtype): step_grads(model_cfg, device, dtype, x,
                                         model_dir, **step_kw)
             for device, dtype in (("cpu", "float32"), (DEVICE, "bfloat16"),
                                   ("cpu", "bfloat16"))}
    f32_at = {"batch": GRAD_BATCH, "size": SIZE, "seed": None}
    f32_x, f32_seed, f32_beta = x, 0, None
    f32_ref = grads[("cpu", "float32")]
    if f32_point is not None:
        f32_at = dict(f32_point)
        f32_x, f32_seed = f32_point_inputs(f32_point), f32_point["seed"]
        f32_beta = f32_point.get("beta")
        f32_ref, kink = nearest_kink(lambda: step_grads(
            model_cfg, "cpu", "float32", f32_x, model_dir, f32_seed,
            f32_beta, **step_kw))
        f32_at["nearest_kink"] = kink
        print(f"{label} f32 point {json.dumps(f32_at)}", flush=True)
        if not kink > KINK_MARGIN:
            fail(f"{label}: a ReLU input {kink} from its kink at the f32 "
                 f"point, not beyond {KINK_MARGIN}")
    if not torch.backends.cudnn.allow_tf32:
        fail(f"{label}: the f32 step should meet PyTorch's default "
             f"cudnn.allow_tf32 = True")
    grads[(DEVICE, "float32")] = step_grads(model_cfg, DEVICE, "float32",
                                            f32_x, model_dir, f32_seed,
                                            f32_beta, **step_kw)
    ref = grads[("cpu", "float32")]
    grad_errors = {"f32_point": f32_at}
    for name in ref:
        f32_rel, f32_bias = f32_errors(grads[(DEVICE, "float32")][name],
                                       f32_ref[name])
        e = {"f32_card_vs_f32_cpu": f32_rel,
             "f32_pre_norm_bias_card_vs_cpu": f32_bias,
             "bf16_card_vs_f32_cpu": _rel(
                 _flat(grads[(DEVICE, "bfloat16")][name]), _flat(ref[name])),
             "bf16_cpu_vs_f32_cpu": _rel(
                 _flat(grads[("cpu", "bfloat16")][name]), _flat(ref[name]))}
        grad_errors[name] = e
        print(f"{label} gradients {name}: {json.dumps(e)}", flush=True)
        for key in ("f32_card_vs_f32_cpu", "f32_pre_norm_bias_card_vs_cpu"):
            if not e[key] <= TRAIN_F32_REL:
                fail(f"{label} {name}: {key} {e[key]} > {TRAIN_F32_REL}")
        if not e["bf16_card_vs_f32_cpu"] <= (RATIO
                                             * e["bf16_cpu_vs_f32_cpu"]):
            fail(f"{label} {name}: bf16 gradient error "
                 f"{e['bf16_card_vs_f32_cpu']} beyond {RATIO}x "
                 f"the plain bf16 step's {e['bf16_cpu_vs_f32_cpu']}")

    # 5.4: five bf16 steps: finite losses, every network moves
    losses = [metrics]
    for _ in range(4):
        losses.append(step16(state, *batch))
    losses = [{k: float(v) for k, v in m.items()} for m in losses]
    print(f"{label} losses {json.dumps(losses)}", flush=True)
    if not all(np.isfinite(v) for m in losses for v in m.values()):
        fail(f"{label}: non-finite loss")
    moved = {name: max(float((p.detach() - p0).abs().max())
                       for p, p0 in zip(m.parameters(), start[name]))
             for name, m in state.models.items()}
    print(f"{label} largest parameter change after 5 steps {moved}")
    if not all(v > 0 for v in moved.values()):
        fail(f"{label}: a network did not move {moved}")

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
                         f"{label}_trace.json")
    result = {"batch": batch_size, "size": SIZE,
              "compute_dtype": "bfloat16",
              "step": step_kw or {"tpu_layout": True},
              "step_ms": step_s * 1e3, "img_per_s": batch_size / step_s,
              "peak_mib": peak_mib,
              "host_issue_ms_median": statistics.median(issue) * 1e3,
              "gradient_errors": grad_errors, "losses": losses,
              "trace": trace}
    print(f"{label} batch {batch_size}: {result['img_per_s']:.2f} img/s "
          f"({result['step_ms']:.1f} ms per step), peak "
          f"{peak_mib:.0f} MiB, host issue "
          f"{result['host_issue_ms_median']:.1f} ms", flush=True)
    return main_launches, result, state


def _same_state(a, b):
    """Where two ``steps.TrainState``s differ: parameters, every slot of
    their optimizers' state, the step and the augmentation and dropout
    generators, compared exactly."""
    diffs = []
    for name, model in a.models.items():
        other = dict(b.models[name].named_parameters())
        opt_a, opt_b = a.optimizers[name].state, b.optimizers[name].state
        for key, p in model.named_parameters():
            q = other[key]
            if not torch.equal(p, q):
                diffs.append(f"{name}.{key}")
            if set(opt_a[p]) != set(opt_b[q]):
                diffs.append(f"{name}.{key} slots {sorted(opt_a[p])} vs "
                             f"{sorted(opt_b[q])}")
            for slot, value in opt_a[p].items():
                if slot in opt_b[q] and not torch.equal(value,
                                                        opt_b[q][slot]):
                    diffs.append(f"{name}.{key} {slot}")
    if a.step != b.step:
        diffs.append(f"step {a.step} vs {b.step}")
    for gen in ("generator", "dropout_generator"):
        if not torch.equal(getattr(a, gen).get_state(),
                           getattr(b, gen).get_state()):
            diffs.append(f"{gen}")
    return diffs


def trainer_cli(workdir):
    """Phase 14: ``cyclegan_tpu_torch.train.main`` on TFRecords written
    into ``workdir`` (CLI_IMAGES seeded uint8 SIZE² images per domain, the
    port's own PNG and CRC32C), ``configs/cycle.yaml`` at batch BATCH,
    bf16. Returns ({run: launches}, metrics)."""
    from cyclegan_tpu_torch import kernels
    from cyclegan_tpu_torch.config import (Namespace, namespace2yaml,
                                           yaml2namespace)
    from cyclegan_tpu_torch.data import png
    from cyclegan_tpu_torch.data.codec import image2example
    from cyclegan_tpu_torch.data.tfrecord import write_tfrecord_file
    from cyclegan_tpu_torch.train import main as train_main
    from cyclegan_tpu_torch.trainer import CycleGan

    rng = np.random.default_rng(0)
    data = workdir / "data"
    start = time.perf_counter()
    for domain in ("tabby_records", "tortie_records"):
        (data / domain).mkdir(parents=True)
        images = rng.integers(0, 256, (CLI_IMAGES, SIZE, SIZE, 3),
                              dtype=np.uint8)
        write_tfrecord_file(data / domain / "00000.tfrecords",
                            (image2example(im) for im in images))
    metrics = {"records": 2 * CLI_IMAGES,
               "write_records_s": time.perf_counter() - start,
               "png_decode_ms_by_row_filter": {}}
    # the stdlib PNG decoder on one SIZE² image per row filter (host only)
    for row_filter in range(5):
        blob = png.encode_png(images[0], row_filter)
        start = time.perf_counter()
        decoded = png.decode_png(blob)
        metrics["png_decode_ms_by_row_filter"][row_filter] = (
            time.perf_counter() - start) * 1e3
        if not np.array_equal(decoded, images[0]):
            fail(f"PNG row filter {row_filter}: decode differs")

    model_cfg = yaml2namespace(ROOT / "configs" / "cycle.yaml")
    model_cfg.location = str(workdir / "models")
    train_cfg = yaml2namespace(TRAIN_CONFIG)
    train_cfg.update(batch_size=BATCH, image_size=SIZE, epochs=2,
                     tpu_layout=False, pallas_norm=True)
    train_cfg.summary = dict(train_cfg.summary, model=1)
    steps_per_epoch = (CLI_IMAGES - int(0.2 * CLI_IMAGES)) // BATCH
    runs, launches = {}, {}

    def run(label, model_yaml, tc):
        train_yaml = workdir / f"{label}_train_config.yaml"
        namespace2yaml(train_yaml, tc)
        kernels.reset_launches()
        start = time.perf_counter()
        gan = train_main(["--model_config", str(model_yaml),
                          "--train_config", str(train_yaml),
                          "--data_dir", str(data), "--device", DEVICE])
        torch.cuda.synchronize()
        launches[label] = {k: v for k, v in kernels.launches.items() if v}
        runs[label] = {"seconds": time.perf_counter() - start,
                       "tpu_layout": gan.tpu_layout, "step": gan.state.step,
                       "launches": launches[label], "epochs": gan.history,
                       "train_img_per_s": [
                           r["train_steps"] * BATCH / r["train_seconds"]
                           for r in gan.history]}
        print(f"trainer {label}: {json.dumps(runs[label])}", flush=True)
        for record in gan.history:
            values = [*record["train"].values(),
                      *record["validation"].values()]
            if not all(np.isfinite(v) for v in values):
                fail(f"trainer {label}: non-finite metrics {record}")
        return gan

    # 14.1: two epochs in NHWC with pallas_norm, from scratch
    first = workdir / "model_config.yaml"
    namespace2yaml(first, model_cfg)
    gan = run("nhwc", first, train_cfg)
    folder = Path(gan.model_folder)
    saved = yaml2namespace(folder / "model_config.yaml")
    if gan.tpu_layout or set(launches["nhwc"]) != {"instance_norm_nhwc"}:
        fail(f"trainer nhwc: layout NHCW {gan.tpu_layout}, launches "
             f"{launches['nhwc']}, expected K13 only")
    if gan.state.step != 2 * steps_per_epoch or saved.current_epoch != 2 \
            or saved.new is not False:
        fail(f"trainer nhwc: step {gan.state.step}, current_epoch "
             f"{saved.get('current_epoch')}, new {saved.get('new')}")

    # 14.2: the checkpoint reloads what was saved
    resume_cfg = Namespace(dict(train_cfg, epochs=1))
    reloaded = CycleGan(yaml2namespace(folder / "model_config.yaml"),
                        resume_cfg, device=DEVICE)
    diffs = _same_state(gan.state, reloaded.state)
    if not np.array_equal(reloaded.a_samples, gan.a_samples):
        diffs.append("sample images")
    metrics["reload_differences"] = diffs
    if diffs:
        fail(f"trainer reload differs from the saved state: {diffs[:8]}")
    del reloaded, gan

    # 14.3: one more epoch from the checkpoint
    gan = run("resume", folder / "model_config.yaml", resume_cfg)
    saved = yaml2namespace(folder / "model_config.yaml")
    metrics["resumed_step"] = gan.state.step
    metrics["resumed_current_epoch"] = saved.current_epoch
    if gan.state.step != 3 * steps_per_epoch or saved.current_epoch != 3:
        fail(f"trainer resume: step {gan.state.step}, current_epoch "
             f"{saved.current_epoch}, expected {3 * steps_per_epoch} and 3")
    if set(launches["resume"]) != {"instance_norm_nhwc"}:
        fail(f"trainer resume: launches {launches['resume']}")
    del gan

    # 14.4: one epoch with tpu_layout auto: NHCW on the card
    auto_cfg = Namespace(dict(resume_cfg))
    del auto_cfg["tpu_layout"]
    auto = workdir / "model_config_auto.yaml"
    namespace2yaml(auto, dict(model_cfg, name="model_auto", new=True))
    gan = run("auto", auto, auto_cfg)
    nhcw = ("conv_same", "instance_norm_act", "sum2x2", "concat_up2",
            "conv_dw", "instance_norm_act_bwd", "dup2x2", "split_pool2")
    if not gan.tpu_layout or "instance_norm_nhwc" in launches["auto"] or \
            not all(launches["auto"].get(k) for k in nhcw):
        fail(f"trainer auto: NHCW {gan.tpu_layout}, launches "
             f"{launches['auto']}, expected K1-K8 and no K13")
    metrics["runs"] = runs
    total = collections.Counter(launches["nhwc"])
    total.update(launches["resume"])
    return ({"trainer_cli_nhwc": dict(total),
             "trainer_cli_nhcw": launches["auto"]}, metrics)


def _uint8_batch(batch_size, seed=0):
    """Two seeded uint8 NHWC batches of SIZE² images on the card."""
    noise = torch.Generator(device=DEVICE).manual_seed(seed)
    return [torch.randint(0, 256, (batch_size, SIZE, SIZE, 3),
                          generator=noise, dtype=torch.uint8, device=DEVICE)
            for _ in range(2)]


def _jitter(generator, a, b):
    from cyclegan_tpu_torch.data.augment import random_jitter_batch

    return (random_jitter_batch(generator, a, SIZE),
            random_jitter_batch(generator, b, SIZE))


def planned_step(label, model_cfg, plan, model_dir, batch, **step_kw):
    """A fresh train state (``model_dir``'s weights, or seeded ones) and
    its bf16 step with the jitter inside (``step_kw``: the step's
    options). Its first step, with the counts zeroed around it, must launch
    the kernels of ``plan`` ({kernel: shapes}) and nothing else. Returns
    (state, step, that step's launches, its gradients, its metrics)."""
    from cyclegan_tpu_torch import kernels
    from cyclegan_tpu_torch.steps import make_train_step

    state = _train_state(model_cfg, DEVICE, model_dir)
    step = make_train_step(model_cfg["loss"], model_cfg["loss_weights"],
                           "bfloat16", preprocess=_jitter, **step_kw)
    kernels.reset_launches()
    metrics = step(state, *batch)
    torch.cuda.synchronize()
    want = {k: len(v) for k, v in plan.items()}
    got = {k: v for k, v in kernels.launches.items() if v or k in want}
    print(f"{label} main path launches {got} in one step (plan {want})",
          flush=True)
    if got != want:
        fail(f"{label} step launches {got}, plan {want}")
    metrics = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in metrics.values()):
        fail(f"{label}: non-finite loss {metrics}")
    return state, step, got, _grads(state), metrics


def compare_steps(runs, batch, out_dir):
    """The steps of ``runs`` ((label, step, state), ...) timed side by
    side: img/s on the host clock over ALT_ROUNDS rounds of ALT_STEPS
    steps each, the runs taking turns in an order reversed every other
    round, so that a drift of the shared host weighs on all alike (the
    median round and every round are reported); then each step's peak
    device memory, and its device time and idle share from a profiler
    trace of 3 steps. Returns {label: result}."""
    n = int(batch[0].shape[0])
    for _, step, state in runs:
        for _ in range(2):
            step(state, *batch)
    rates = {label: [] for label, _, _ in runs}
    for r in range(ALT_ROUNDS):
        for label, step, state in (runs if r % 2 == 0 else runs[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ALT_STEPS):
                step(state, *batch)
            torch.cuda.synchronize()
            rates[label].append(n * ALT_STEPS / (time.perf_counter() - t0))
    results = {}
    for label, step, state in runs:
        torch.cuda.reset_peak_memory_stats()
        step(state, *batch)
        torch.cuda.synchronize()
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        trace = device_trace(lambda: step(state, *batch), out_dir, 3,
                             f"{label}_trace.json")
        img_per_s = statistics.median(rates[label])
        results[label] = {
            "batch": n, "size": SIZE, "img_per_s": img_per_s,
            "step_ms": n / img_per_s * 1e3,
            "img_per_s_rounds": rates[label], "peak_mib": peak_mib,
            "device_ms": trace and trace["device_busy_ms_per_call"],
            "idle_share": trace and trace["idle_share"], "trace": trace}
        print(f"{label} batch {n}: {img_per_s:.2f} img/s (median of "
              f"{ALT_ROUNDS} rounds: {[round(v, 1) for v in rates[label]]}),"
              f" peak {peak_mib:.0f} MiB, device "
              f"{results[label]['device_ms']} ms per step", flush=True)
    return results


def grad_differences(got, want):
    """Per network: the largest |got - want| and its ratio to |want| over
    the whole network, and whether every bit agrees."""
    return {name: {"max_abs": max(float((got[name][k] - v).abs().max())
                                  for k, v in want[name].items()),
                   "rel": _rel(_flat(got[name]), _flat(want[name])),
                   "bit_equal": all(torch.equal(got[name][k], v)
                                    for k, v in want[name].items())}
            for name in want}


def unet_options(model_cfg, plans, out_dir):
    """Phase 16: the default U-Net recipe's step options on the card
    (converged256, batch BATCH, SIZE², bf16, NHCW): ``fuse_apps`` (its
    plan; f32 gradients at ``UNET_F32_POINT`` against the unfused step
    within FUSED_F32_REL; device ms and img/s both ways), ``remat`` (its
    plan, the generator forwards twice; its first step's gradients against
    the plain step's on the same inputs and generator state; peak memory
    lower, asserted; step times both ways) and dropout (5 finite steps
    that move every network; a training-mode generator forward on the
    card against the plain one on the CPU with the same masks). Returns
    ({path: launches}, metrics)."""
    from cyclegan_tpu_torch.ops import layout

    batch = _uint8_batch(BATCH)
    launches, metrics = {}, {}

    # 16.1-16.2: the fused, plain and remat steps, each from a fresh
    # state on the same batch and generator state, timed side by side
    runs, first = [], {}
    for label, plan, kw in (
            ("unet_train_fused", "unet_train_fused", {"fuse_apps": True}),
            ("unet_train_unfused", "unet_train", {}),
            ("unet_train_remat", "unet_train_remat", {"remat": True})):
        state, step, got, first[label], _ = planned_step(
            label, model_cfg, plans[plan], MODEL_DIR, batch, **kw)
        if label != "unet_train_unfused":
            launches[label] = got
        runs.append((label, step, state))
    timed = compare_steps(runs, batch, out_dir)
    del runs
    point = UNET_F32_POINT
    x = f32_point_inputs(point)
    g_fused, g_plain = (step_grads(model_cfg, DEVICE, "float32", x, None,
                                   point["seed"], point["beta"],
                                   fuse_apps=fuse)
                        for fuse in (True, False))
    errors = {name: f32_errors(g_fused[name], g_plain[name])
              for name in g_plain}
    print(f"unet fuse_apps f32 fused vs unfused at {json.dumps(point)}: "
          f"{json.dumps(errors)}", flush=True)
    for name, (rel, bias) in errors.items():
        if not max(rel, bias) <= FUSED_F32_REL:
            fail(f"unet fuse_apps {name}: f32 fused vs unfused {rel} "
                 f"(pre-norm biases {bias}) > {FUSED_F32_REL}")
    plain = timed["unet_train_unfused"]
    metrics["fuse_apps"] = {"fused": timed["unet_train_fused"],
                            "unfused": plain,
                            "f32_fused_vs_unfused": errors,
                            "f32_point": point}
    remat = timed["unet_train_remat"]
    diff = grad_differences(first["unet_train_remat"],
                            first["unet_train_unfused"])
    print(f"unet remat first-step gradients vs the plain step: "
          f"{json.dumps(diff)}", flush=True)
    for name, d in diff.items():
        if not d["rel"] <= TRAIN_F32_REL:
            fail(f"unet remat {name}: gradient {d['rel']} from the plain "
                 f"step's")
    if not remat["peak_mib"] < plain["peak_mib"]:
        fail(f"unet remat: peak {remat['peak_mib']} MiB, not below the "
             f"plain step's {plain['peak_mib']}")
    metrics["remat"] = {"remat": remat, "plain": plain,
                        "gradients_vs_plain": diff}

    # 16.3: dropout in the generators
    cfg = dict(model_cfg, generator=dict(model_cfg["generator"],
                                         dropout=True))
    state, step, launches["unet_train_dropout"], _, first = planned_step(
        "unet_train_dropout", cfg, plans["unet_train"], MODEL_DIR, batch)
    start = {name: [p.detach().clone() for p in m.parameters()]
             for name, m in state.models.items()}
    losses = [first] + [{k: float(v) for k, v in step(state, *batch).items()}
                        for _ in range(4)]
    moved = {name: max(float((p.detach() - p0).abs().max())
                       for p, p0 in zip(m.parameters(), start[name]))
             for name, m in state.models.items()}
    if not all(np.isfinite(v) for m in losses for v in m.values()):
        fail(f"unet dropout: non-finite loss {losses}")
    if not all(v > 0 for v in moved.values()):
        fail(f"unet dropout: a network did not move {moved}")
    g = state.models["g_AB"]
    from cyclegan_tpu_torch.data.augment import normalize

    x = normalize(batch[0][:1, :64, :64])
    with torch.no_grad(), layout.nhcw():
        xn = layout.to_nhcw(x)
        masks = g.dropout_masks(tuple(xn.shape), state.dropout_generator)
        y_card = g(xn, masks=masks)
        y_none = g(xn)
        g_cpu = copy.deepcopy(g).cpu()
        y_cpu = g_cpu(xn.cpu(), masks=[m.cpu() for m in masks])
    err = float((y_card.cpu() - y_cpu).abs().max())
    scale = float(y_cpu.abs().max())
    kept = float(torch.cat([m.reshape(-1) for m in masks]).float().mean())
    metrics["dropout"] = {"losses": losses, "moved": moved,
                          "forward_card_vs_cpu_max_abs": err,
                          "forward_scale": scale, "kept_share": kept,
                          "masks_change_output": not torch.equal(y_card,
                                                                 y_none)}
    print(f"unet dropout: {json.dumps(metrics['dropout'])}", flush=True)
    if not err <= 1e-4 * scale:
        fail(f"unet dropout forward: card vs cpu {err} > 1e-4 x {scale}")
    if torch.equal(y_card, y_none) or not 0.45 < kept < 0.55:
        fail(f"unet dropout forward: masks kept {kept}, output changed "
             f"{metrics['dropout']['masks_change_output']}")
    return launches, metrics


def resnet_fuse_apps(model_cfg, plans, out_dir):
    """Phase 17: the ResNet recipe (seeded weights, batch BATCH, SIZE²,
    bf16, NHCW) with ``fuse_apps``: its plan, and device ms and img/s
    beside the unfused step's; the first steps' bf16 gradients of both
    ways, compared (reported). Returns (launches, metrics)."""
    batch = _uint8_batch(BATCH)
    runs, first = [], {}
    for label, plan, kw in (
            ("resnet_train_fused", "resnet_train_fused", {"fuse_apps": True}),
            ("resnet_train_unfused", "resnet_train", {})):
        state, step, got, first[label], _ = planned_step(
            label, model_cfg, plans[plan], None, batch, **kw)
        if label == "resnet_train_fused":
            launches = got
        runs.append((label, step, state))
    timed = compare_steps(runs, batch, out_dir)
    diff = grad_differences(first["resnet_train_fused"],
                            first["resnet_train_unfused"])
    print(f"resnet fuse_apps bf16 first-step gradients vs unfused: "
          f"{json.dumps(diff)}", flush=True)
    return launches, {"fused": timed["resnet_train_fused"],
                      "unfused": timed["resnet_train_unfused"],
                      "bf16_fused_vs_unfused": diff}


def paired(model_cfg, plans, out_dir):
    """Phase 18: the paired step (NHWC, converged256, batch BATCH, SIZE²,
    bf16) with and without ``pallas_norm``: K13's launches equal to the
    NHWC plan with it, no kernel without; every vmapped convolution
    through ``LibraryConv``'s batching rule and every vmapped norm through
    K13's; its gradients against the unpaired NHWC step's on the card at
    ``UNET_NHWC_F32_POINT`` (f32 within TRAIN_F32_REL; the bf16 error from
    the unpaired f32 step within RATIO times the unpaired bf16 step's);
    step times and img/s both ways. Returns ({path: launches}, metrics)."""
    from cyclegan_tpu_torch.ops import conv as conv_ops
    from cyclegan_tpu_torch.ops import cuda_norm

    batch = _uint8_batch(BATCH)
    rules = collections.Counter()
    originals = {}
    for key, cls in (("conv", conv_ops.LibraryConv),
                     ("norm", cuda_norm.InstanceNormNHWC)):
        originals[key] = cls.__dict__["vmap"]
        rule = cls.vmap

        def counting(*args, key=key, rule=rule):
            rules[key] += 1
            return rule(*args)

        cls.vmap = staticmethod(counting)
    # every conv of the U-Nets is a stride-1 conv: K1's plan counts them
    convs = sum(len(generator_launches(model_cfg[net], 1, SIZE)["conv_same"])
                for net in ("generator", "discriminator"))
    launches, metrics = {}, {}
    point = UNET_NHWC_F32_POINT
    x = f32_point_inputs(point)
    try:
        for pallas in (True, False):
            label = "unet_train_paired" + ("" if pallas else "_library")
            plan = plans["unet_train_paired"] if pallas else {}
            rules.clear()
            state, step, launches[label], _, _ = planned_step(
                label, model_cfg, plan, MODEL_DIR, batch, tpu_layout=False,
                pallas_norm=pallas, paired=True)
            first_rules = dict(rules)
            want = {"conv": 3 * convs,
                    "norm": len(plan.get("instance_norm_nhwc", [])) // 2}
            print(f"{label} batching rules per step {first_rules} "
                  f"(expected {want})", flush=True)
            if {k: first_rules.get(k, 0) for k in want} != want:
                fail(f"{label}: batching rules ran {first_rules}, "
                     f"expected {want}")
            unpaired_state, unpaired_step, _, _, _ = planned_step(
                label + "_unpaired", model_cfg,
                plans["unet_train_nhwc"] if pallas else {}, MODEL_DIR, batch,
                tpu_layout=False, pallas_norm=pallas)
            timed = compare_steps(
                [(label, step, state),
                 (label + "_unpaired", unpaired_step, unpaired_state)],
                batch, out_dir)
            del state, step, unpaired_state, unpaired_step
            grads = {(paired_, dtype): step_grads(
                model_cfg, DEVICE, dtype, x, MODEL_DIR, point["seed"],
                point["beta"], tpu_layout=False, pallas_norm=pallas,
                paired=paired_)
                for paired_ in (True, False)
                for dtype in ("float32", "bfloat16")}
            ref = grads[(False, "float32")]
            errors = {}
            for name in ref:
                rel, bias = f32_errors(grads[(True, "float32")][name],
                                       ref[name])
                errors[name] = {
                    "f32_paired_vs_unpaired": rel,
                    "f32_pre_norm_bias_paired_vs_unpaired": bias,
                    "bf16_paired_vs_f32": _rel(
                        _flat(grads[(True, "bfloat16")][name]),
                        _flat(ref[name])),
                    "bf16_unpaired_vs_f32": _rel(
                        _flat(grads[(False, "bfloat16")][name]),
                        _flat(ref[name]))}
                e = errors[name]
                if not max(rel, bias) <= TRAIN_F32_REL:
                    fail(f"{label} {name}: f32 paired vs unpaired {rel} "
                         f"(pre-norm biases {bias}) > {TRAIN_F32_REL}")
                if not e["bf16_paired_vs_f32"] <= (
                        RATIO * e["bf16_unpaired_vs_f32"]):
                    fail(f"{label} {name}: bf16 error "
                         f"{e['bf16_paired_vs_f32']} beyond {RATIO}x the "
                         f"unpaired step's {e['bf16_unpaired_vs_f32']}")
            print(f"{label} gradients at {json.dumps(point)}: "
                  f"{json.dumps(errors)}", flush=True)
            metrics[label] = {"paired": timed[label],
                              "unpaired": timed[label + "_unpaired"],
                              "batching_rules_per_step": first_rules,
                              "gradient_errors": errors}
    finally:
        conv_ops.LibraryConv.vmap = originals["conv"]
        cuda_norm.InstanceNormNHWC.vmap = originals["norm"]
    return launches, metrics


def trainer_options(workdir):
    """Phase 19: the trainer CLI with the options of this recipe's train
    config that phase 14 does not take, on phase 14's records in
    ``workdir``: ``configs/cycle.yaml`` at batch BATCH, NHCW, bf16,
    ``steps_per_call`` 3 over 4 batches an epoch (a chunk and a ragged
    single step), ``profile_dir`` (a non-empty Chrome trace of the first 3
    batches), AdaBelief generators and RMSprop discriminators; a reload
    that gives back every optimizer slot, the step and both generators
    exactly; one more epoch from the checkpoint. Returns ({run:
    launches}, metrics)."""
    from cyclegan_tpu_torch import kernels
    from cyclegan_tpu_torch.config import (Namespace, namespace2yaml,
                                           yaml2namespace)
    from cyclegan_tpu_torch.optimizers import AdaBeliefTF
    from cyclegan_tpu_torch.train import main as train_main
    from cyclegan_tpu_torch.trainer import PROFILE_FILE, CycleGan

    model_cfg = yaml2namespace(ROOT / "configs" / "cycle.yaml")
    model_cfg.update(location=str(workdir / "models"), name="model_options")
    train_cfg = yaml2namespace(TRAIN_CONFIG)
    train_cfg.update(batch_size=BATCH, image_size=SIZE, epochs=1,
                     tpu_layout=True, steps_per_call=3,
                     profile_dir=str(workdir / "profile"), profile_steps=3,
                     g_opt=dict(name="adabelief", learning_rate=2e-4),
                     d_opt=dict(name="rmsprop", learning_rate=2e-4))
    train_cfg.summary = dict(train_cfg.summary, model=1)
    steps_per_epoch = (CLI_IMAGES - int(0.2 * CLI_IMAGES)) // BATCH
    launches, metrics = {}, {}

    def run(label, model_yaml):
        train_yaml = workdir / f"{label}_train_config.yaml"
        namespace2yaml(train_yaml, train_cfg)
        kernels.reset_launches()
        start = time.perf_counter()
        gan = train_main(["--model_config", str(model_yaml),
                          "--train_config", str(train_yaml),
                          "--data_dir", str(workdir / "data"),
                          "--device", DEVICE])
        torch.cuda.synchronize()
        launches[label] = {k: v for k, v in kernels.launches.items() if v}
        metrics[label] = {"seconds": time.perf_counter() - start,
                          "step": gan.state.step, "epochs": gan.history,
                          "launches": launches[label]}
        print(f"trainer {label}: {json.dumps(metrics[label])}", flush=True)
        for record in gan.history:
            values = [*record["train"].values(),
                      *record["validation"].values()]
            if not all(np.isfinite(v) for v in values):
                fail(f"trainer {label}: non-finite metrics {record}")
        return gan

    first = workdir / "model_config_options.yaml"
    namespace2yaml(first, model_cfg)
    gan = run("options", first)
    trace = Path(train_cfg.profile_dir) / PROFILE_FILE
    metrics["profile_bytes"] = trace.stat().st_size if trace.exists() else 0
    kinds = {name: type(opt).__name__
             for name, opt in gan.state.optimizers.items()}
    metrics["optimizers"] = kinds
    if gan.state.step != steps_per_epoch or gan.multi_step_fn is None:
        fail(f"trainer options: step {gan.state.step}, expected "
             f"{steps_per_epoch} in chunks of 3")
    if not metrics["profile_bytes"] or '"traceEvents"' not in \
            trace.read_text():
        fail(f"trainer options: no trace in {trace}")
    if not (isinstance(gan.state.optimizers["g_AB"], AdaBeliefTF)
            and isinstance(gan.state.optimizers["d_A"],
                           torch.optim.RMSprop)):
        fail(f"trainer options: optimizers {kinds}")
    if not gan.tpu_layout or not launches["options"].get("conv_same"):
        fail(f"trainer options: NHCW {gan.tpu_layout}, launches "
             f"{launches['options']}")

    folder = Path(gan.model_folder)
    reloaded = CycleGan(yaml2namespace(folder / "model_config.yaml"),
                        Namespace(dict(train_cfg)), device=DEVICE)
    diffs = _same_state(gan.state, reloaded.state)
    metrics["reload_differences"] = diffs
    if diffs:
        fail(f"trainer options reload differs: {diffs[:8]}")
    del reloaded, gan
    gan = run("options_resume", folder / "model_config.yaml")
    if gan.state.step != 2 * steps_per_epoch:
        fail(f"trainer options resume: step {gan.state.step}, expected "
             f"{2 * steps_per_epoch}")
    return launches, metrics


def kernel_entries(rows, max_err, launches, forwards, serve_plans):
    """The ``kernels`` JSON line: per kernel, its launches in every main
    path's run (``launches`` their sum), and its times summed over the
    launches of one train step of each planned path: the recipes and the
    step's options (``paths`` splits them by train step and by serving
    forward)."""
    from cyclegan_tpu_torch import kernels

    planned = set(rows[0]["per_step"]) if rows else set()
    train_paths = [p for p in launches if p in planned]
    entries = []
    for name in kernels.KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        by_shape = {tuple(r["shape"]): r for r in mine}
        paths = {}
        for path in train_paths:
            used = [(r, r["per_step"][path]) for r in mine
                    if r["per_step"][path]]
            paths[path] = _sums(used, launches[path].get(name, 0))
        for path, plan in serve_plans.items():
            used = [(by_shape[shape], n) for shape, n in
                    collections.Counter(plan.get(name, [])).items()]
            paths[path] = _sums(used, launches[path].get(name, 0))
            paths[path]["forwards"] = forwards[path]
        for path in launches:  # the trainer's runs: launches only
            if path not in paths:
                paths[path] = {"launches": launches[path].get(name, 0)}
        paths = {path: v for path, v in paths.items() if v["launches"]}
        total = _sums([(r, sum(r["per_step"][p] for p in train_paths))
                       for r in mine], 0)
        source, replaces, also = SOURCES[name]
        library = ({"library_call": LIBRARY_NOTES[name]}
                   if name in LIBRARY_NOTES else {})
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "also_replaces": also,
            "launches": sum(launches[p].get(name, 0) for p in launches),
            "max_abs_err": max_err[(name, torch.bfloat16)],
            "max_abs_err_f32": max_err[(name, torch.float32)],
            "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"], "bound_by": total["bound_by"],
            "library_ms": total["library_ms"], **library,
            **({"copy_ms": total["copy_ms"]} if name in COPY_FLOOR
               else {}),
            "timing": "bf16, the median per launch shape summed over the "
                      "launches of one 256x256 train step of each path "
                      "(batch 8; unet_patchgan_train batch 4) "
                      f"({' + '.join(train_paths)})",
            "paths": paths,
        })
    return entries


def _sums(used, launches):
    """ms, plain, bound and library ms over (row, launches) pairs."""
    out = {"launches": launches}
    for key in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms"):
        out[key] = sum(r[key] * n for r, n in used)
    for key in ("library_ms", "copy_ms"):
        out[key] = (None if any(r[key] is None for r, _ in used)
                    else sum(r[key] * n for r, n in used))
    out["bound_by"] = ("operations" if out.pop("ops_ms") > out.pop("bytes_ms")
                       else "bytes")
    return out


def train_and_serve(name, cfg_path, point, batch_size, cfgs, plans,
                    serve_plans, launches, forwards, metrics, out_dir):
    """A seeded recipe trained (``train``) at ``batch_size``, saved with
    ``save_model_folder`` and served from that folder (``serve``)."""
    from cyclegan_tpu_torch.utils.checkpoint import save_model_folder

    train_path, serve_path = f"{name}_train", f"{name}_serve"
    launches[train_path], metrics[train_path], state = train(
        train_path, cfgs[name], plans[train_path], None, out_dir, point,
        batch_size=batch_size)
    stamp(train_path)
    with tempfile.TemporaryDirectory() as tmp:
        save_model_folder(Path(tmp), cfg_path, state.models)
        del state
        (launches[serve_path], forwards[serve_path],
         metrics[serve_path]) = serve(serve_path, Path(tmp),
                                      serve_plans[serve_path], out_dir)
    stamp(serve_path)


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
    from cyclegan_tpu_torch.config import yaml2namespace
    from cyclegan_tpu_torch.kernels import _build

    card = smi_line()
    print(card, flush=True)
    build = _build.build_dir()
    print(f"kernels built in {_build.build_seconds:.1f} s "
          f"(0 = found built) into build/{build.name}", flush=True)
    for log in sorted(build.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "arning" in line:
                print(f"ptxas {log.stem}: {line.strip()}")
    for lib, ops in (("conv_dw", ("HGMMA", "UTMALDG")),
                     ("conv_same", ("HGMMA",))):
        sass = sass_counts(build / f"lib{lib}.so", ops)
        print(f"sass {lib}: {json.dumps(sass)}", flush=True)
        for op, n in sass.items():
            if not n:
                fail(f"{lib}: no {op} instruction in its SASS")

    # the seeded recipes after the default one, each trained then served
    # from the folder the port saves: (name, config file, f32 point, batch)
    seeded = (("resnet", RESNET_CONFIG, RESNET_F32_POINT, BATCH),
              ("unet_transpose", TRANSPOSE_CONFIG, UNET_F32_POINT, BATCH),
              ("strided", STRIDED_CONFIG, UNET_F32_POINT, BATCH))
    # phase 15, after the trainer: the fifth recipe at its own batch
    fifth = (("unet_patchgan", PATCHGAN_CONFIG, UNET_PATCHGAN_F32_POINT,
              PATCHGAN_BATCH),)
    cfgs = {"unet": yaml2namespace(MODEL_DIR / "model_config.yaml"),
            **{name: yaml2namespace(path)
               for name, path, _, _ in seeded + fifth}}
    batches = {name: b for name, _, _, b in seeded + fifth}
    serve_plans = {
        f"{name}_serve": (resnet_generator_launches if name == "resnet"
                          else serve_launches)(cfg.generator, BATCH, SIZE)
        for name, cfg in cfgs.items()}
    if {k: len(v) for k, v in serve_plans["unet_serve"].items()} != {
            "conv_same": 15, "instance_norm_act": 14, "sum2x2": 3,
            "concat_up2": 3}:
        fail(f"generator launch plan {serve_plans['unet_serve']}")
    plans = {f"{name}_train": (resnet_train_launches if name == "resnet"
                               else train_launches)(
                                   cfg, batches.get(name, BATCH), SIZE)
             for name, cfg in cfgs.items()}
    # phases 12-13: the NHWC layout with pallas_norm
    nhwc = (("unet", MODEL_DIR, UNET_NHWC_F32_POINT),
            ("resnet", None, RESNET_F32_POINT))
    for name, _, _ in nhwc:
        plans[f"{name}_train_nhwc"] = nhwc_train_launches(cfgs[name], BATCH,
                                                          SIZE)
    # phases 16-18: the step's options
    plans["unet_train_fused"] = train_launches(cfgs["unet"], BATCH, SIZE,
                                               fuse_apps=True)
    plans["unet_train_remat"] = remat_launches(cfgs["unet"], BATCH, SIZE)
    plans["resnet_train_fused"] = resnet_train_launches(
        cfgs["resnet"], BATCH, SIZE, fuse_apps=True)
    plans["unet_train_paired"] = plans["unet_train_nhwc"]
    paths = {path: with_simt(unique_shapes(plan))
             for path, plan in plans.items()}
    with no_tf32():
        max_err = check_kernels(union_shapes(paths))
        for edge_shapes in (with_simt(unique_shapes(EDGE_CONV_SHAPES)),
                            unique_shapes(EDGE_NORM_SHAPES),
                            unique_shapes(EDGE_JUNCTION_SHAPES),
                            unique_shapes(EDGE_DUP_SHAPES),
                            unique_shapes(EDGE_FOLD_SHAPES),
                            unique_shapes(EDGE_POOL_SHAPES),
                            unique_shapes(EDGE_NHWC_NORM_SHAPES)):
            edge = check_kernels(edge_shapes, "edge ")
            for key, err in edge.items():
                max_err[key] = max(max_err.get(key, 0.0), err)
        for name, want in PATH_KERNELS.items():
            for dtype in (torch.bfloat16, torch.float32):
                took = paths_run[(name, dtype)]
                print(f"paths {name} {dtype}: {sorted(took)}")
                if took != want:
                    fail(f"{name} {dtype}: phase 2 ran only {took}")
        stamp("phase 2 (kernel checks)")
        rows = time_kernels(paths)
        stamp("phase 3 (kernel times)")
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)

    launches, forwards, metrics = {}, {}, {}
    launches["unet_serve"], forwards["unet_serve"], metrics["unet_serve"] = \
        serve("unet_serve", MODEL_DIR, serve_plans["unet_serve"], out_dir)
    stamp("phase 4 (unet_serve)")
    launches["unet_train"], metrics["unet_train"], _ = train(
        "unet_train", cfgs["unet"], plans["unet_train"], MODEL_DIR, out_dir)
    stamp("phase 5 (unet_train)")
    for name, cfg_path, point, batch_size in seeded:
        train_and_serve(name, cfg_path, point, batch_size, cfgs, plans,
                        serve_plans, launches, forwards, metrics, out_dir)
    for name, model_dir, point in nhwc:
        path = f"{name}_train_nhwc"
        launches[path], metrics[path], _ = train(
            path, cfgs[name], plans[path], model_dir, out_dir, point,
            tpu_layout=False, pallas_norm=True)
        stamp(path)
    with tempfile.TemporaryDirectory() as tmp:
        cli_launches, metrics["trainer_cli"] = trainer_cli(Path(tmp))
        launches.update(cli_launches)
        stamp("phase 14 (trainer CLI)")
        for name, cfg_path, point, batch_size in fifth:
            train_and_serve(name, cfg_path, point, batch_size, cfgs, plans,
                            serve_plans, launches, forwards, metrics,
                            out_dir)
        stamp("phase 15 (unet_patchgan)")
        option_launches, metrics["unet_options"] = unet_options(
            cfgs["unet"], plans, out_dir)
        launches.update(option_launches)
        stamp("phase 16 (U-Net options)")
        (launches["resnet_train_fused"],
         metrics["resnet_fuse_apps"]) = resnet_fuse_apps(cfgs["resnet"],
                                                         plans, out_dir)
        stamp("phase 17 (ResNet fuse_apps)")
        paired_launches, metrics["paired"] = paired(cfgs["unet"], plans,
                                                    out_dir)
        launches.update(paired_launches)
        stamp("phase 18 (paired)")
        option_launches, metrics["trainer_options"] = trainer_options(
            Path(tmp))
        launches.update({f"trainer_cli_{k}": v
                         for k, v in option_launches.items()})
        stamp("phase 19 (trainer CLI options)")

    entries = kernel_entries(rows, max_err, launches, forwards, serve_plans)
    for path, plan in {**plans, **serve_plans}.items():
        for name in plan:
            if not launches[path].get(name):
                fail(f"{name}: no launch on {path}")
    if out_dir is not None:
        (out_dir / "chip_smoke_detail.json").write_text(json.dumps(
            {"card": card, "kernels": entries, "launch_rows": rows,
             **metrics}, indent=1))
    for path, m in metrics.items():
        print(json.dumps({path: {k: v for k, v in m.items()
                                 if k not in ("quality", "losses")}}))
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
