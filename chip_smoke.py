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
   must run their tap-ring design there (``kernels.paths``
   ``conv_dw.ring`` / ``conv_reflect_dw.ring`` once per launch, no
   ``.simt``; every K9-dW shape of U-GAT-IT's step included, and each bf16
   dW twice, which must give the same bits), and ``conv_dw_simt`` (their
   CUDA-core
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
   ``conv_same_simt`` launch), and the outputs are held against the plain
   f32 session on the CPU, in NHCW, as the card's f32 session serves
   (``tpu_layout=True``: K1's f32 design). Then serving img/s;
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
    its first (eager) step's peak memory below the plain step's,
    asserted) and dropout in the
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
    more epoch from the checkpoint;
20. serving layouts (``serving_layouts``): converged256 in bf16 with
    ``tpu_layout`` "auto" (NHCW on the card, the U-Net plan each forward)
    and False (NHWC: cuDNN and torch ops, no kernel launch at all), each
    within the serving bounds of the plain f32 NHWC session on the CPU, the
    card's f32 NHWC session within SERVE_F32_MAX of it; each layout's
    request img/s, device ms a request and generator forward ms;
21. the 512x512 TFRecord -> PNG export (``export_512``, BASELINE config
    #5): seeded 256x256 PNGs sharded by ``tfrecord_writer``,
    ``export_records`` at 512 and batch 8 (a padded tail), every forward
    the U-Net plan at 512; K1-K4 held against their plain versions at every
    unique 512x512 launch shape and timed, as phases 2 and 3 do; two
    exported images within the serving bounds of the CPU f32 session;
    export img/s and PNG encode ms an image;
22. the HTTP server (``http_server``) on 127.0.0.1: ``/healthz``,
    sequential batch-1 requests (latency p50/p99 and the server's decode,
    resize, stylize and encode ms), Paeth-filtered PNGs apart, requests in
    flight at once on an NHCW and an NHWC server (each reply its serial
    one: the layout scope is per thread), 400 for a bad direction and for a
    JPEG without a decoder, every reply ``session.stylize``'s;
23. evaluation (``evaluation``) on phase 21's records: ``evaluate`` on the
    card against the CPU (no kernel launched), ``evaluate_quality`` in
    bf16 (the U-Net plan each forward; proxy features against the CPU's);
24. batch norm (``batchnorm``): ``configs/cycle.yaml`` with
    ``normalization: batchnorm`` in all four networks, seeded weights,
    bf16, NHCW, batch 8: one step launches K1, K3, K4, K5, K7 and K8 as
    ``batchnorm_launches`` plans (the U-Net plan without its norms) and no
    K2, K6 or K13; 3 steps move every network and moving statistic, 10
    are timed (img/s, device busy ms, idle share, host issue ms, peak
    MiB); the f32 step at ``BN_F32_POINT`` on the card against the plain
    CPU step (gradients within TRAIN_F32_REL, the kept moving statistics
    within STATS_REL, kink-free) and bf16 within RATIO times the plain
    bf16 step's error; a checkpoint reloaded exactly; the trained networks
    served on their moving statistics in NHCW and NHWC within the serving
    bounds of the CPU f32 session;
25. the data layer (``data_layer``) on phase 14's records: the streaming
    loader's batches equal to the memory loader's for epochs 0 and 1; the
    trainer CLI with ``data_loader: streaming`` (NHCW); whether the native
    loader built (else the compiler's first error line), its decode
    against the Python path's and ms per image of both, and the images
    each path decoded in the run; the 256x256 Average and Paeth PNG
    decode, the C unfilter against the Python byte loops;
26. data parallelism (``world1_nccl``, ``data_parallel``): first whether
    NCCL takes two ranks on the one card (it refuses a duplicate GPU; the
    error is printed); (a) a process group of one over NCCL, one U-Net
    step (``configs/cycle.yaml``, bf16, NHCW, batch 8, jitter inside)
    through ``CycleGan(mesh=create_mesh(1))``, its launches the default
    plan and its parameters equal bit for bit to a CycleGan's without a
    mesh; (b) RANKS ranks spawned on the one card over gloo, a data mesh,
    global batch 8: the f32 gradients after the all-reduce against one
    batch-8 card step within TRAIN_F32_REL, batch norm (``batchnorm_config``
    at BN_DP_SIZE²) with ``dp_shard_map`` false against one batch-8 step
    and true against the mean of one step per half (moving statistics
    within STATS_REL), each rank's bf16 launches ``train_launches`` at
    batch 4, three finite steps, img/s of the two ranks on one card (not a
    scaling number) and the gradient all-reduce's time; (c)
    (``resnet_data_parallel``) the ResNet recipe from seeded weights on the
    same two ranks: its f32 gradients against one batch-8 card step at
    RESNET_DP_F32_POINT within TRAIN_F32_REL and, at 256², against the mean
    of one step on each rank's half within RESNET_DP_HALVES_REL (cuDNN's
    deterministic algorithms), each rank's bf16 launches
    ``resnet_train_launches`` at batch 4 (K9, K9-dW, K10, K1, K5, K2, K6),
    the device busy time of a rank step and the all-reduce's time;
27. spatial sharding (``spatial``): RANKS ranks, ``create_spatial_mesh(1,
    RANKS)``, ``dp_shard_map``: the f32 step at SPATIAL_F32_POINT (full
    size, the nearest kink reported) and at SPATIAL_KINK_FREE_POINT (no
    ReLU input within KINK_MARGIN, asserted) against the unsharded card
    step within TRAIN_F32_REL; each rank's bf16 step at
    batch 8 against ``spatial_launches`` (K1 and K5 on the halo-extended
    strips, K3, K4, K7, K8 on the strips, no K2 or K6), three finite
    steps, timing; converged256 served at 512² through
    ``InferenceSession(spatial_devices=RANKS)`` on every rank, within the
    serving bounds of the unsharded f32 and bf16 card sessions, its launches
    ``spatial_launches`` of the serving plan each forward; (c)
    (``spatial_server_paired``) one 512² PNG through
    ``apps.server.serve(spatial_devices=RANKS)`` on both ranks (rank 0
    answers HTTP and broadcasts the request), the reply bit-equal to the
    ranks' spatial ``stylize`` and within the serving bounds, its forward
    ``spatial_launches`` of the batch-1 serving plan, the follower done
    after the warm-ups and the request; (d) the paired f32 step (NHWC)
    on the strips at SPATIAL_KINK_FREE_POINT against one rank's paired
    step within PAIRED_SPATIAL_REL, no hand kernel launched;
28. the reference import (``import_reference``): converged256 written in
    the reference's layout (``write_reference_folder``: four TensorFlow
    tensor bundles written by ``write_bundle``, Adam ``.npy`` slots of
    IMPORT_ITERATIONS iterations), imported on the card without
    TensorFlow; a bf16 NHCW batch-8 forward of the import bit-equal to
    converged256's, with the serving plan's launches; one f32 step resumed
    from it bit-equal, in every parameter and Adam slot, to a step from a
    state built straight from the same parameters and slots;
29. U-GAT-IT (``ugatit``, ``UGATIT_CONFIG``: the full model at its
    published widths): K14 and K15 (AdaLIN/ILN) against their plain
    versions at every launch shape of a batch-8 256x256 train step and
    serving forward and at ``UGATIT_EDGE_NORM_SHAPES``, bf16 and f32, both
    paths (16-byte units, one element), each bf16 case twice bit-equal;
    both timed beside their bytes' least time; then the trainer's step at
    batch 8 eager, captured and replayed, each moving every one of the
    discriminators' ``UGATIT_SN_BUFFERS`` spectral-norm ``u`` vectors (its
    power iterations ran, on a replay too) with 60 K14 and 60 K15
    launches, finite losses, img/s over five replays and the peak memory
    with the graph's pool. Its train step is the ``ugatit_train`` path of
    the kernels line: K14/K15 timed at its shapes, the other kernels'
    launches counted.

Phase 2 checks, and phase 3 times, every unique launch shape of every
plan, the option phases' batch-16 and batch-4 shapes and the strips'
extended shapes of phases 26-27 included; phases 21 and 27 do the same for
the 512x512 serving forwards, and phase 28 checks its f32 step's shapes. A failed rank, a collective error or a kernel
error fails the run; no phase catches its own failure.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the kernels' numbers as JSON.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import gc
import itertools
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
EXPORT_SIZE = 512        # phase 21: BASELINE config #5's resolution
EXPORT_IMAGES = 20       # a domain: two batches of 8 and a padded tail
HTTP_REQUESTS = 32       # phase 22: sequential batch-1 requests
HTTP_PAETH = 4           # ...and requests whose PNG rows are Paeth-filtered
HTTP_CONCURRENT = 4      # requests in flight at once, in each round
HTTP_ROUNDS = 3
STRESS_THREADS = 4       # threads stylizing on one session at once...
STRESS_CALLS = 25        # ...each this many times

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
    "ada_norm": (_CSRC + "ada_norm.cu", None, []),
    "ada_norm_bwd": (_CSRC + "ada_norm.cu", None, []),
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
                 "instance_norm_nhwc", "conv_dw", "conv_reflect_dw")
# kernel-name fragments of the profiler trace -> kernel family
TRACE_FAMILIES = (
    ("conv_same_tc_kernel", "conv_same"), ("conv_same_pack_kernel", "conv_same"),
    ("conv_reflect_tc_kernel", "conv_reflect"),
    ("conv_reflect_pack_kernel", "conv_reflect"),
    ("conv_same_simt_kernel", SIMT_SAME),
    ("conv_reflect_simt_kernel", SIMT_SAME),
    ("conv_reflect_dw_tma_kernel", "conv_reflect_dw"),
    ("reflect_sum_splits_kernel", "conv_reflect_dw"),
    ("conv_reflect_dw_partial_kernel", SIMT),
    ("reflect_fold_kernel", "reflect_fold"),
    ("conv_dw_tma_kernel", "conv_dw"), ("conv_dw_partial_kernel", SIMT),
    ("sum_splits_kernel", "conv_dw"),
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
# evaluation on the card (phase 23): the validate step's metrics against
# the CPU's (f32, cuDNN with TF32 off against ATen: sums in another order);
# the proxy features (f32 convs with TF32 off), relative to their largest
EVAL_REL = 1e-3
FEATURE_REL = 1e-4
# fuse_apps on the card (phase 16): the fused step's f32 gradients against
# the unfused step's; the same math, with the batch sums of the fused
# applications' weight gradients in another order
FUSED_F32_REL = 1e-5
# Batch norm (phase 24): the kernels its U-Net must not launch, the norms
# running in torch ops; its f32 point, seeded weights with every affine
# norm's beta at +-(3..4) and seeded input, batch 2 at 32x32 (no ReLU input
# within KINK_MARGIN of zero, asserted); the kept moving statistics of the
# f32 card step within STATS_REL of the CPU's (0.99 old + 0.01 batch: the
# batch statistics' f32 sums in another order, damped)
BN_UNLAUNCHED = ("instance_norm_act", "instance_norm_act_bwd",
                 "instance_norm_nhwc")
BN_F32_POINT = {"size": 32, "batch": 2, "seed": 0, "beta": [3.0, 4.0]}
STATS_REL = 1e-5
# Phases 26-27: ranks that share the one card (NCCL refuses two ranks on
# one device, so they use gloo, which takes CUDA tensors in all_reduce and
# broadcast), their deadline, steps timed on each; the group of one in
# phase 26 (a); phase 26's batch-norm check (f32, batch BATCH at
# BN_DP_SIZE², seeded weights with the betas moved); phase 27's f32 points
# (converged256 with every beta at +-(3..4), batch 1) and its spatial
# serving (converged256 at 512², 2 images). At full size the nearest kink
# the strips met is reported, not asserted: an instance norm over 256²
# pixels a channel puts some normalized input within an f32 ulp of -beta
# (on the card it met 0.0; at 64² seeds 0-29 on the CPU came 4.8e-7 to
# 6.7e-5 from theirs). So the comparison is repeated at 64², seed 29, where
# no ReLU input lies within KINK_MARGIN (asserted on the strips).
RANKS = 2
RANK_PATHS = ("dp_train", "spatial_train", "resnet_dp_train")
RANK_TIMEOUT = 480
RANK_STEPS_TIMED = 5
WORLD1_BACKEND = "nccl"
BN_DP_SIZE = 64
BN_DP_POINT = {"seed": 24, "beta": [3.0, 4.0]}
SPATIAL_F32_POINT = {"size": 256, "batch": 1, "seed": 2, "beta": [3.0, 4.0]}
SPATIAL_KINK_FREE_POINT = {"size": 64, "batch": 1, "seed": 29,
                           "beta": [3.0, 4.0]}
SPATIAL_SERVE_SIZE = EXPORT_SIZE
SPATIAL_SERVE_BATCH = 2
# Phase 27 (d): the paired step on the strips against one rank's paired
# step, f32 at SPATIAL_KINK_FREE_POINT: the same convolutions (cuDNN on the
# halo-extended strips, TF32 off) and norm sums in another order
PAIRED_SPATIAL_REL = 1e-5
# Phase 26 (c): the ResNet's f32 gradients on the data ranks. At 256², batch
# 8, they moved by 6.4e-4 to 9.8e-4 of the generators' gradients from one
# card step to the next on an H100 (cuDNN's stride-2 and transposed convs
# sum in an order that changes from run to run, and this recipe's
# generators, nine residual blocks of non-affine norms at random init,
# amplify it), too close to TRAIN_F32_REL for a bound. So the step of one
# rank at batch 8 is compared at RESNET_DP_F32_POINT (phase 6's f32 point,
# batch 8), and at 256² each rank's step against one card step on its
# half, both with cuDNN's deterministic algorithms, within
# RESNET_DP_HALVES_REL: the same shapes, so only the all-reduce differs.
RESNET_DP_F32_POINT = dict(RESNET_F32_POINT, batch=BATCH)
RESNET_DP_HALVES_REL = 1e-6
# Phase 28: the reference's Adam iterations in the written folder, and the
# seed of its Adam slots and of the step's inputs
IMPORT_ITERATIONS = 1234
IMPORT_SEED = 28
# the native loader's decode against the Python path's, in uint8 steps
# (the JAX package's own bound for its native loader)
NATIVE_MAX_STEPS = 2
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
        H, W = _hw(H)
        ho, wo = H + 2 * grow, W + 2 * grow
        x = rnd(B, H, cin, W)
        w = rnd(k, k, cin, cout, scale=0.05)
        b = rnd(cout, scale=0.5) if has_bias else None
        before, after = pad + grow, k - 1 - pad + grow
        xp = F.pad(nchw(x), (before, after, before, after))
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        nbytes = (x.numel() + w.numel() + (cout if has_bias else 0)
                  + B * ho * cout * wo) * size
        kernel = (cuda_conv.conv_same_cuda if name == "conv_same"
                  else cuda_conv.conv_same_simt_cuda)
        return (lambda: (kernel(x, w, b, pad=pad, grow=grow),),
                lambda: (cuda_conv.conv_same_plain(x, w, b, pad=pad,
                                                   grow=grow),),
                lambda: F.conv2d(xp, w_oihw, b),
                nbytes, 2 * B * ho * wo * k * k * cin * cout,
                [(name, 1.0)])
    if name == "conv_dw" or (name == SIMT and shape[5] >= 0):
        B, H, cin, cout, k, pad = shape
        H, W = _hw(H)
        x = rnd(B, H, cin, W)
        gy = rnd(B, H, cout, W)
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
                2 * B * H * W * k * k * cin * cout, [(name, scale)])
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
        # bytes: x and g read once, dW written once (the split partial
        # sums are the kernel's own traffic, not the function's)
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
        H, W = _hw(H)
        x = rnd(B, H, c, W)
        if len(shape) > 3 and shape[3]:
            x = off_view(x)
        out = x.numel() // 4
        return (lambda: (cuda_resize.sum2x2_cuda(x, 0.25),),
                lambda: (cuda_resize.sum2x2_plain(x, 0.25),),
                lambda: F.avg_pool2d(nchw(x), 2),
                (x.numel() + out) * size, 4 * out, [(name, 1.0)])
    if name == "dup2x2":
        B, h, c = shape[:3]
        h, w = _hw(h)
        gy = rnd(B, h, c, w)
        if len(shape) > 3 and shape[3]:
            gy = off_view(gy)
        x_shape = torch.empty((B, c, 2 * h, 2 * w), dtype=dtype,
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
        H, W = _hw(H)
        skip = rnd(B, H, c1, W)
        x = rnd(B, H // 2, c2, W // 2)
        if len(shape) > 4 and shape[4]:
            skip, x = off_view(skip), off_view(x)
        return (lambda: (cuda_concat.concat_up2_cuda(skip, x),),
                lambda: (cuda_concat.concat_up2_plain(skip, x),),
                lambda: torch.cat([skip, F.interpolate(
                    nchw(x), scale_factor=2,
                    mode="nearest").permute(0, 2, 1, 3)], dim=2),
                (skip.numel() + x.numel() + B * H * (c1 + c2) * W) * size,
                0, [(name, 1.0)])
    if name == "split_pool2":
        B, H, c1, c2 = shape[:4]
        H, W = _hw(H)
        gy = rnd(B, H, c1 + c2, W)
        if len(shape) > 4 and shape[4]:
            gy = off_view(gy)
        pooled = B * (H // 2) * c2 * (W // 2)
        g_nchw = nchw(gy[:, :, c1:])
        return (lambda: cuda_concat.split_pool2_cuda(gy, c1),
                lambda: cuda_concat.split_pool2_plain(gy, c1),
                lambda: (gy[:, :, :c1].contiguous(),
                         torch.ops.aten.upsample_nearest2d_backward(
                             g_nchw, [H, W], [B, c2, H // 2, W // 2])),
                (gy.numel() + B * H * c1 * W + pooled) * size, 3 * pooled,
                [(name, 1.0), (name, 1.0)])
    if name == "concat2":
        B, H, c1, c2 = shape
        H, W = _hw(H)
        a = rnd(B, H, c1, W)
        b = rnd(B, H, c2, W)
        return (lambda: (cuda_concat.concat2_cuda(a, b),),
                lambda: (cuda_concat.concat2_plain(a, b),),
                lambda: torch.cat([a, b], dim=2),
                2 * B * H * (c1 + c2) * W * size, 0, [(name, 1.0)])
    if name == "split2":
        B, H, c1, c2 = shape
        H, W = _hw(H)
        gy = rnd(B, H, c1 + c2, W)
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


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, and PyTorch's default again
    after."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


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


def shape_order(shape):
    """A sort key for launch shapes whose side may be an int (square) or a
    (rows, columns) pair (a strip): each entry as a tuple, so both sides
    compare and the square plans keep their order."""
    return tuple(v if isinstance(v, tuple) else (v,) for v in shape)


def _hw(side):
    """(rows, columns) of a launch shape's side: an int is square."""
    return side if isinstance(side, tuple) else (side, side)


def unique_shapes(plan):
    """{kernel: Counter(shape -> launches per step)}."""
    return {name: collections.Counter(shapes) for name, shapes in
            plan.items()}


def check_kernels(shapes, label=""):
    """Phase 2: kernel vs plain at every unique launch shape, bf16 and
    f32. Returns the largest absolute error per (kernel, dtype). bf16 K5
    and K9-dW must run their tap-ring design (``kernels.paths``
    ``<kernel>.ring`` once a call, no ``conv_dw_simt`` launch), bf16 K1
    and K9 their tensor-core design (no ``conv_same_simt`` launch); the
    bf16 kernels of ``DETERMINISTIC`` must give the same bits in a second
    run."""
    from cyclegan_tpu_torch import kernels

    max_err = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, counter in shapes.items():
            worst = 0.0
            for i, shape in enumerate(sorted(counter, key=shape_order)):
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
                if dtype == torch.bfloat16 and name in ("conv_dw",
                                                        "conv_reflect_dw"):
                    calls = 1 + (name in DETERMINISTIC)
                    ring = kernels.paths[name + ".ring"] - before[
                        name + ".ring"]
                    if kernels.launches[SIMT] != simt or ring != calls:
                        fail(f"{name} {shape} bf16 ran the CUDA-core "
                             f"design, not the tap-ring one")
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
        geo = cuda_resize.dup2x2_geometry(B, _hw(h)[0], c, _hw(h)[1], esize,
                                          aligned)
    elif name == "sum2x2":
        B, H, c = shape[:3]
        geo = cuda_resize.sum2x2_geometry(B, _hw(H)[0], c, _hw(H)[1], esize,
                                          aligned)
    elif name in ("concat_up2", "split_pool2"):
        B, H, c1, c2 = shape[:4]
        geo = cuda_concat.concat_up2_geometry(B, _hw(H)[0], c1, c2,
                                              _hw(H)[1], esize, aligned)
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
    return {name: sorted(shapes, key=shape_order)
            for name, shapes in out.items()}


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


def _launched():
    """The kernel launches counted since the last reset, those above 0."""
    from cyclegan_tpu_torch import kernels

    return {k: v for k, v in kernels.launches.items() if v}


def _times(plan, forwards):
    """``plan``'s launches per kernel ({kernel: shapes}) times
    ``forwards``."""
    return {name: len(shapes) * forwards for name, shapes in plan.items()}


def _generator_call(session, image, direction="a2b"):
    """The session's generator alone on ``image`` (uint8 NHWC), in the
    session's layout and dtype: what ``stylize`` runs between its host
    copies."""
    from cyclegan_tpu_torch.data.augment import normalize
    from cyclegan_tpu_torch.ops import layout

    model = session.models[{"a2b": "g_AB", "b2a": "g_BA"}[direction]]
    x = normalize(torch.as_tensor(image).to(DEVICE)).to(
        session.compute_dtype)
    if session.tpu_layout:
        x = layout.to_nhcw(x)

    def run():
        with torch.inference_mode(), layout.scope(
                "NHCW" if session.tpu_layout else "NHWC"):
            return model(x)

    return run


def _request_rate(session, image):
    """Whole ``stylize`` requests on the host clock (uint8 in and out):
    median ms and img/s after 3 warm-ups."""
    for _ in range(3):
        session.stylize(image, "a2b")
    walls = []
    for _ in range(TIMED_REPS):
        t0 = time.perf_counter()
        session.stylize(image, "a2b")
        walls.append(time.perf_counter() - t0)
    ms = statistics.median(walls) * 1e3
    return {"request_ms_median": ms, "img_per_s": len(image) / ms * 1e3}


def serving_quality(label, out, ref, plain16, card32=None):
    """The serving bounds: the card's bf16 uint8 output ``out`` against the
    plain f32 session's ``ref`` on the CPU, in uint8 steps (mean, share of
    pixels more than SERVE_FAR off, worst), each within its absolute bound
    or RATIO times the plain bf16 session's own (``plain16``) where larger;
    the card's f32 output ``card32``, where given, within SERVE_F32_MAX.
    Returns the numbers."""
    ref = ref.astype(int)
    if out.shape != ref.shape or out.dtype != np.uint8:
        fail(f"{label}: output {out.shape} {out.dtype}")
        return {}
    d = np.abs(out.astype(int) - ref)
    d_plain = np.abs(plain16.astype(int) - ref)
    q = {"bf16_card_vs_f32_cpu_max": int(d.max()),
         "bf16_card_vs_f32_cpu_mean": float(d.mean()),
         "bf16_card_share_beyond_8": float((d > SERVE_FAR).mean()),
         "bf16_cpu_vs_f32_cpu_max": int(d_plain.max()),
         "bf16_cpu_vs_f32_cpu_mean": float(d_plain.mean())}
    if card32 is not None:
        q["f32_card_vs_f32_cpu_max"] = int(np.abs(card32.astype(int)
                                                  - ref).max())
    print(f"{label} quality {json.dumps(q)}", flush=True)
    q["bf16_cpu_share_beyond_8"] = float((d_plain > SERVE_FAR).mean())
    mean_max = max(SERVE_MEAN_MAX, RATIO * q["bf16_cpu_vs_f32_cpu_mean"])
    share_max = max(SERVE_FAR_SHARE, RATIO * q["bf16_cpu_share_beyond_8"])
    if q["bf16_card_vs_f32_cpu_mean"] > mean_max:
        fail(f"{label}: mean uint8 diff {q['bf16_card_vs_f32_cpu_mean']} > "
             f"{mean_max}")
    if q["bf16_card_share_beyond_8"] > share_max:
        fail(f"{label}: share of pixels > {SERVE_FAR} off "
             f"{q['bf16_card_share_beyond_8']} > {share_max}")
    if q["bf16_card_vs_f32_cpu_max"] > max(
            SERVE_FAR, RATIO * q["bf16_cpu_vs_f32_cpu_max"]):
        fail(f"{label}: max uint8 diff {q['bf16_card_vs_f32_cpu_max']} "
             f"beyond 1.5x the plain bf16 session's "
             f"{q['bf16_cpu_vs_f32_cpu_max']}")
    if q.get("f32_card_vs_f32_cpu_max", 0) > SERVE_F32_MAX:
        fail(f"{label}: f32 card vs cpu max "
             f"{q['f32_card_vs_f32_cpu_max']} > {SERVE_F32_MAX}")
    return q


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

    # the f32 sessions in the NHCW layout: the card's runs K1's f32 design
    cpu32 = InferenceSession(model_dir, "float32", tpu_layout=True,
                             device="cpu")
    cpu16 = InferenceSession(model_dir, "bfloat16", tpu_layout=True,
                             device="cpu")
    card32 = InferenceSession(model_dir, "float32", tpu_layout=True,
                              device=DEVICE)
    quality = []
    for b, direction in requests:
        ref = cpu32.stylize(images[b], direction)
        q = serving_quality(
            f"{label} {b} {direction}", outputs[(b, direction)], ref,
            cpu16.stylize(images[b], direction),
            card32.stylize(images[b], direction))
        quality.append({"batch": b, "direction": direction, **q})

    # throughput at batch 8: whole requests on the host clock (uint8 in,
    # uint8 out), then the generator alone on CUDA events
    image = images[BATCH]
    rate = _request_rate(session, image)
    forward = _generator_call(session, image)
    fwd_ms = time_ms(forward)
    torch.cuda.reset_peak_memory_stats()
    forward()
    torch.cuda.synchronize()
    enqueue = []  # host time to issue one forward, the card idle before
    for _ in range(TIMED_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        enqueue.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    trace = device_trace(forward, out_dir, 5, f"{label}_forward_trace.json")
    metrics = {
        "batch": BATCH, "size": SIZE, "compute_dtype": "bfloat16", **rate,
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

    def jitter(generator, a, b, rows=None):
        return (random_jitter_batch(generator, a, SIZE, rows),
                random_jitter_batch(generator, b, SIZE, rows))

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
    for name in ("conv_dw", "conv_reflect_dw"):
        if kernels.paths[name + ".ring"] != kernels.launches[name]:
            fail(f"{label}: {kernels.launches[name]} {name} launches, "
                 f"{kernels.paths[name + '.ring']} on the tap-ring design")
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


def _jitter(generator, a, b, rows=None):
    from cyclegan_tpu_torch.data.augment import random_jitter_batch

    return (random_jitter_batch(generator, a, SIZE, rows),
            random_jitter_batch(generator, b, SIZE, rows))


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
    device memory (without a replayed step's CUDA graph pool), and its
    device time and idle share from a profiler trace of 3 steps.
    Returns {label: result}."""
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
    the plain step's on the same inputs and generator state; its first
    (eager) step's peak memory lower, asserted; step times both ways) and
    dropout (5 finite steps that move every network; a training-mode
    generator forward on the card against the plain one on the CPU with
    the same masks). Returns
    ({path: launches}, metrics)."""
    from cyclegan_tpu_torch.ops import layout

    batch = _uint8_batch(BATCH)
    launches, metrics = {}, {}

    # 16.1-16.2: the fused, plain and remat steps, each from a fresh
    # state on the same batch and generator state, timed side by side;
    # the peak memory of each one's first call, which runs eager (a
    # replayed step's activations lie in its CUDA graph's pool, which
    # max_memory_allocated does not count)
    runs, first, first_peak_mib = [], {}, {}
    for label, plan, kw in (
            ("unet_train_fused", "unet_train_fused", {"fuse_apps": True}),
            ("unet_train_unfused", "unet_train", {}),
            ("unet_train_remat", "unet_train_remat", {"remat": True})):
        torch.cuda.reset_peak_memory_stats()
        state, step, got, first[label], _ = planned_step(
            label, model_cfg, plans[plan], MODEL_DIR, batch, **kw)
        first_peak_mib[label] = torch.cuda.max_memory_allocated() / 2**20
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
    peaks = {k: first_peak_mib[f"unet_train_{k}"]
             for k in ("remat", "unfused")}
    print(f"unet first (eager) step peak MiB: {json.dumps(peaks)}",
          flush=True)
    if not peaks["remat"] < peaks["unfused"]:
        fail(f"unet remat: first-step peak {peaks['remat']} MiB, not below "
             f"the plain step's {peaks['unfused']}")
    metrics["remat"] = {"remat": remat, "plain": plain,
                        "gradients_vs_plain": diff,
                        "first_step_peak_mib": peaks}

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


def serving_layouts(cfg, out_dir):
    """Phase 20: converged256 served bf16 at batch 8 with ``tpu_layout``
    "auto", which must pick NHCW on the card (each forward the U-Net plan),
    and False, NHWC (cuDNN and torch ops: no kernel launch at all). Both
    bf16 outputs within the serving bounds of the plain f32 NHWC session on
    the CPU, the card's f32 NHWC output (TF32 off in its library convs)
    within SERVE_F32_MAX of it; then each layout's request img/s, device
    busy ms per request and generator forward ms."""
    from cyclegan_tpu_torch import kernels
    from cyclegan_tpu_torch.apps.inference import InferenceSession

    per_forward = serve_launches(cfg.generator, BATCH, SIZE)
    image = np.random.default_rng(20).integers(
        0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    sessions = {"nhcw": InferenceSession(MODEL_DIR, "bfloat16",
                                         device=DEVICE),
                "nhwc": InferenceSession(MODEL_DIR, "bfloat16",
                                         tpu_layout=False, device=DEVICE)}
    if not sessions["nhcw"].tpu_layout:
        fail("serving layouts: tpu_layout auto is not NHCW on the card in "
             "bf16")
    card32 = InferenceSession(MODEL_DIR, "float32", tpu_layout=False,
                              device=DEVICE)
    cpu32 = InferenceSession(MODEL_DIR, "float32", tpu_layout=False,
                             device="cpu")
    cpu16 = InferenceSession(MODEL_DIR, "bfloat16", tpu_layout=False,
                             device="cpu")
    launches, metrics = {}, {}
    for way, session in (*sessions.items(), ("nhwc_f32", card32)):
        kernels.reset_launches()
        outputs = {d: session.stylize(image, d) for d in ("a2b", "b2a")}
        torch.cuda.synchronize()
        launches[way] = _launched()
        want = _times(per_forward, 2) if way == "nhcw" else {}
        if launches[way] != want:
            fail(f"serving layouts {way}: launches {launches[way]}, "
                 f"expected {want}")
        metrics[way] = {"launches": launches[way], "quality": {}}
        for d, out in outputs.items():
            ref = cpu32.stylize(image[:2], d)
            if way == "nhwc_f32":
                far = int(np.abs(out[:2].astype(int) - ref).max())
                metrics[way]["quality"][d] = {"f32_card_vs_f32_cpu_max": far}
                print(f"serving layouts {way} {d}: f32 card vs cpu max "
                      f"{far}", flush=True)
                if far > SERVE_F32_MAX:
                    fail(f"serving layouts {way} {d}: f32 card vs cpu max "
                         f"{far} > {SERVE_F32_MAX}")
            else:
                metrics[way]["quality"][d] = serving_quality(
                    f"serving layouts {way} {d}", out[:2], ref,
                    cpu16.stylize(image[:2], d))
    for way, session in sessions.items():
        m = metrics[way]
        m.update(_request_rate(session, image))
        m["forward_ms_median"] = time_ms(_generator_call(session, image))
        m["trace"] = device_trace(lambda: session.stylize(image, "a2b"),
                                  out_dir, 5, f"serve_{way}_trace.json")
        busy = (m["trace"] or {}).get("device_busy_ms_per_call")
        print(f"serving layouts {way}: {m['img_per_s']:.1f} img/s per "
              f"batch-{BATCH} request (median {m['request_ms_median']:.3f} "
              f"ms), generator forward {m['forward_ms_median']:.3f} ms, "
              f"device busy {busy} ms a request", flush=True)
    return {"unet_serve_auto": launches["nhcw"]}, metrics


def export_512(cfg, workdir, out_dir):
    """Phase 21: the 512x512 TFRecord -> PNG export (BASELINE config #5).
    ``EXPORT_IMAGES`` seeded 256x256 images a domain written as PNGs and
    sharded by ``tfrecord_writer``; ``export_records`` at 512, batch 8 (two
    batches and a padded tail, bf16, NHCW on the card), each forward the
    U-Net plan at 512; two exported images (the first and the tail's last)
    within the serving bounds of the plain f32 session on the CPU. Returns
    the records of both domains (phase 23 evaluates on them), the path's
    launches and plan, and its metrics."""
    from cyclegan_tpu_torch import kernels
    from cyclegan_tpu_torch.apps.export import export_records
    from cyclegan_tpu_torch.apps.inference import InferenceSession
    from cyclegan_tpu_torch.data import codec
    from cyclegan_tpu_torch.data.pipeline import _load_domain
    from cyclegan_tpu_torch.data.tfrecord import tfrecord_writer

    rng = np.random.default_rng(21)
    records = {}
    t0 = time.perf_counter()
    for domain in ("a", "b"):
        src = workdir / f"export_images_{domain}"
        src.mkdir()
        for i in range(EXPORT_IMAGES):
            (src / f"{i:03d}.png").write_bytes(codec.encode_png_bgr(
                rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)))
        records[domain] = [str(p) for p in tfrecord_writer(
            src, workdir / f"records_{domain}", seed=0)]
    write_s = time.perf_counter() - t0

    plan = serve_launches(cfg.generator, BATCH, EXPORT_SIZE)
    forwards = math.ceil(EXPORT_IMAGES / BATCH)
    out = workdir / "exports"
    kernels.reset_launches()
    t0 = time.perf_counter()
    written = export_records(records["a"], MODEL_DIR, out, "a2b",
                             size=EXPORT_SIZE, batch=BATCH, device=DEVICE)
    export_s = time.perf_counter() - t0
    launches = _launched()
    if launches != _times(plan, forwards):
        fail(f"export 512: launches {launches}, expected "
             f"{_times(plan, forwards)} ({forwards} forwards)")
    names = [p.name for p in written]
    if names != [f"{i:06d}_a2b.png" for i in range(EXPORT_IMAGES)]:
        fail(f"export 512: wrote {names}")

    images = _load_domain(records["a"], EXPORT_SIZE)
    pick = [0, EXPORT_IMAGES - 1]
    got = np.stack([codec.decode_image_rgb(written[i].read_bytes())
                    for i in pick])
    cpu32 = InferenceSession(MODEL_DIR, "float32", device="cpu")
    cpu16 = InferenceSession(MODEL_DIR, "bfloat16", device="cpu")
    quality = serving_quality("export 512", got,
                              cpu32.stylize(images[pick], "a2b"),
                              cpu16.stylize(images[pick], "a2b"))
    session = InferenceSession(MODEL_DIR, "bfloat16", device=DEVICE)
    batch = images[:BATCH]
    rate = _request_rate(session, batch)
    stylized = session.stylize(batch, "a2b")
    encode = {}
    for name, scope in ((codec_name(), contextlib.nullcontext),
                        ("stdlib", stdlib_codec)):
        encode[name] = []
        with scope():
            for rgb in stylized:
                t0 = time.perf_counter()
                codec.encode_png_bgr(np.ascontiguousarray(rgb[..., ::-1]))
                encode[name].append(time.perf_counter() - t0)
        encode[name] = statistics.median(encode[name]) * 1e3
    trace = device_trace(_generator_call(session, batch), out_dir, 3,
                         "export_512_forward_trace.json")
    metrics = {"images": EXPORT_IMAGES, "size": EXPORT_SIZE, "batch": BATCH,
               "forwards": forwards, "records_write_s": write_s,
               "export_s": export_s,
               "export_img_per_s": EXPORT_IMAGES / export_s,
               "stylize_request_ms_median": rate["request_ms_median"],
               "stylize_img_per_s": rate["img_per_s"],
               "codec": codec_name(), "png_encode_ms_per_image": encode,
               "trace": trace, "quality": quality}
    print(f"export 512: {EXPORT_IMAGES} images in {export_s:.2f} s "
          f"({metrics['export_img_per_s']:.1f} img/s, session and records "
          f"included, {codec_name()} codec); stylize "
          f"{rate['img_per_s']:.1f} img/s a batch-8 request; PNG encode ms "
          f"an image {json.dumps(encode)}", flush=True)
    return records, launches, plan, forwards, metrics


@contextlib.contextmanager
def stdlib_codec():
    """The port's codec without cv2 and PIL, as on a machine that has
    neither: PNG only, through the standard library's zlib and numpy (and
    Python loops for Average and Paeth rows); torch's bilinear resize."""
    from cyclegan_tpu_torch.data import codec

    saved = codec.cv2, codec.Image
    codec.cv2 = codec.Image = None
    try:
        yield
    finally:
        codec.cv2, codec.Image = saved


def codec_name():
    from cyclegan_tpu_torch.data import codec

    return ("cv2" if codec.cv2 is not None
            else "PIL" if codec.Image is not None else "stdlib")


def _post(url, body):
    """(status, headers, body) of a POST, error statuses included."""
    import urllib.error
    import urllib.request

    request = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(request, timeout=120) as response:
            return response.status, dict(response.headers), response.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read()


def _server_timing(headers):
    """{stage: ms} from a reply's Server-Timing header."""
    out = {}
    for part in headers.get("Server-Timing", "").split(", "):
        name, _, dur = part.partition(";dur=")
        if dur:
            out[name] = float(dur)
    return out


def _percentiles(values):
    return {"p50": float(np.percentile(values, 50)),
            "p99": float(np.percentile(values, 99)), "n": len(values)}


def stress(session, image):
    """``STRESS_THREADS`` threads stylizing ``image`` (batch 1, both
    directions) ``STRESS_CALLS`` times each on one session at once: every
    output must be its serial one (the layout scope and each kernel's
    launch attributes hold per call, whatever another thread does)."""
    import threading

    serial = {d: session.stylize(image[None], d) for d in ("a2b", "b2a")}
    mismatches, errors = [0], []

    def run(t):
        direction = ("a2b", "b2a")[t % 2]
        try:
            for _ in range(STRESS_CALLS):
                out = session.stylize(image[None], direction)
                if not np.array_equal(out, serial[direction]):
                    mismatches[0] += 1
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(repr(exc))

    threads = [threading.Thread(target=run, args=(t,))
               for t in range(STRESS_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    result = {"threads": STRESS_THREADS, "calls": STRESS_CALLS,
              "mismatches": mismatches[0], "errors": errors[:3],
              "alive": sum(t.is_alive() for t in threads)}
    print(f"stress: {json.dumps(result)}", flush=True)
    if mismatches[0] or errors or result["alive"]:
        fail(f"stress: {result}")
    return result


def http_server(cfg):
    """Phase 22: the HTTP server (``make_handler``) on 127.0.0.1 in a
    thread, serving converged256 in bf16 (NHCW) at 256: ``/healthz``;
    ``HTTP_REQUESTS`` sequential batch-1 POSTs of filter-0 PNGs in both
    directions (latency p50/p99 on the client's clock, and the server's
    decode, resize, stylize and encode ms), each forward the U-Net plan at
    batch 1; ``HTTP_PAETH`` Paeth-filtered PNGs apart; both again with the
    standard-library codec (``stdlib_codec``: a machine without cv2 and
    PIL); rounds of ``HTTP_CONCURRENT`` requests at once to this server and
    to a second one serving NHWC f32, each reply equal to its serial one,
    and ``STRESS_THREADS`` threads stylizing at once on the NHCW session,
    each output its serial one; 400 for a bad direction and for a JPEG
    with no decoder installed. Every reply equals ``session.stylize`` of
    the same resized image."""
    import logging
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from cyclegan_tpu_torch import kernels
    from cyclegan_tpu_torch.apps.inference import InferenceSession
    from cyclegan_tpu_torch.apps.server import make_handler
    from cyclegan_tpu_torch.data import codec, png

    sessions = {"nhcw": InferenceSession(MODEL_DIR, "bfloat16",
                                         device=DEVICE),
                "nhwc": InferenceSession(MODEL_DIR, "float32",
                                         tpu_layout=False, device=DEVICE)}
    for session in sessions.values():  # as serve() does before it listens
        for d in ("a2b", "b2a"):
            session.stylize(np.zeros((1, SIZE, SIZE, 3), np.uint8), d)
    servers = {way: ThreadingHTTPServer(("127.0.0.1", 0),
                                        make_handler(s, SIZE))
               for way, s in sessions.items()}
    threads = [threading.Thread(target=srv.serve_forever, daemon=True)
               for srv in servers.values()]
    for t in threads:
        t.start()
    urls = {way: f"http://127.0.0.1:{srv.server_address[1]}"
            for way, srv in servers.items()}
    # one log line a request would bury the phase's own lines
    logging.getLogger("cyclegan_tpu_torch.apps.server").setLevel(
        logging.WARNING)
    rng = np.random.default_rng(22)
    images = rng.integers(0, 256, (HTTP_REQUESTS, SIZE, SIZE, 3),
                          dtype=np.uint8)
    metrics = {"codec": codec_name()}
    try:
        for way, url in urls.items():
            with urllib.request.urlopen(f"{url}/healthz",
                                        timeout=60) as response:
                if response.status != 200 or response.read() != b"ok":
                    fail(f"http {way}: /healthz did not answer ok")

        def run(filter_kind, count, way="nhcw"):
            latency, stages, replies = [], collections.defaultdict(list), []
            for i in range(count):
                direction = ("a2b", "b2a")[i % 2]
                body = png.encode_png(images[i], filter_kind)
                t0 = time.perf_counter()
                code, headers, reply = _post(
                    f"{urls[way]}/stylize?direction={direction}", body)
                latency.append((time.perf_counter() - t0) * 1e3)
                if code != 200:
                    fail(f"http {way} request {i}: status {code} {reply!r}")
                    continue
                for stage, ms in _server_timing(headers).items():
                    stages[stage].append(ms)
                replies.append((i, direction, reply))
            return ({"latency_ms": _percentiles(latency),
                     "server_ms": {k: _percentiles(v)
                                   for k, v in stages.items()}}, replies)

        kernels.reset_launches()
        metrics["filter_0"], replies = run(0, HTTP_REQUESTS)
        launches = _launched()
        want = _times(serve_launches(cfg.generator, 1, SIZE), HTTP_REQUESTS)
        if launches != want:
            fail(f"http: launches {launches}, expected {want}")
        metrics["paeth"], paeth = run(4, HTTP_PAETH)
        with stdlib_codec():
            metrics["filter_0_stdlib"], plain = run(0, HTTP_PAETH)
            metrics["paeth_stdlib"], plain_paeth = run(4, HTTP_PAETH)
        for (i, direction, reply) in replies + paeth + plain + plain_paeth:
            want_rgb = sessions["nhcw"].stylize(
                codec.resize_rgb(images[i], (SIZE, SIZE))[None],
                direction)[0]
            if not np.array_equal(png.decode_png(reply), want_rgb):
                fail(f"http request {i} {direction}: reply differs from "
                     f"session.stylize")

        # concurrency: each request's serial reply, then rounds at once
        jobs = [(("nhcw", "nhwc")[j % 2], ("a2b", "b2a")[(j // 2) % 2], j)
                for j in range(HTTP_CONCURRENT)]
        bodies = {j: png.encode_png(images[j]) for _, _, j in jobs}
        serial = {j: _post(f"{urls[w]}/stylize?direction={d}", bodies[j])[2]
                  for w, d, j in jobs}
        mismatches, errors = 0, []
        for _ in range(HTTP_ROUNDS):
            got = {}

            def send(w, d, j):
                try:
                    got[j] = _post(f"{urls[w]}/stylize?direction={d}",
                                   bodies[j])
                except Exception as exc:  # noqa: BLE001 - reported below
                    errors.append(repr(exc))

            workers = [threading.Thread(target=send, args=job)
                       for job in jobs]
            for t in workers:
                t.start()
            for t in workers:
                t.join(timeout=120)
            for _, _, j in jobs:
                code, _, reply = got.get(j, (None, None, None))
                if code != 200 or not np.array_equal(
                        png.decode_png(reply), png.decode_png(serial[j])):
                    mismatches += 1
        metrics["concurrent"] = {"requests": HTTP_CONCURRENT,
                                 "rounds": HTTP_ROUNDS,
                                 "mismatches": mismatches, "errors": errors}
        if mismatches or errors:
            fail(f"http concurrent: {mismatches} replies differ from the "
                 f"serial ones, errors {errors}")

        metrics["stress"] = stress(sessions["nhcw"], images[0])

        code, _, text = _post(f"{urls['nhcw']}/stylize?direction=x2y",
                              png.encode_png(images[0]))
        if code != 400:
            fail(f"http bad direction: status {code}")
        ok, jpeg = True, None
        if codec.cv2 is not None:  # a real JPEG where this machine makes one
            ok, jpeg = codec.cv2.imencode(".jpg", images[0])
        jpeg = jpeg.tobytes() if ok and jpeg is not None else (
            b"\xff\xd8\xff\xe0" + bytes(64))  # a JPEG's first bytes
        with stdlib_codec():
            code, _, text = _post(f"{urls['nhcw']}/stylize", jpeg)
        if code != 400 or b"needs cv2 or PIL" not in text:
            fail(f"http JPEG without a decoder: status {code} {text!r}")
        metrics["jpeg_without_decoder"] = {
            "status": code, "reply": text.decode(errors="replace")}
    finally:
        for srv in servers.values():
            srv.shutdown()
            srv.server_close()
        for t in threads:
            t.join(timeout=60)
    for kind in ("filter_0", "paeth", "filter_0_stdlib", "paeth_stdlib"):
        m = metrics[kind]
        print(f"http {kind}: latency p50 {m['latency_ms']['p50']:.2f} ms, "
              f"p99 {m['latency_ms']['p99']:.2f} ms; server p50 "
              + ", ".join(f"{k} {v['p50']:.2f}" for k, v in
                          m["server_ms"].items()) + " ms", flush=True)
    return {"unet_http": launches}, metrics


def evaluation(cfg, records):
    """Phase 23: ``evaluate`` on phase 21's records (train split, batch 8),
    on the card against the CPU: the six metrics within EVAL_REL relative,
    and no kernel launched (the NHWC validate step); ``evaluate_quality``
    in bf16 on the card, each of its forwards the U-Net plan, its proxy
    features within FEATURE_REL of the CPU's on the same images, and
    ``fid_proxy``, ``kid_proxy`` and ``swd`` beside the CPU's (f32)."""
    from cyclegan_tpu_torch import kernels
    from cyclegan_tpu_torch.apps.evaluate import evaluate, evaluate_quality
    from cyclegan_tpu_torch.data.pipeline import _load_domain
    from cyclegan_tpu_torch.utils.quality import (
        make_random_feature_extractor,
    )

    kernels.reset_launches()
    t0 = time.perf_counter()
    card = evaluate(MODEL_DIR, records["a"], records["b"], batch=BATCH,
                    split="train", device=DEVICE)
    card_s = time.perf_counter() - t0
    if _launched():
        fail(f"evaluate: launched {_launched()}, expected no kernel")
    cpu = evaluate(MODEL_DIR, records["a"], records["b"], batch=BATCH,
                   split="train", device="cpu")
    for key, want in cpu.items():
        got = card[key]
        if isinstance(want, float):
            if abs(got - want) > EVAL_REL * abs(want) + 1e-7:
                fail(f"evaluate {key}: card {got} vs cpu {want}")
        elif got != want:
            fail(f"evaluate {key}: card {got} vs cpu {want}")

    kernels.reset_launches()
    max_images = 2 * BATCH
    q_card = evaluate_quality(MODEL_DIR, records["a"], records["b"],
                              batch=BATCH, split="train",
                              max_images=max_images,
                              compute_dtype="bfloat16", device=DEVICE)
    launches = _launched()
    forwards = 2 * math.ceil(q_card["n_images"] / BATCH)
    want = _times(serve_launches(cfg.generator, BATCH, SIZE), forwards)
    if launches != want:
        fail(f"evaluate_quality: launches {launches}, expected {want}")
    q_cpu = evaluate_quality(MODEL_DIR, records["a"], records["b"],
                             batch=BATCH, split="train",
                             max_images=max_images, device="cpu")
    images = _load_domain(records["a"], SIZE)[:max_images]
    f_card = make_random_feature_extractor(device=DEVICE)(images)
    f_cpu = make_random_feature_extractor(device="cpu")(images)
    feature_err = float(np.abs(f_card - f_cpu).max() / np.abs(f_cpu).max())
    if feature_err > FEATURE_REL:
        fail(f"evaluate_quality: proxy features {feature_err} (relative) "
             f"from the CPU's > {FEATURE_REL}")
    print(f"evaluate: card {json.dumps(card)} in {card_s:.2f} s; cpu "
          f"{json.dumps(cpu)}", flush=True)
    print(f"evaluate_quality: card bf16 {json.dumps(q_card)}; cpu f32 "
          f"{json.dumps(q_cpu)}; features {feature_err:.2e} relative",
          flush=True)
    return {"unet_quality": launches}, {
        "evaluate_card": card, "evaluate_cpu": cpu,
        "evaluate_card_s": card_s, "quality_card_bf16": q_card,
        "quality_cpu_f32": q_cpu, "feature_rel_err": feature_err}


def batchnorm_config():
    """``configs/cycle.yaml`` with ``normalization: batchnorm`` in the
    generators and the discriminators (phase 24), built in memory."""
    from cyclegan_tpu_torch.config import yaml2namespace

    cfg = yaml2namespace(ROOT / "configs" / "cycle.yaml")
    for part in ("generator", "discriminator"):
        cfg[part] = dict(cfg[part], normalization="batchnorm")
    return cfg


def batchnorm_launches(plan):
    """A U-Net plan (``train_launches`` or ``serve_launches``) with batch
    norms: the same K1, K3, K4, K5, K7 and K8 launches and no norm kernel,
    as batch norm runs in torch ops."""
    return {k: v for k, v in plan.items() if k not in BN_UNLAUNCHED}


def _stats(state):
    """{network: {buffer: value, f32 on the CPU}}: the moving statistics."""
    return {name: {key: b.detach().float().cpu().clone()
                   for key, b in model.named_buffers()}
            for name, model in state.models.items()}


def _bn_step(model_cfg, device, dtype, x, point):
    """(gradients, moving statistics) after one train step (no jitter) on
    ``x`` from the weights of ``point`` (its seed and betas)."""
    from cyclegan_tpu_torch.steps import make_train_step

    s = _train_state(model_cfg, device, None, point["seed"],
                     point.get("beta"))
    make_train_step(model_cfg["loss"], model_cfg["loss_weights"], dtype)(
        s, *(t.to(device) for t in x))
    return _grads(s), _stats(s)


def batchnorm(cfg, plan, serve_plan, workdir, out_dir):
    """Phase 24: ``cfg`` (``batchnorm_config``) from seeded weights, bf16,
    NHCW, batch BATCH at SIZE²: one step's launches against ``plan`` and
    none of K2, K6 or K13; 3 steps with finite losses that move every
    network and every moving statistic, then TRAIN_STEPS_TIMED timed; the
    f32 step at BN_F32_POINT on the card against the plain CPU step
    (gradients within TRAIN_F32_REL, the kept moving statistics within
    STATS_REL, asserted kink-free) and the bf16 card step's gradient error
    within RATIO times the plain bf16 step's; a checkpoint saved and
    reloaded exactly; the trained networks served through
    ``InferenceSession`` in bf16, NHCW (each forward ``serve_plan``) and
    NHWC (no kernel), within the serving bounds of the CPU f32 session.
    Returns ({path: launches}, NHCW forwards, metrics)."""
    from cyclegan_tpu_torch import kernels
    from cyclegan_tpu_torch.apps.inference import InferenceSession
    from cyclegan_tpu_torch.config import namespace2yaml
    from cyclegan_tpu_torch.steps import make_train_step
    from cyclegan_tpu_torch.utils.checkpoint import (load_train_state,
                                                     save_model_folder,
                                                     save_train_state)

    label = "unet_bn_train"
    want = {k: len(v) for k, v in plan.items()}
    batch = _uint8_batch(BATCH)
    state = _train_state(cfg, DEVICE)
    start = {name: [p.detach().clone() for p in m.parameters()]
             for name, m in state.models.items()}
    stats0 = _stats(state)
    step16 = make_train_step(cfg["loss"], cfg["loss_weights"], "bfloat16",
                             preprocess=_jitter)

    # 24.1: the main path, one bf16 step with the counts zeroed around it
    kernels.reset_launches()
    losses = [step16(state, *batch)]
    torch.cuda.synchronize()
    main_launches = {k: v for k, v in kernels.launches.items()
                     if v or k in want}
    if main_launches != want:
        fail(f"{label}: launches {main_launches}, plan {want}")
    for name in BN_UNLAUNCHED:
        if kernels.launches[name]:
            fail(f"{label}: {kernels.launches[name]} {name} launches; batch "
                 f"norm runs no norm kernel")
    print(f"{label} main path launches {main_launches} in one step (plan "
          f"{want})", flush=True)
    for _ in range(2):
        losses.append(step16(state, *batch))
    losses = [{k: float(v) for k, v in m.items()} for m in losses]
    if not all(np.isfinite(v) for m in losses for v in m.values()):
        fail(f"{label}: non-finite loss {losses}")
    moved = {name: max(float((p.detach() - p0).abs().max())
                       for p, p0 in zip(m.parameters(), start[name]))
             for name, m in state.models.items()}
    stats = _stats(state)
    still = [f"{n}.{k}" for n in stats for k in stats[n]
             if torch.equal(stats[n][k], stats0[n][k])]
    if not all(v > 0 for v in moved.values()) or still:
        fail(f"{label}: a network {moved} or a moving statistic "
             f"{still[:4]} did not move in 3 steps")

    # 24.2: throughput, peak memory, host issue time and the trace
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
    issue = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step16(state, *batch)
        issue.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    trace = device_trace(lambda: step16(state, *batch), out_dir, 3,
                         f"{label}_trace.json")

    # 24.3: the f32 step at BN_F32_POINT, card against the plain CPU step;
    # the bf16 card step against the plain bf16 step
    x = f32_point_inputs(BN_F32_POINT)
    (ref, ref_stats), kink = nearest_kink(
        lambda: _bn_step(cfg, "cpu", "float32", x, BN_F32_POINT))
    if not kink > KINK_MARGIN:
        fail(f"{label}: a ReLU input {kink} from its kink at the f32 point, "
             f"not beyond {KINK_MARGIN}")
    card, card_stats = _bn_step(cfg, DEVICE, "float32", x, BN_F32_POINT)
    card16, _ = _bn_step(cfg, DEVICE, "bfloat16", x, BN_F32_POINT)
    cpu16, _ = _bn_step(cfg, "cpu", "bfloat16", x, BN_F32_POINT)
    errors = {"f32_point": dict(BN_F32_POINT, nearest_kink=kink)}
    for name in ref:
        f32_rel, f32_bias = f32_errors(card[name], ref[name])
        e = {"f32_card_vs_f32_cpu": f32_rel,
             "f32_pre_norm_bias_card_vs_cpu": f32_bias,
             "moving_stats_card_vs_cpu": _rel(_flat(card_stats[name]),
                                              _flat(ref_stats[name])),
             "bf16_card_vs_f32_cpu": _rel(_flat(card16[name]),
                                          _flat(ref[name])),
             "bf16_cpu_vs_f32_cpu": _rel(_flat(cpu16[name]),
                                         _flat(ref[name]))}
        errors[name] = e
        print(f"{label} gradients {name}: {json.dumps(e)}", flush=True)
        for key, bound in (("f32_card_vs_f32_cpu", TRAIN_F32_REL),
                           ("f32_pre_norm_bias_card_vs_cpu", TRAIN_F32_REL),
                           ("moving_stats_card_vs_cpu", STATS_REL),
                           ("bf16_card_vs_f32_cpu",
                            RATIO * e["bf16_cpu_vs_f32_cpu"])):
            if not e[key] <= bound:
                fail(f"{label} {name}: {key} {e[key]} > {bound}")

    # 24.4: a checkpoint reloaded into other weights gives the state back
    save_train_state(workdir / "bn_checkpoint.npz", state,
                     np.zeros(2, np.uint32))
    other = _train_state(cfg, DEVICE, seed=1)
    load_train_state(workdir / "bn_checkpoint.npz", other)
    diffs = _same_state(state, other)
    back = _stats(other)
    diffs += [f"{n}.{k}" for n in stats for k in stats[n]
              if not torch.equal(_stats(state)[n][k], back[n][k])]
    if diffs:
        fail(f"{label}: the reloaded checkpoint differs: {diffs[:8]}")
    del other

    # 24.5: served from the folder the port saves, both layouts
    folder = workdir / "bn_model"
    namespace2yaml(workdir / "bn_model_config.yaml", cfg)
    save_model_folder(folder, workdir / "bn_model_config.yaml", state.models)
    del state
    rng = np.random.default_rng(0)
    images = {b: rng.integers(0, 256, (b, SIZE, SIZE, 3), dtype=np.uint8)
              for b in (BATCH, 1)}
    requests = [(BATCH, "a2b"), (BATCH, "b2a"), (1, "a2b"), (1, "b2a")]
    cpu32 = InferenceSession(folder, "float32", tpu_layout=False,
                             device="cpu")
    refs = {r: cpu32.stylize(images[r[0]], r[1]) for r in requests}
    serving, launches = {}, {}
    for layout_name, tpu_layout in (("nhcw", True), ("nhwc", False)):
        session = InferenceSession(folder, "bfloat16", tpu_layout=tpu_layout,
                                   device=DEVICE)
        plain16 = InferenceSession(folder, "bfloat16", tpu_layout=tpu_layout,
                                   device="cpu")
        per_forward = ({k: len(v) for k, v in serve_plan.items()}
                       if tpu_layout else {})
        kernels.reset_launches()
        quality, served = [], collections.Counter()
        for b, direction in requests:
            before = dict(kernels.launches)
            out = session.stylize(images[b], direction)
            added = {k: kernels.launches[k] - before[k] for k in before
                     if kernels.launches[k] != before[k]
                     or k in per_forward}
            served.update(added)
            if added != per_forward:
                fail(f"unet_bn_serve {layout_name} {b} {direction}: "
                     f"launches {added}, expected {per_forward}")
            quality.append({"batch": b, "direction": direction,
                            **serving_quality(
                                f"unet_bn_serve {layout_name} {b} "
                                f"{direction}", out, refs[(b, direction)],
                                plain16.stylize(images[b], direction))})
        launches[layout_name] = {k: v for k, v in served.items() if v}
        serving[layout_name] = {**_request_rate(session, images[BATCH]),
                                "launches": launches[layout_name],
                                "quality": quality}
        shown = {k: v for k, v in serving[layout_name].items()
                 if k != "quality"}
        print(f"unet_bn_serve {layout_name}: {json.dumps(shown)}",
              flush=True)
    result = {"batch": BATCH, "size": SIZE, "compute_dtype": "bfloat16",
              "step_ms": step_s * 1e3, "img_per_s": BATCH / step_s,
              "peak_mib": peak_mib,
              "host_issue_ms_median": statistics.median(issue) * 1e3,
              "device_busy_ms": (trace or {}).get(
                  "device_busy_ms_per_call"),
              "idle_share": (trace or {}).get("idle_share"),
              "gradient_errors": errors, "losses": losses,
              "reload_differences": diffs, "serving": serving,
              "trace": trace}
    print(f"{label} batch {BATCH}: {result['img_per_s']:.2f} img/s "
          f"({result['step_ms']:.1f} ms per step), device busy "
          f"{result['device_busy_ms']} ms, idle share "
          f"{result['idle_share']}, peak {peak_mib:.0f} MiB, host issue "
          f"{result['host_issue_ms_median']:.1f} ms ({smi_line()})",
          flush=True)
    return ({label: main_launches, "unet_bn_serve": launches["nhcw"]},
            len(requests), result)


def _ms_per_image(fn, images):
    """``fn()``'s host time per image over one call after a warm-up."""
    fn()
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3 / images


def data_layer(workdir):
    """Phase 25 on phase 14's records in ``workdir``: the streaming loader
    against the memory loader (every batch of epochs 0 and 1 and the sample
    pairs, exactly); the trainer CLI with ``data_loader: streaming`` in
    NHCW; the native loader (whether it built, else the compiler's first
    error line; its decode against the Python path's, within
    NATIVE_MAX_STEPS; ms per image of both) and which path decoded how
    many images; the SIZE² Average and Paeth PNG decode, the C unfilter
    against the Python byte loops. Returns ({run: launches}, metrics)."""
    from cyclegan_tpu_torch import kernels
    from cyclegan_tpu_torch.config import namespace2yaml, yaml2namespace
    from cyclegan_tpu_torch.data import native, pipeline, png
    from cyclegan_tpu_torch.data.streaming import create_streaming_dataset
    from cyclegan_tpu_torch.train import main as train_main

    data = workdir / "data"
    records = [sorted(str(p) for p in (data / d).glob("*.tfrecords"))
               for d in ("tabby_records", "tortie_records")]
    metrics = {"card": smi_line()}

    # 25.1: streamed batches are the memory loader's
    memory = pipeline.create_dataset(*records, width=SIZE, seed=0)
    streamed = create_streaming_dataset(*records, width=SIZE, seed=0)
    compared = differ = 0
    for s, m in zip(streamed, memory):
        for epoch in (0, 1):
            pairs = list(itertools.zip_longest(s.batches(BATCH, epoch),
                                               m.batches(BATCH, epoch)))
            for got, want in pairs:
                compared += 1
                if got is None or want is None or not all(
                        np.array_equal(g, w) and g.dtype == np.uint8
                        for g, w in zip(got, want)):
                    differ += 1
        if not all(np.array_equal(g, w) for g, w in
                   zip(s.take_pairs(4), m.take_pairs(4))):
            differ += 1
    t0 = time.perf_counter()
    n_streamed = sum(len(a) for a, _ in streamed[0].batches(BATCH, 2))
    metrics["streaming"] = {
        "batches_compared": compared, "batches_differing": differ,
        "epoch_ms_per_image": (time.perf_counter() - t0) * 1e3
        / max(n_streamed, 1)}
    if differ or not compared:
        fail(f"streaming: {differ} of {compared} batches differ from the "
             f"memory loader's")

    # 25.2: the trainer CLI with the streaming loader, NHCW
    model_cfg = yaml2namespace(ROOT / "configs" / "cycle.yaml")
    model_cfg.update(location=str(workdir / "models"), name="streaming")
    train_cfg = yaml2namespace(TRAIN_CONFIG)
    train_cfg.update(batch_size=BATCH, image_size=SIZE, epochs=1,
                     tpu_layout=True, data_loader="streaming")
    namespace2yaml(workdir / "streaming_model.yaml", model_cfg)
    namespace2yaml(workdir / "streaming_train.yaml", train_cfg)
    kernels.reset_launches()
    t0 = time.perf_counter()
    gan = train_main(["--model_config", str(workdir / "streaming_model.yaml"),
                      "--train_config", str(workdir / "streaming_train.yaml"),
                      "--data_dir", str(data), "--device", DEVICE])
    torch.cuda.synchronize()
    launches = _launched()
    steps = (CLI_IMAGES - int(0.2 * CLI_IMAGES)) // BATCH
    record = gan.history[0]
    metrics["trainer_streaming"] = {
        "seconds": time.perf_counter() - t0, "step": gan.state.step,
        "launches": launches, "train_img_per_s": record["train_steps"]
        * BATCH / record["train_seconds"]}
    nhcw = ("conv_same", "instance_norm_act", "sum2x2", "concat_up2",
            "conv_dw", "instance_norm_act_bwd", "dup2x2", "split_pool2")
    if gan.state.step != steps or not all(launches.get(k) for k in nhcw) \
            or not all(np.isfinite(v) for v in [*record["train"].values(),
                                                 *record["validation"]
                                                 .values()]):
        fail(f"trainer streaming: step {gan.state.step} (expected {steps}), "
             f"launches {launches}, epoch {record}")
    del gan

    # 25.3: the native loader against the Python path
    built = native.available()
    lines = (native.build_error or "").splitlines()
    errors = [line for line in lines if "error" in line] or lines
    entry = {"built": built,
             "build_error_first_line": errors[0].strip() if errors else None}

    def python_path():
        loader = native.load_domain_native
        native.load_domain_native = lambda *a, **k: None
        try:
            return pipeline._load_domain(records[0], SIZE)
        finally:
            native.load_domain_native = loader

    n_images = CLI_IMAGES
    entry["python_ms_per_image"] = _ms_per_image(python_path, n_images)
    if built:
        got = native.load_domain_native(records[0], SIZE)
        entry["max_steps_from_python"] = int(np.abs(
            got.astype(int) - python_path().astype(int)).max())
        entry["native_ms_per_image"] = _ms_per_image(
            lambda: native.load_domain_native(records[0], SIZE), n_images)
        if got.shape != (n_images, SIZE, SIZE, 3) or \
                entry["max_steps_from_python"] > NATIVE_MAX_STEPS:
            fail(f"native loader: {got.shape}, "
                 f"{entry['max_steps_from_python']} steps from the Python "
                 f"path's decode")
    entry["decoded_by_path"] = dict(native.decoded)
    metrics["native_loader"] = entry
    print(f"native loader: {json.dumps(entry)}", flush=True)

    # 25.4: the SIZE² Average and Paeth PNG decode, C against Python
    image = np.random.default_rng(1).integers(0, 256, (SIZE, SIZE, 3),
                                              dtype=np.uint8)
    plain_row = png.unfilter_row

    def byte_loops(kind, line, prev, bpp, out):
        out[:] = png.unfilter_row_plain(kind, line, prev, bpp)

    metrics["png_unfilter"] = {}
    for row_filter, name in ((3, "average"), (4, "paeth")):
        blob = png.encode_png(image, row_filter)
        c_ms = _ms_per_image(lambda: png.decode_png(blob), 1)
        c_out = png.decode_png(blob)
        png.unfilter_row = byte_loops
        try:
            py_ms = _ms_per_image(lambda: png.decode_png(blob), 1)
            py_out = png.decode_png(blob)
        finally:
            png.unfilter_row = plain_row
        metrics["png_unfilter"][name] = {"c_ms": c_ms,
                                         "python_byte_loops_ms": py_ms}
        if not (np.array_equal(c_out, image)
                and np.array_equal(py_out, image)):
            fail(f"PNG {name} decode: the C unfilter or the byte loops "
                 f"differ from the image")
    print(f"data layer ({metrics['card']}): "
          f"{json.dumps({k: v for k, v in metrics.items() if k != 'card'})}",
          flush=True)
    return {"trainer_cli_streaming": launches}, metrics


def spatial_launches(plan, shards):
    """A U-Net plan (``train_launches`` or ``serve_launches``) as each of
    ``shards`` H-strip ranks launches it under ``dp_shard_map``: a shape's
    side H becomes (rows, W), the strip's H // shards rows, plus K - 1 halo
    rows for K1 and K5 (their extended strip); no norm kernel (K2 and K6 do
    not run on a strip, the norms are torch ops with summed statistics)."""
    out = {}
    for name, shapes in plan.items():
        if name in ("instance_norm_act", "instance_norm_act_bwd"):
            continue
        rows = []
        for s in shapes:
            side = s[1]
            if name in ("conv_same", "conv_dw"):
                k = s[4]
                strip = (side // shards + k - 1, side)
            else:
                strip = (side // shards, side)
            rows.append((s[0], strip) + tuple(s[2:]))
        out[name] = rows
    return out


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_settings(prepare=None):
    """What a spawned rank needs of this process's settings (the module is
    imported afresh there), and a function it runs first (the CPU
    rehearsal's stubs)."""
    return {"globals": {k: globals()[k] for k in (
        "DEVICE", "BATCH", "SIZE", "GRAD_BATCH", "SPATIAL_SERVE_SIZE",
        "SPATIAL_SERVE_BATCH", "RANK_STEPS_TIMED", "BN_DP_SIZE",
        "SPATIAL_F32_POINT", "SPATIAL_KINK_FREE_POINT")},
        "prepare": prepare}


def _enter_rank(settings):
    globals().update(settings["globals"])
    failures.clear()
    if settings["prepare"] is not None:
        settings["prepare"]()
    if DEVICE == "cuda":
        torch.cuda.set_device(0)


def _noise_batch(batch, size, seed):
    """Two normalized uint8-noise NHWC batches from ``seed``, on the CPU."""
    return f32_point_inputs({"batch": batch, "size": size, "seed": seed})


def _sync():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _timed_steps(step, state, batch, mesh):
    """RANK_STEPS_TIMED steps on the host clock between two barriers;
    seconds, and the same steps' gradient all-reduce alone: one f32 buffer
    of the step's gradients, summed over the mesh."""
    import torch.distributed as dist

    grads = [p for m in state.models.values() for p in m.parameters()]
    flat = torch.zeros(sum(p.numel() for p in grads), device=DEVICE)
    _sync()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(RANK_STEPS_TIMED):
        step(state, *batch)
    _sync()
    step_s = (time.perf_counter() - t0) / RANK_STEPS_TIMED
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(RANK_STEPS_TIMED):
        dist.all_reduce(flat, group=mesh.group())
    _sync()
    return step_s, (time.perf_counter() - t0) / RANK_STEPS_TIMED, flat.numel()


def _planned_rank_step(label, step, state, batch, plan):
    """The rank's main path: one bf16 step with the launch counts zeroed
    around it, against ``plan`` ({kernel: shapes}); then two more steps,
    all with finite metrics. Returns (launches, metrics of the three)."""
    from cyclegan_tpu_torch import kernels

    kernels.reset_launches()
    metrics = [step(state, *batch)]
    _sync()
    got = _launched()
    want = {k: len(v) for k, v in plan.items()}
    if got != want:
        fail(f"{label} rank step launches {got}, plan {want}")
    for _ in range(2):
        metrics.append(step(state, *batch))
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        fail(f"{label}: non-finite loss {metrics}")
    return got, metrics


def _dp_rank(rank, world, settings, plan):
    """Phase 26 (b) on one of ``world`` ranks sharing the card over gloo,
    a data mesh of ``world``: the f32 gradients of the global batch's
    step (this rank's slice, no jitter), batch norm both ways, the bf16
    main path against ``train_launches`` at the rank's batch, timing."""
    _enter_rank(settings)
    from cyclegan_tpu_torch.config import yaml2namespace
    from cyclegan_tpu_torch.parallel import create_mesh, shard_batch
    from cyclegan_tpu_torch.steps import make_train_step

    mesh = create_mesh(world)
    cfg = yaml2namespace(MODEL_DIR / "model_config.yaml")
    loss, weights = cfg["loss"], cfg["loss_weights"]
    out = {"backend": mesh.backend, "coords": mesh.coords}
    x = shard_batch(mesh, _noise_batch(BATCH, SIZE, 26))
    state = _train_state(cfg, DEVICE, MODEL_DIR)
    make_train_step(loss, weights, "float32", mesh=mesh)(
        state, *(t.to(DEVICE) for t in x))
    out["f32"] = _grads(state)
    bn = batchnorm_config()
    xb = shard_batch(mesh, _noise_batch(BATCH, BN_DP_SIZE, 24))
    for smap in (False, True):
        s = _train_state(bn, DEVICE, None, BN_DP_POINT["seed"],
                         BN_DP_POINT["beta"])
        make_train_step(loss, weights, "float32", mesh=mesh,
                        shard_map_dp=smap)(s, *(t.to(DEVICE) for t in xb))
        out[("bn", smap)] = (_grads(s), _stats(s))
    state = _train_state(cfg, DEVICE, MODEL_DIR)
    step = make_train_step(loss, weights, "bfloat16", preprocess=_jitter,
                           mesh=mesh)
    batch = shard_batch(mesh, _uint8_batch(BATCH))
    out["launches"], out["metrics"] = _planned_rank_step(
        "dp_train", step, state, batch, plan)
    out["step_s"], out["all_reduce_s"], out["all_reduce_floats"] = \
        _timed_steps(step, state, batch, mesh)
    # every rank runs the traced steps: their collectives pair up
    out["trace"] = device_trace(lambda: step(state, *batch), None, 3,
                                f"dp_rank{rank}_trace.json")
    out["params"] = float(sum(p.detach().double().sum() for m in
                              state.models.values()
                              for p in m.parameters()))
    out["failures"] = list(failures)
    return out


def _check_grads(label, got, want):
    """Per network, ``f32_errors`` within TRAIN_F32_REL; returns them."""
    errors = {}
    for name in want:
        rel, bias = f32_errors(got[name], want[name])
        errors[name] = {"rel": rel, "pre_norm_bias": bias}
        if not (rel <= TRAIN_F32_REL and bias <= TRAIN_F32_REL):
            fail(f"{label} {name}: gradient error {rel} (pre-norm biases "
                 f"{bias}) beyond {TRAIN_F32_REL}")
    print(f"{label} f32 gradients vs one rank: {json.dumps(errors)}",
          flush=True)
    return errors


def _check_stats(label, got, want):
    """The moving statistics per network within STATS_REL (relative to the
    network's, as phase 24 measures them); returns the worst."""
    worst = max(_rel(_flat(got[n]), _flat(want[n])) for n in want)
    if not worst <= STATS_REL:
        fail(f"{label}: moving statistics {worst} beyond {STATS_REL}")
    return worst


def world1_nccl(cfg, plan, workdir):
    """Phase 26 (a): one U-Net step through ``CycleGan(mesh=create_mesh(1))``
    in a process group of one over WORLD1_BACKEND (NCCL on the card), bf16,
    NHCW, jitter inside: its launches against ``plan``, and every
    parameter after it equal, bit for bit, to the step of a CycleGan
    without a mesh. Returns (launches, metrics)."""
    import torch.distributed as dist

    from cyclegan_tpu_torch import kernels
    from cyclegan_tpu_torch.config import yaml2namespace
    from cyclegan_tpu_torch.parallel import create_mesh
    from cyclegan_tpu_torch.trainer import CycleGan

    dist.init_process_group(
        WORLD1_BACKEND, init_method=f"tcp://127.0.0.1:{_free_port()}",
        world_size=1, rank=0)
    try:
        backend = str(dist.get_backend())
        gans = {}
        for name, mesh in (("mesh", create_mesh(1)), ("none", None)):
            model_cfg = copy.deepcopy(cfg)
            model_cfg.location, model_cfg.new = str(workdir / name), True
            train_cfg = yaml2namespace(TRAIN_CONFIG)
            for key, value in (("batch_size", BATCH), ("image_size", SIZE),
                               ("compute_dtype", "bfloat16"),
                               ("tpu_layout", True)):
                train_cfg[key] = value
            gans[name] = CycleGan(model_cfg, train_cfg, mesh=mesh,
                                  device=DEVICE)
        a, b = (t.cpu().numpy() for t in _uint8_batch(BATCH, seed=26))
        kernels.reset_launches()
        gan = gans["mesh"]
        gan.train_step_fn(gan.state, *gan._put(a, b))
        _sync()
        launches = _launched()
        gan = gans["none"]
        gan.train_step_fn(gan.state, *gan._put(a, b))
        _sync()
    finally:
        dist.destroy_process_group()
    want = {k: len(v) for k, v in plan.items()}
    if launches != want:
        fail(f"dp_nccl1_train step launches {launches}, plan {want}")
    unequal = [f"{name}.{key}" for name, model in
               gans["mesh"].state.models.items()
               for (key, p), q in zip(model.named_parameters(),
                                      gans["none"].state.models[name]
                                      .parameters())
               if not torch.equal(p, q)]
    if unequal:
        fail(f"dp_nccl1_train: parameters after the mesh-of-one step differ "
             f"from the no-mesh step's: {unequal[:5]}")
    print(f"dp_nccl1_train: {backend} group of 1, launches {launches}, "
          f"parameters bit-equal to the no-mesh step: {not unequal}",
          flush=True)
    return launches, {"backend": backend, "bit_equal": not unequal}


def data_parallel(cfg, plan, prepare=None):
    """Phase 26 (b): RANKS ranks sharing the card over gloo (spawned),
    a data mesh of RANKS, global batch BATCH: the f32 gradients after the
    all-reduce against one rank's batch-BATCH card step, batch norm with
    dp_shard_map false (against one batch-BATCH step: global statistics)
    and true (against the mean of one step per rank's half: per-shard
    statistics; rank 0's moving statistics), each rank's bf16 launches
    against ``plan``, three finite steps, and img/s of the two ranks on one
    card (not a scaling number). Returns (rank 0's launches, metrics)."""
    from cyclegan_tpu_torch.parallel import run_ranks

    ranks = run_ranks(_dp_rank, RANKS, (_rank_settings(prepare), plan),
                      backend="gloo", timeout=RANK_TIMEOUT)
    for r, out in enumerate(ranks):
        for msg in out["failures"]:
            fail(f"rank {r}: {msg}")
    if len({out["params"] for out in ranks}) != 1:
        fail(f"dp_train: the ranks' parameters differ "
             f"{[out['params'] for out in ranks]}")
    if any(out["launches"] != ranks[0]["launches"] for out in ranks):
        fail("dp_train: the ranks launched differently")
    want = step_grads(cfg, DEVICE, "float32", _noise_batch(BATCH, SIZE, 26),
                      MODEL_DIR)
    errors = {"f32": _check_grads("dp_train", ranks[0]["f32"], want)}
    bn = batchnorm_config()
    xb = _noise_batch(BATCH, BN_DP_SIZE, 24)
    g_all, s_all = _bn_step(bn, DEVICE, "float32", xb, BN_DP_POINT)
    errors["bn_global"] = _check_grads("dp_train batch norm (global)",
                                       ranks[0][("bn", False)][0], g_all)
    errors["bn_global_stats"] = _check_stats(
        "dp_train batch norm (global)", ranks[0][("bn", False)][1], s_all)
    half = BATCH // RANKS
    parts = [_bn_step(bn, DEVICE, "float32",
                      [t[i * half:(i + 1) * half] for t in xb], BN_DP_POINT)
             for i in range(RANKS)]
    mean = {n: {k: sum(p[0][n][k] for p in parts) / RANKS for k in g}
            for n, g in parts[0][0].items()}
    errors["bn_per_shard"] = _check_grads("dp_train batch norm (per shard)",
                                          ranks[0][("bn", True)][0], mean)
    errors["bn_per_shard_stats"] = _check_stats(
        "dp_train batch norm (per shard)", ranks[0][("bn", True)][1],
        parts[0][1])
    step_s = max(out["step_s"] for out in ranks)
    result = {"ranks": RANKS, "backend": ranks[0]["backend"],
              "global_batch": BATCH, "size": SIZE,
              "gradient_errors": errors, "metrics": ranks[0]["metrics"],
              "step_ms": step_s * 1e3,
              "img_per_s_two_ranks_one_card": BATCH / step_s,
              "all_reduce_ms": max(out["all_reduce_s"] for out in ranks)
              * 1e3, "all_reduce_floats": ranks[0]["all_reduce_floats"],
              "traces": [out["trace"] for out in ranks]}
    print(f"dp_train: {RANKS} ranks sharing one card over "
          f"{result['backend']}, global batch {BATCH}: {result['step_ms']:.1f}"
          f" ms a step, {result['img_per_s_two_ranks_one_card']:.2f} img/s "
          f"(two ranks on one card: not a scaling number), gradient "
          f"all-reduce {result['all_reduce_ms']:.2f} ms for "
          f"{result['all_reduce_floats']} floats", flush=True)
    return ranks[0]["launches"], result


def _spatial_f32_points():
    return (("full", SPATIAL_F32_POINT),
            ("kink_free", SPATIAL_KINK_FREE_POINT))


def _spatial_rank(rank, world, settings, plan):
    """Phase 27 on one of ``world`` H-strip ranks sharing the card over
    gloo (``create_spatial_mesh(1, world)``, ``dp_shard_map``): the f32
    gradients at each of ``_spatial_f32_points`` with the nearest ReLU
    kink the strips met, the bf16 main path at batch BATCH against ``spatial_launches``,
    timing, and converged256 served at SPATIAL_SERVE_SIZE² through
    ``InferenceSession(spatial_devices=world)``."""
    _enter_rank(settings)
    from cyclegan_tpu_torch.apps.inference import InferenceSession
    from cyclegan_tpu_torch import kernels
    from cyclegan_tpu_torch.config import yaml2namespace
    from cyclegan_tpu_torch.ops import norm as norm_ops
    from cyclegan_tpu_torch.parallel import create_spatial_mesh, shard_batch
    from cyclegan_tpu_torch.steps import make_train_step

    mesh = create_spatial_mesh(data=1, spatial=world)
    cfg = yaml2namespace(MODEL_DIR / "model_config.yaml")
    loss, weights = cfg["loss"], cfg["loss_weights"]
    kw = dict(mesh=mesh, spatial_axis="spatial", shard_map_dp=True)
    out = {"backend": mesh.backend, "f32": {}, "nearest_kink": {}}
    activation = norm_ops.activation
    for label, point in _spatial_f32_points():
        x = shard_batch(mesh, f32_point_inputs(point),
                        spatial_axis="spatial")
        state = _train_state(cfg, DEVICE, MODEL_DIR, point["seed"],
                             point["beta"])
        nearest = [math.inf]

        def recording(y, act, alpha):
            if act != "none":
                nearest[0] = min(nearest[0], float(y.detach().abs().min()))
            return activation(y, act, alpha)

        norm_ops.activation = recording
        try:
            make_train_step(loss, weights, "float32", **kw)(
                state, *(t.to(DEVICE) for t in x))
        finally:
            norm_ops.activation = activation
        out["f32"][label], out["nearest_kink"][label] = (_grads(state),
                                                         nearest[0])
    state = _train_state(cfg, DEVICE, MODEL_DIR)
    step = make_train_step(loss, weights, "bfloat16", preprocess=_jitter,
                           **kw)
    batch = shard_batch(mesh, _uint8_batch(BATCH), axis_name=None,
                        spatial_axis="spatial")
    out["launches"], out["metrics"] = _planned_rank_step(
        "spatial_train", step, state, batch, plan)
    out["step_s"], out["all_reduce_s"], out["all_reduce_floats"] = \
        _timed_steps(step, state, batch, mesh)
    # every rank runs the traced steps: their collectives pair up
    out["trace"] = device_trace(lambda: step(state, *batch), None, 3,
                                f"spatial_rank{rank}_trace.json")
    out["params"] = float(sum(p.detach().double().sum() for m in
                              state.models.values()
                              for p in m.parameters()))
    del state, step
    session = InferenceSession(MODEL_DIR, "bfloat16", tpu_layout=True,
                               spatial_devices=world, device=DEVICE)
    images = np.random.default_rng(27).integers(
        0, 256, (SPATIAL_SERVE_BATCH, SPATIAL_SERVE_SIZE,
                 SPATIAL_SERVE_SIZE, 3), dtype=np.uint8)
    session.stylize(images, "a2b")
    kernels.reset_launches()
    out["served"] = session.stylize(images, "a2b")
    _sync()
    out["serve_launches"] = _launched()
    walls = []
    for _ in range(3):
        _sync()
        t0 = time.perf_counter()
        session.stylize(images, "a2b")
        walls.append(time.perf_counter() - t0)
    out["serve_ms"] = statistics.median(walls) * 1e3
    out["failures"] = list(failures)
    return out


def spatial(cfg, plan, serve_plan, prepare=None):
    """Phase 27: RANKS H-strip ranks sharing the card over gloo, U-Net
    (converged256) with ``dp_shard_map``: (a) the f32 step at
    ``_spatial_f32_points`` against the unsharded card step within
    TRAIN_F32_REL (the nearest kink the strips met reported at full size,
    beyond KINK_MARGIN asserted at the kink-free point), (b) each
    rank's bf16 step at batch BATCH against ``plan`` (K1, K3-K5, K7, K8 on
    strips, no K2 or K6), three finite steps, timing, (c) the spatial
    session at SPATIAL_SERVE_SIZE² (``serve_plan`` per forward) within the
    serving bounds of the unsharded sessions on the card (f32 the
    reference, bf16 the yardstick). Returns (rank 0's step launches, its
    serving launches, forwards, metrics)."""
    from cyclegan_tpu_torch.apps.inference import InferenceSession
    from cyclegan_tpu_torch.parallel import run_ranks

    ranks = run_ranks(_spatial_rank, RANKS, (_rank_settings(prepare), plan),
                      backend="gloo", timeout=RANK_TIMEOUT)
    for r, out in enumerate(ranks):
        for msg in out["failures"]:
            fail(f"rank {r}: {msg}")
    if len({out["params"] for out in ranks}) != 1:
        fail(f"spatial_train: the ranks' parameters differ "
             f"{[out['params'] for out in ranks]}")
    errors, kinks = {}, {}
    for label, point in _spatial_f32_points():
        want = step_grads(cfg, DEVICE, "float32", f32_point_inputs(point),
                          MODEL_DIR, point["seed"], point["beta"])
        errors[label] = _check_grads(f"spatial_train {label}",
                                     ranks[0]["f32"][label], want)
        kinks[label] = min(out["nearest_kink"][label] for out in ranks)
    if not kinks["kink_free"] > KINK_MARGIN:
        fail(f"spatial_train: a ReLU input {kinks['kink_free']} from its "
             f"kink at SPATIAL_KINK_FREE_POINT, within {KINK_MARGIN}")
    images = np.random.default_rng(27).integers(
        0, 256, (SPATIAL_SERVE_BATCH, SPATIAL_SERVE_SIZE,
                 SPATIAL_SERVE_SIZE, 3), dtype=np.uint8)
    ref = InferenceSession(MODEL_DIR, "float32", tpu_layout=True,
                           device=DEVICE).stylize(images, "a2b")
    whole16 = InferenceSession(MODEL_DIR, "bfloat16", tpu_layout=True,
                               device=DEVICE).stylize(images, "a2b")
    for r, out in enumerate(ranks):
        if not np.array_equal(out["served"], ranks[0]["served"]):
            fail(f"spatial_serve: rank {r} got another image")
    quality = serving_quality("spatial_serve_512", ranks[0]["served"], ref,
                              whole16)
    forwards = 1
    per_forward = {k: len(v) for k, v in serve_plan.items()}
    if ranks[0]["serve_launches"] != per_forward:
        fail(f"spatial_serve_512 launches {ranks[0]['serve_launches']}, "
             f"plan {per_forward} a forward")
    step_s = max(out["step_s"] for out in ranks)
    result = {"ranks": RANKS, "backend": ranks[0]["backend"],
              "batch": BATCH, "size": SIZE,
              "f32_points": dict(_spatial_f32_points()),
              "nearest_kink": kinks, "gradient_errors": errors,
              "metrics": ranks[0]["metrics"], "step_ms": step_s * 1e3,
              "img_per_s_two_ranks_one_card": BATCH / step_s,
              "all_reduce_ms": max(out["all_reduce_s"] for out in ranks)
              * 1e3, "traces": [out["trace"] for out in ranks],
              "serve_size": SPATIAL_SERVE_SIZE,
              "serve_batch": SPATIAL_SERVE_BATCH,
              "serve_request_ms": max(out["serve_ms"] for out in ranks),
              "quality": quality}
    print(f"spatial_train: {RANKS} strips on one card over "
          f"{result['backend']}, batch {BATCH}: {result['step_ms']:.1f} ms "
          f"a step, {result['img_per_s_two_ranks_one_card']:.2f} img/s (two "
          f"ranks on one card), nearest kinks {kinks}; spatial serving "
          f"{SPATIAL_SERVE_SIZE}² batch {SPATIAL_SERVE_BATCH}: "
          f"{result['serve_request_ms']:.1f} ms a request", flush=True)
    return (ranks[0]["launches"], ranks[0]["serve_launches"], forwards,
            result)


def _resnet_dp_rank(rank, world, settings, plan):
    """Phase 26 (c) on one of ``world`` ranks sharing the card over gloo, a
    data mesh of ``world``: the ResNet recipe's f32 gradients of the
    global batch's step (seeded weights, no jitter), then its bf16 main
    path against ``resnet_train_launches`` at the rank's batch, timing and
    a trace."""
    _enter_rank(settings)
    from cyclegan_tpu_torch.config import yaml2namespace
    from cyclegan_tpu_torch.parallel import create_mesh, shard_batch
    from cyclegan_tpu_torch.steps import make_train_step

    mesh = create_mesh(world)
    cfg = yaml2namespace(RESNET_CONFIG)
    loss, weights = cfg["loss"], cfg["loss_weights"]
    out = {"backend": mesh.backend}
    point = RESNET_DP_F32_POINT
    for label, x, seed in (
            ("point", f32_point_inputs(point), point["seed"]),
            ("full", _noise_batch(BATCH, SIZE, 26), 0)):
        state = _train_state(cfg, DEVICE, None, seed)
        with deterministic_cudnn():
            make_train_step(loss, weights, "float32", mesh=mesh)(
                state, *(t.to(DEVICE) for t in shard_batch(mesh, x)))
        out[label] = _grads(state)
    state = _train_state(cfg, DEVICE)
    step = make_train_step(loss, weights, "bfloat16", preprocess=_jitter,
                           mesh=mesh)
    batch = shard_batch(mesh, _uint8_batch(BATCH))
    out["launches"], out["metrics"] = _planned_rank_step(
        "resnet_dp_train", step, state, batch, plan)
    out["step_s"], out["all_reduce_s"], out["all_reduce_floats"] = \
        _timed_steps(step, state, batch, mesh)
    out["trace"] = device_trace(lambda: step(state, *batch), None, 3,
                                f"resnet_dp_rank{rank}_trace.json")
    out["params"] = float(sum(p.detach().double().sum() for m in
                              state.models.values()
                              for p in m.parameters()))
    out["failures"] = list(failures)
    return out


def resnet_data_parallel(cfg, plan, prepare=None):
    """Phase 26 (c): the ResNet recipe on RANKS data ranks sharing the
    card over gloo, global batch BATCH: the f32 gradients after the
    all-reduce against one rank's batch-BATCH card step at
    RESNET_DP_F32_POINT within TRAIN_F32_REL and, at SIZE², against the
    mean of one card step on each rank's half within RESNET_DP_HALVES_REL
    (cuDNN deterministic), each rank's bf16 launches against ``plan``
    (``resnet_train_launches`` at the rank's batch: K9, K9-dW, K10, K1, K5,
    K2, K6), three finite steps, the step's and the gradient all-reduce's
    time and the device busy time of a rank step. Returns (rank 0's
    launches, metrics)."""
    from cyclegan_tpu_torch.parallel import run_ranks

    ranks = run_ranks(_resnet_dp_rank, RANKS, (_rank_settings(prepare),
                                               plan),
                      backend="gloo", timeout=RANK_TIMEOUT)
    for r, out in enumerate(ranks):
        for msg in out["failures"]:
            fail(f"rank {r}: {msg}")
    if len({out["params"] for out in ranks}) != 1:
        fail(f"resnet_dp_train: the ranks' parameters differ "
             f"{[out['params'] for out in ranks]}")
    if any(out["launches"] != ranks[0]["launches"] for out in ranks):
        fail("resnet_dp_train: the ranks launched differently")
    point = RESNET_DP_F32_POINT
    with deterministic_cudnn():
        errors = {"point": _check_grads(
            "resnet_dp_train", ranks[0]["point"],
            step_grads(cfg, DEVICE, "float32", f32_point_inputs(point),
                       None, point["seed"]))}
        x = _noise_batch(BATCH, SIZE, 26)
        half = BATCH // RANKS
        parts = [step_grads(cfg, DEVICE, "float32",
                            [t[i * half:(i + 1) * half] for t in x])
                 for i in range(RANKS)]
    errors["rank_halves"] = {}
    for name, grads in ranks[0]["full"].items():
        mean = {k: sum(p[name][k] for p in parts) / RANKS for k in grads}
        rel, bias = f32_errors(grads, mean)
        errors["rank_halves"][name] = {"rel": rel, "pre_norm_bias": bias}
        if not (rel <= RESNET_DP_HALVES_REL
                and bias <= RESNET_DP_HALVES_REL):
            fail(f"resnet_dp_train {name}: gradient error {rel} (pre-norm "
                 f"biases {bias}) against the mean of the halves' steps "
                 f"beyond {RESNET_DP_HALVES_REL}")
    print(f"resnet_dp_train f32 gradients vs the mean of the halves' steps: "
          f"{json.dumps(errors['rank_halves'])}", flush=True)
    step_s = max(out["step_s"] for out in ranks)
    traces = [out["trace"] for out in ranks]
    result = {"ranks": RANKS, "backend": ranks[0]["backend"],
              "global_batch": BATCH, "size": SIZE, "f32_point": point,
              "gradient_errors": errors, "metrics": ranks[0]["metrics"],
              "step_ms": step_s * 1e3,
              "img_per_s_two_ranks_one_card": BATCH / step_s,
              "all_reduce_ms": max(out["all_reduce_s"] for out in ranks)
              * 1e3, "all_reduce_floats": ranks[0]["all_reduce_floats"],
              "traces": traces}
    busy = [t["device_busy_ms_per_call"] for t in traces if t]
    print(f"resnet_dp_train: {RANKS} ranks sharing one card over "
          f"{result['backend']}, global batch {BATCH}: "
          f"{result['step_ms']:.1f} ms a step, device busy "
          f"{busy or 'not measured'} ms a rank step, gradient all-reduce "
          f"{result['all_reduce_ms']:.2f} ms for "
          f"{result['all_reduce_floats']} floats", flush=True)
    return ranks[0]["launches"], result


def _http_client(httpd, body, replies):
    """One request to the spatial server, then its shutdown."""
    try:
        port = httpd.server_address[1]
        replies.append(_post(
            f"http://127.0.0.1:{port}/stylize?direction=a2b", body))
    finally:
        httpd.shutdown()


def _spatial_more_rank(rank, world, settings, http_plan):
    """Phases 27 (c) and (d) on one of ``world`` H-strip ranks sharing the
    card over gloo: (c) ``apps.server.serve(spatial_devices=world)`` on
    every rank, rank 0 posting one SPATIAL_SERVE_SIZE² PNG (the counts
    zeroed once the server is up, read after it stopped: the request's
    forward against ``http_plan``), then the same ranks' spatial session
    on the image; (d) the paired f32 step (NHWC) at
    SPATIAL_KINK_FREE_POINT on the strips, with the counts zeroed around
    it."""
    import threading

    _enter_rank(settings)
    from cyclegan_tpu_torch import kernels
    from cyclegan_tpu_torch.apps import server as server_app
    from cyclegan_tpu_torch.apps.inference import InferenceSession
    from cyclegan_tpu_torch.config import yaml2namespace
    from cyclegan_tpu_torch.data import png
    from cyclegan_tpu_torch.parallel import create_spatial_mesh, shard_batch
    from cyclegan_tpu_torch.steps import make_train_step

    image = np.random.default_rng(27).integers(
        0, 256, (SPATIAL_SERVE_SIZE, SPATIAL_SERVE_SIZE, 3), dtype=np.uint8)
    replies, clients = [], []

    def on_ready(httpd):
        kernels.reset_launches()
        clients.append(threading.Thread(target=_http_client, args=(
            httpd, png.encode_png(image), replies)))
        clients[0].start()

    t0 = time.perf_counter()
    followed = server_app.serve(MODEL_DIR, "127.0.0.1", 0,
                                SPATIAL_SERVE_SIZE, dtype="bfloat16",
                                spatial_devices=world, device=DEVICE,
                                on_ready=on_ready)
    for t in clients:
        t.join()
    _sync()
    out = {"followed": followed, "serve_s": time.perf_counter() - t0,
           "http_launches": _launched() if rank == 0 else None}
    if rank == 0:
        code, headers, body = replies[0]
        if code != 200:
            fail(f"spatial_http_512: status {code} {body[:200]!r}")
            body = None
        out["reply"] = None if body is None else png.decode_png(body)
        out["timing"] = _server_timing(headers)
    session = InferenceSession(MODEL_DIR, "bfloat16", tpu_layout=True,
                               spatial_devices=world, device=DEVICE)
    out["stylized"] = session.stylize(image[None], "a2b")[0]
    del session

    mesh = create_spatial_mesh(data=1, spatial=world)
    cfg = yaml2namespace(MODEL_DIR / "model_config.yaml")
    point = SPATIAL_KINK_FREE_POINT
    x = shard_batch(mesh, f32_point_inputs(point), spatial_axis="spatial")
    state = _train_state(cfg, DEVICE, MODEL_DIR, point["seed"],
                         point["beta"])
    step = make_train_step(cfg["loss"], cfg["loss_weights"], "float32",
                           tpu_layout=False, paired=True, mesh=mesh,
                           spatial_axis="spatial", shard_map_dp=True)
    kernels.reset_launches()
    metrics = step(state, *(t.to(DEVICE) for t in x))
    _sync()
    out["paired_launches"] = _launched()
    out["paired_metrics"] = {k: float(v) for k, v in metrics.items()}
    out["paired_f32"] = _grads(state)
    out["failures"] = list(failures)
    return out


def spatial_server_paired(cfg, http_plan, prepare=None):
    """Phase 27 (c) and (d), RANKS H-strip ranks sharing the card over
    gloo: (c) the HTTP server with ``spatial_devices=RANKS`` at
    SPATIAL_SERVE_SIZE², its reply equal bit for bit to the same ranks'
    spatial ``stylize`` of the image and within the serving bounds of the
    unsharded f32 and bf16 card sessions, the follower's ``serve``
    returned after the warm-ups and the request, the request's launches
    ``http_plan``; (d) the paired f32 step on the strips against one
    rank's paired step within PAIRED_SPATIAL_REL (``f32_errors``), no
    hand kernel launched (cuDNN through ``LibraryConv``'s vmap rule, the
    norms in torch ops with summed statistics). Returns (rank 0's request
    launches, the paired step's launches, metrics)."""
    from cyclegan_tpu_torch.apps import server as server_app
    from cyclegan_tpu_torch.apps.inference import InferenceSession
    from cyclegan_tpu_torch.parallel import run_ranks

    ranks = run_ranks(_spatial_more_rank, RANKS,
                      (_rank_settings(prepare), http_plan),
                      backend="gloo", timeout=RANK_TIMEOUT)
    for r, out in enumerate(ranks):
        for msg in out["failures"]:
            fail(f"rank {r}: {msg}")
    lead = ranks[0]
    image = np.random.default_rng(27).integers(
        0, 256, (SPATIAL_SERVE_SIZE, SPATIAL_SERVE_SIZE, 3), dtype=np.uint8)
    result = {"serve_s": max(out["serve_s"] for out in ranks),
              "server_timing_ms": lead.get("timing")}
    if lead["followed"] is not None or ranks[1]["followed"] != len(
            server_app.DIRECTIONS) + 1:
        fail(f"spatial_http_512: the ranks followed "
             f"{[out['followed'] for out in ranks]} requests, want "
             f"[None, {len(server_app.DIRECTIONS) + 1}]")
    for r, out in enumerate(ranks):
        if not np.array_equal(out["stylized"], lead["stylized"]):
            fail(f"spatial_http_512: rank {r}'s stylize differs")
    reply = lead.get("reply")
    if reply is not None:
        if not np.array_equal(reply, lead["stylized"]):
            fail("spatial_http_512: the reply is not the ranks' stylize")
        ref = InferenceSession(MODEL_DIR, "float32", tpu_layout=True,
                               device=DEVICE).stylize(image[None], "a2b")
        whole16 = InferenceSession(MODEL_DIR, "bfloat16", tpu_layout=True,
                                   device=DEVICE).stylize(image[None],
                                                          "a2b")
        result["quality"] = serving_quality("spatial_http_512",
                                            reply[None], ref, whole16)
    want = {k: len(v) for k, v in http_plan.items()}
    if lead["http_launches"] != want:
        fail(f"spatial_http_512 launches {lead['http_launches']}, plan "
             f"{want}")
    point = SPATIAL_KINK_FREE_POINT
    single = step_grads(cfg, DEVICE, "float32", f32_point_inputs(point),
                        MODEL_DIR, point["seed"], point["beta"],
                        tpu_layout=False, paired=True)
    errors = {}
    for name in single:
        rel, bias = f32_errors(lead["paired_f32"][name], single[name])
        errors[name] = {"rel": rel, "pre_norm_bias": bias}
        if not (rel <= PAIRED_SPATIAL_REL and bias <= PAIRED_SPATIAL_REL):
            fail(f"spatial_paired {name}: gradient error {rel} (pre-norm "
                 f"biases {bias}) beyond {PAIRED_SPATIAL_REL}")
    for r, out in enumerate(ranks):
        if out["paired_launches"]:
            fail(f"spatial_paired: rank {r} launched {out['paired_launches']}"
                 f", want no hand kernel")
    result["paired"] = {"gradient_errors": errors,
                        "metrics": lead["paired_metrics"]}
    print(f"spatial_http_512: reply bit-equal to the ranks' stylize, "
          f"{result['serve_s']:.1f} s from session to shutdown, server "
          f"timing {json.dumps(result['server_timing_ms'])}; "
          f"spatial_paired f32 vs one rank: {json.dumps(errors)}",
          flush=True)
    return lead["http_launches"], lead["paired_launches"], result


BUNDLE_DTYPES = {np.dtype("<f4"): 1, np.dtype("<f8"): 2, np.dtype("<f2"): 19}
TABLE_MAGIC = 0xDB4775248B80FB57


def _table_block(entries):
    """A LevelDB table block of (key, value) bytes pairs in key order, no
    prefix compression, one restart point, and its trailer (type 0, none,
    and the masked crc32c of the contents and the type)."""
    import struct

    from cyclegan_tpu_torch.data.example_proto import _encode_varint
    from cyclegan_tpu_torch.data.tfrecord import _masked_crc32c

    body = bytearray()
    for key, value in entries:
        body += (_encode_varint(0) + _encode_varint(len(key))
                 + _encode_varint(len(value)) + key + value)
    body += struct.pack("<II", 0, 1)
    return bytes(body), b"\x00" + struct.pack(
        "<I", _masked_crc32c(bytes(body) + b"\x00"))


def write_bundle(prefix, tensors):
    """A TensorFlow tensor bundle (``<prefix>.index`` and
    ``<prefix>.data-00000-of-00001``) of float arrays by name, as
    ``tf.raw_ops.SaveV2`` writes one: the data file the arrays' bytes in
    key order, the index a table of one data block (the header under the
    empty key, then each ``BundleEntryProto``), an empty metaindex block,
    an index block and the 48-byte footer."""
    import struct

    from cyclegan_tpu_torch.data.example_proto import (
        _encode_varint,
        _len_delimited,
        _tag,
    )
    from cyclegan_tpu_torch.data.tfrecord import _masked_crc32c

    def varint_field(field, value):
        return _tag(field, 0) + _encode_varint(value)

    prefix = Path(prefix)
    prefix.parent.mkdir(parents=True, exist_ok=True)
    header = varint_field(1, 1) + _len_delimited(3, varint_field(1, 1))
    entries, data = [(b"", header)], bytearray()
    for name in sorted(tensors):
        arr = np.asarray(tensors[name])
        arr = arr.astype(arr.dtype.newbyteorder("<"))
        raw = arr.tobytes()
        shape = b"".join(_len_delimited(2, varint_field(1, d))
                         for d in arr.shape)
        entry = (varint_field(1, BUNDLE_DTYPES[arr.dtype])
                 + _len_delimited(2, shape)
                 + (varint_field(4, len(data)) if data else b"")
                 + varint_field(5, len(raw))
                 + _tag(6, 5) + struct.pack("<I", _masked_crc32c(raw)))
        entries.append((name.encode(), entry))
        data += raw
    Path(f"{prefix}.data-00000-of-00001").write_bytes(bytes(data))
    out, handles = bytearray(), []
    for block in (entries, [], None):
        if block is None:  # the index: the data block's last key
            block = [(entries[-1][0], handles[0])]
        body, trailer = _table_block(block)
        handles.append(_encode_varint(len(out)) + _encode_varint(len(body)))
        out += body + trailer
    footer = handles[1] + handles[2]
    out += footer + bytes(40 - len(footer)) + struct.pack("<Q", TABLE_MAGIC)
    Path(f"{prefix}.index").write_bytes(bytes(out))


def write_reference_folder(folder, model_dir, seed=IMPORT_SEED):
    """``model_dir``'s four networks in the reference's layout: each a
    SavedModel folder whose ``variables`` bundle holds its weights under
    the Keras layer keys (``import_reference.enumerate_slots``' order), a
    ``<network>_optimizer.npy`` of Adam slots drawn from ``seed`` with
    IMPORT_ITERATIONS iterations, and the two configs. Returns (the
    parameter trees, {network: (m slots, v slots)})."""
    import shutil

    from cyclegan_tpu_torch.apps.import_reference import (
        NETWORKS,
        enumerate_slots,
        network_arch,
        trainable_leaves,
    )
    from cyclegan_tpu_torch.config import yaml2namespace
    from cyclegan_tpu_torch.steps import build_models
    from cyclegan_tpu_torch.utils.checkpoint import load_pytree
    from cyclegan_tpu_torch.weights import models_to_jax_params

    folder = Path(folder)
    cfg = yaml2namespace(model_dir / "model_config.yaml")
    params = load_pytree(model_dir / "checkpoint.npz", {
        "params": models_to_jax_params(build_models(cfg))})["params"]
    rng = np.random.default_rng(seed)
    slots = {}
    for name in NETWORKS:
        arch = network_arch(cfg, name)
        tensors = {
            f"layer_with_weights-{i}/{tf_attr}/.ATTRIBUTES/VARIABLE_VALUE":
                target[key]
            for i, (attrs, target) in enumerate(enumerate_slots(
                arch, params[name])) for tf_attr, key in attrs}
        write_bundle(folder / name / "variables" / "variables", tensors)
        (folder / name / "saved_model.pb").write_bytes(b"")
        leaves = [d[k] for d, k in trainable_leaves(arch, params[name])]
        ms = [(0.01 * rng.normal(size=v.shape)).astype(np.float32)
              for v in leaves]
        vs = [(1e-4 * np.abs(rng.normal(size=v.shape))).astype(np.float32)
              for v in leaves]
        blob = np.empty(1 + 2 * len(leaves), dtype=object)
        blob[0] = np.int64(IMPORT_ITERATIONS)
        for i, arr in enumerate(ms + vs):
            blob[1 + i] = arr
        np.save(folder / f"{name}_optimizer.npy", blob, allow_pickle=True)
        slots[name] = (ms, vs)
    for config in ("model_config.yaml", "train_config.yaml"):
        shutil.copyfile(model_dir / config, folder / config)
    return params, slots


def _direct_state(cfg, params, slots):
    """A train state built straight from ``params`` and the Adam
    ``slots`` (IMPORT_ITERATIONS steps), on the card."""
    from cyclegan_tpu_torch.apps.import_reference import (
        network_arch,
        trainable_leaves,
    )
    from cyclegan_tpu_torch.utils.checkpoint import restore_optimizer
    from cyclegan_tpu_torch.weights import load_jax_params, \
        module_to_jax_params

    state = _train_state(cfg, DEVICE)
    load_jax_params(state.models, params)
    for name, model in state.models.items():
        arch = network_arch(cfg, name)
        trees = []
        for arrays in slots[name]:
            tree = module_to_jax_params(model)
            for (d, k), arr in zip(trainable_leaves(arch, tree), arrays):
                d[k] = arr
            trees.append(tree)
        restore_optimizer(model, state.optimizers[name], [
            {"count": np.int32(IMPORT_ITERATIONS), "mu": trees[0],
             "nu": trees[1]}, {}], IMPORT_ITERATIONS)
    state.step = IMPORT_ITERATIONS
    return state


def import_reference(cfg, serve_plan, train_plan, workdir):
    """Phase 28: converged256 written in the reference's layout
    (``write_reference_folder``: four tensor bundles, Adam ``.npy`` slots),
    imported by ``import_reference_model`` on the card (TensorFlow is not
    imported); (a) a bf16 NHCW batch-BATCH forward of the import equal bit
    for bit to converged256's own, its launches ``serve_plan``; (b) one
    f32 step (batch GRAD_BATCH, no jitter) resumed from the import equal
    bit for bit, in every parameter and Adam slot, to a step from a state
    built straight from the same parameters and slots, its launches
    ``train_plan`` with each K1 and K5 launch also counted under its
    CUDA-core design. Returns ({path: launches}, metrics)."""
    from cyclegan_tpu_torch import kernels
    from cyclegan_tpu_torch.apps.import_reference import (
        import_reference_model,
    )
    from cyclegan_tpu_torch.apps.inference import InferenceSession
    from cyclegan_tpu_torch.steps import make_train_step
    from cyclegan_tpu_torch.utils.checkpoint import load_train_state

    reference, imported = workdir / "reference", workdir / "imported"
    t0 = time.perf_counter()
    params, slots = write_reference_folder(reference, MODEL_DIR)
    t1 = time.perf_counter()
    before = "tensorflow" in sys.modules
    import_reference_model(reference, imported, device=DEVICE)
    t2 = time.perf_counter()
    result = {"write_s": t1 - t0, "import_s": t2 - t1,
              "tensorflow_imported": not before
              and "tensorflow" in sys.modules}
    if result["tensorflow_imported"]:
        fail("import_reference: the import imported TensorFlow")
    images = np.random.default_rng(IMPORT_SEED).integers(
        0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    own = InferenceSession(MODEL_DIR, "bfloat16", tpu_layout=True,
                           device=DEVICE).stylize(images, "a2b")
    session = InferenceSession(imported, "bfloat16", tpu_layout=True,
                               device=DEVICE)
    kernels.reset_launches()
    got = session.stylize(images, "a2b")
    _sync()
    launches = {"import_serve": _launched()}
    del session
    served_equal = bool(np.array_equal(got, own))
    if not served_equal:
        fail(f"import_serve: the imported forward differs from "
             f"converged256's at {int((got != own).sum())} values")
    if launches["import_serve"] != {k: len(v) for k, v in
                                    serve_plan.items()}:
        fail(f"import_serve launches {launches['import_serve']}, plan "
             f"{ {k: len(v) for k, v in serve_plan.items()} }")

    x = [t.to(DEVICE) for t in f32_point_inputs(
        {"batch": GRAD_BATCH, "size": SIZE, "seed": IMPORT_SEED})]
    resumed = _train_state(cfg, DEVICE)
    load_train_state(imported / "checkpoint.npz", resumed)
    direct = _direct_state(cfg, params, slots)
    if resumed.step != IMPORT_ITERATIONS:
        fail(f"import_resume_train: step {resumed.step}, want "
             f"{IMPORT_ITERATIONS}")
    step = make_train_step(cfg["loss"], cfg["loss_weights"], "float32")
    kernels.reset_launches()
    metrics = step(resumed, *x)
    _sync()
    launches["import_resume_train"] = _launched()
    step(direct, *x)
    _sync()
    unequal = []
    for name, model in resumed.models.items():
        other = direct.models[name]
        opt, other_opt = resumed.optimizers[name], direct.optimizers[name]
        for (key, p), q in zip(model.named_parameters(), other.parameters()):
            same = torch.equal(p, q) and all(
                torch.equal(opt.state[p][k], other_opt.state[q][k])
                for k in ("exp_avg", "exp_avg_sq", "step"))
            if not same:
                unequal.append(f"{name}.{key}")
    if unequal:
        fail(f"import_resume_train: the resumed step differs from the "
             f"direct one at {unequal[:5]}")
    want = {k: len(v) for k, v in train_plan.items()}
    want[SIMT] = want["conv_dw"]
    want[SIMT_SAME] = want["conv_same"]
    if launches["import_resume_train"] != want:
        fail(f"import_resume_train launches "
             f"{launches['import_resume_train']}, plan {want}")
    result.update(serve_bit_equal=served_equal,
                  resume_bit_equal=not unequal,
                  resume_metrics={k: float(v) for k, v in metrics.items()})
    print(f"import_reference: wrote the reference folder in "
          f"{result['write_s']:.1f} s, imported it in "
          f"{result['import_s']:.1f} s without TensorFlow; forward and "
          f"resumed step bit-equal: {not unequal}", flush=True)
    return launches, result


def _nccl_rank(rank, world):
    torch.cuda.set_device(0)
    t = torch.ones(1, device="cuda")
    import torch.distributed as dist

    dist.all_reduce(t)
    return float(t)


def nccl_two_ranks():
    """Whether NCCL takes two ranks on the one card (it refuses a
    duplicate GPU): the first line of its error, or None where it took
    them. The phases with two ranks on the card use gloo."""
    from cyclegan_tpu_torch.parallel import run_ranks

    try:
        run_ranks(_nccl_rank, RANKS, backend="nccl", timeout=120)
    except RuntimeError as exc:
        lines = [line.strip() for line in str(exc).splitlines()
                 if "uplicate" in line or "Error" in line]
        note = lines[0] if lines else str(exc).splitlines()[-1]
        print(f"nccl with {RANKS} ranks on one card: {note}", flush=True)
        return note
    print(f"nccl with {RANKS} ranks on one card: accepted", flush=True)
    return None
def kernel_entries(rows, max_err, launches, forwards, serve_plans):
    """The ``kernels`` JSON line: per kernel, its launches in every main
    path's run (``launches`` their sum), and its times summed over the
    launches of one train step of each planned path: the recipes and the
    step's options (``paths`` splits them by train step and by serving
    forward). A path's kernel with no timed shape on it (the trainer's
    runs; U-GAT-IT's convs) gives its launches only."""
    from cyclegan_tpu_torch import kernels

    planned = {p for r in rows for p in r["per_step"]} - set(serve_plans)
    train_paths = [p for p in launches if p in planned]
    entries = []
    for name in kernels.KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        by_shape = {tuple(r["shape"]): r for r in mine}
        paths = {}
        for path in train_paths:
            used = [(r, r["per_step"].get(path, 0)) for r in mine
                    if r["per_step"].get(path, 0)]
            n = launches[path].get(name, 0)
            paths[path] = _sums(used, n) if used else {"launches": n}
        for path, plan in serve_plans.items():
            used = [(by_shape[shape], n) for shape, n in
                    collections.Counter(plan.get(name, [])).items()]
            paths[path] = _sums(used, launches[path].get(name, 0))
            paths[path]["forwards"] = forwards[path]
        for path in launches:  # the trainer's runs: launches only
            if path not in paths:
                paths[path] = {"launches": launches[path].get(name, 0)}
        paths = {path: v for path, v in paths.items() if v["launches"]}
        total = _sums([(r, sum(r["per_step"].get(p, 0)
                               for p in train_paths)) for r in mine], 0)
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


# Phase 29: U-GAT-IT (``models/ugatit.py``) at its published widths,
# 256x256, batch 8, seeded from the port's own init (PyTorch's default).
UGATIT_CONFIG = {
    "generator": {"type": "ugatit_generator", "ngf": 64, "n_res": 4,
                  "img_size": SIZE},
    "discriminator": {"type": "ugatit_discriminator", "ndf": 64,
                      "n_layers_global": 7, "n_layers_local": 5},
    "loss": "ugatit",
    "loss_weights": {"adversarial": 1.0, "cycle": 10.0, "identity": 10.0,
                     "cam": 1000.0}}
UGATIT_OPT = {"name": "adam", "learning_rate": 1e-4, "beta_1": 0.5,
              "beta_2": 0.999, "epsilon": 1e-8, "weight_decay": 1e-4}
# the spectral-normalised weights' ``u`` buffers of more than one element
# in the two discriminators (the convolution blocks': 6 global, 4 local
# each), which every train step's power iterations move; the C->1 logits'
# and the head's ``u`` are one element, 1 whatever an iteration does
UGATIT_SN_BUFFERS = 2 * (6 + 4)
# K14/K15 launch shapes (B, H, C, W, per-sample gamma, relu) of a train
# step and a serving forward at batch 8, each with its launches per
# generator application: the four AdaLIN blocks' two norms and the two ILN
# up-blocks; then edge shapes beyond them (W of no whole 16-byte unit: the
# element path; one sample; C past the CTA's threads)
UGATIT_NORM_SHAPES = {(BATCH, 64, 256, 64, True, True): 4,
                      (BATCH, 64, 256, 64, True, False): 4,
                      (BATCH, 128, 128, 128, False, True): 1,
                      (BATCH, 256, 64, 256, False, True): 1}
UGATIT_EDGE_NORM_SHAPES = [(2, 6, 5, 7, True, True), (1, 16, 300, 16, True,
                                                      False),
                           (3, 10, 7, 12, False, True)]
UGATIT_NORMS_PER_APP = sum(UGATIT_NORM_SHAPES.values())
# the generator applications a train step differentiates: two
# translations, two cycles, two identities
UGATIT_APPS_PER_STEP = 6
UGATIT_PATH = "ugatit_train"


def ugatit_dw_launches(batch=BATCH, size=SIZE):
    """The K9-dW launches of one U-GAT-IT train step, (B, H, Cin, Cout, K),
    one per reflect conv of each of the step's generator applications: the
    7x7 stem, the n_res residual and n_res AdaLIN blocks' two 3x3 convs
    each at size / 4, the two up-blocks' 3x3 convs and the 7x7 head (its
    discriminators' convs are the library's)."""
    gen = UGATIT_CONFIG["generator"]
    f, s4 = int(gen["ngf"]), size // 4
    app = ([(batch, size, 3, f, 7)]
           + [(batch, s4, 4 * f, 4 * f, 3)] * (4 * int(gen["n_res"]))
           + [(batch, size // 2, 4 * f, 2 * f, 3),
              (batch, size, 2 * f, f, 3), (batch, size, f, 3, 7)])
    return {"conv_reflect_dw": app * UGATIT_APPS_PER_STEP}


def _ada_inputs(shape, dtype, seed=0):
    b, h, c, w, per_sample, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = dict(device="cuda", generator=g)
    x = (torch.randn((b, h, c, w), **dev) * 1.5 + 0.3).to(dtype)
    gy = torch.randn((b, h, c, w), **dev).to(dtype)
    rho = torch.rand(c, **dev)
    pshape = (b, c) if per_sample else (c,)
    gamma = torch.randn(pshape, **dev)
    beta = torch.randn(pshape, **dev)
    return x, gy, rho, gamma, beta


def check_ada_norm(shapes, label=""):
    """K14 and K15 against their plain versions (run on the card in f32
    from the same inputs), bf16 and f32, each bf16 case twice for bit
    equality; returns {(kernel, dtype): max abs error}."""
    from cyclegan_tpu_torch.ops import ada_norm as an

    errs = collections.defaultdict(float)
    for shape in shapes:
        relu = shape[5]
        for dtype in (torch.bfloat16, torch.float32):
            x, gy, rho, gamma, beta = _ada_inputs(shape, dtype)
            y, saved, stats = an.ada_norm_cuda(x, rho, gamma, beta,
                                               relu=relu, with_stats=True)
            y_p, saved_p, stats_p = an.ada_norm_plain(
                x, rho, gamma, beta, relu=relu, with_stats=True)
            back = an.ada_norm_bwd_cuda(x, gy, rho, gamma, saved, stats,
                                        relu)
            back_p = an.ada_norm_bwd_plain(x, gy, rho, gamma, saved, stats,
                                           relu)
            e_fwd = float((y.float() - y_p.float()).abs().max())
            e_stats = max(float((a - b).abs().max() / b.abs().max())
                          for a, b in ((saved[0], saved_p[0]),
                                       (saved[2], saved_p[2]),
                                       (stats, stats_p)))
            e_bwd = max(float((a.float() - b.float()).abs().max()
                              / b.float().abs().max().clamp_min(1e-30))
                        for a, b in zip(back, back_p))
            tol = 0.02 if dtype == torch.bfloat16 else 1e-4
            scale = float(y_p.float().abs().max())
            for name, err, bound in (("ada_norm", e_fwd, tol * scale),
                                     ("ada_norm_stats", e_stats, 1e-4),
                                     ("ada_norm_bwd", e_bwd, 5 * tol)):
                print(f"{label}{name} {shape} {dtype}: max err {err:.3g} "
                      f"(bound {bound:.3g})", flush=True)
                if not err <= bound:
                    fail(f"{name} {shape} {dtype}: error {err} > {bound}")
                key = name if name != "ada_norm_stats" else "ada_norm"
                errs[(key, dtype)] = max(errs[(key, dtype)],
                                         err / (scale if name == "ada_norm"
                                                else 1.0))
            if dtype == torch.bfloat16:
                y2 = an.ada_norm_cuda(x, rho, gamma, beta, relu=relu)
                back2 = an.ada_norm_bwd_cuda(x, gy, rho, gamma, saved,
                                             stats, relu)
                if not (torch.equal(y, y2) and all(
                        torch.equal(a, b) for a, b in zip(back, back2))):
                    fail(f"ada_norm {shape}: two runs differ")
    return dict(errs)


def time_ada_norm(shapes):
    """K14 and K15 at each shape of ``shapes`` ({shape: launches per
    generator application}, bf16), each beside its plain version and the
    least time of the bytes it reads and writes once (forward x in, y out;
    backward x and dy in, dx out) at the card's bandwidth: rows as
    ``time_kernels`` makes them, per step of ``UGATIT_PATH``."""
    from cyclegan_tpu_torch.ops import ada_norm as an

    rows = []
    for shape, per_app in shapes.items():
        relu = shape[5]
        x, gy, rho, gamma, beta = _ada_inputs(shape, torch.bfloat16)
        _, saved, stats = an.ada_norm_cuda(x, rho, gamma, beta, relu=relu,
                                           with_stats=True)
        nbytes = x.numel() * x.element_size()
        for name, kernel, plain, moved in (
                ("ada_norm",
                 lambda: an.ada_norm_cuda(x, rho, gamma, beta, relu=relu),
                 lambda: an.ada_norm_plain(x, rho, gamma, beta, relu=relu),
                 2 * nbytes),
                ("ada_norm_bwd",
                 lambda: an.ada_norm_bwd_cuda(x, gy, rho, gamma, saved,
                                              stats, relu),
                 lambda: an.ada_norm_bwd_plain(x, gy, rho, gamma, saved,
                                               stats, relu),
                 3 * nbytes)):
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            row = {"kernel": name, "shape": list(shape),
                   "per_step": {UGATIT_PATH: UGATIT_APPS_PER_STEP * per_app},
                   "ms": time_ms(kernel), "plain_ms": time_ms(plain),
                   "library_ms": None, "bytes": moved, "operations": 0,
                   "bytes_ms": bytes_ms, "ops_ms": 0.0, "bound_ms": bytes_ms,
                   "fits_l2": moved <= L2_BYTES, "copy_ms": None}
            row["bound_share"] = row["bound_ms"] / row["ms"]
            rows.append(row)
            print(f"time {name} {shape} {row['per_step']} kernel "
                  f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f}  bound "
                  f"{bytes_ms:.4f} ({100 * row['bound_share']:.1f}% of it)",
                  flush=True)
    return rows


def ugatit(out_dir):
    """Phase 29: K14/K15 checked at every launch shape of a U-GAT-IT train
    step and serving forward and at the edge shapes, timed; then the
    trainer's step at batch 8 (eager, captured, replayed): its K14/K15
    launches, every discriminator ``u`` buffer moved by each step, finite
    losses, img/s over replayed steps and peak memory with the graph's
    pool."""
    from cyclegan_tpu_torch import kernels, tracing
    from cyclegan_tpu_torch.config import Namespace
    from cyclegan_tpu_torch.trainer import CycleGan

    with no_tf32():
        errs = check_ada_norm(UGATIT_NORM_SHAPES)
        for key, err in check_ada_norm(UGATIT_EDGE_NORM_SHAPES,
                                       "edge ").items():
            errs[key] = max(errs.get(key, 0.0), err)
    for name in ("ada_norm", "ada_norm_bwd"):
        took = {p.split(".")[1] for p in kernels.paths
                if p.startswith(name + ".")}
        if took != {"vector", "element"}:
            fail(f"{name}: phase 29 ran only the paths {took}")
    rows = time_ada_norm(UGATIT_NORM_SHAPES)
    with tempfile.TemporaryDirectory() as tmp:
        model = Namespace({"name": "ugatit", "new": True, "location": tmp,
                           "seed": 0, **UGATIT_CONFIG})
        train_cfg = Namespace({
            "epochs": 1, "batch_size": BATCH, "image_size": SIZE,
            "g_opt": UGATIT_OPT, "d_opt": dict(UGATIT_OPT),
            "compute_dtype": "bfloat16", "tpu_layout": "auto",
            "display_every": 0, "nan_check": False})
        torch.cuda.reset_peak_memory_stats()
        trainer = CycleGan(model, train_cfg, device="cuda")
        params = sum(p.numel() for m in trainer.state.models.values()
                     for p in m.parameters())
        a, b = _uniform_pair(BATCH, SIZE)
        us = [u for n in ("d_A", "d_B") for k, u in
              trainer.state.models[n].named_buffers()
              if k.endswith(".u") and u.numel() > 1]
        counts, losses = [], []
        for i in range(3):
            kernels.reset_launches()
            before = [u.clone() for u in us]
            m = trainer.train_step_fn(trainer.state, *trainer._put(a, b))
            launched = {k: v for k, v in kernels.launches.items() if v}
            losses.append({k: float(v) for k, v in m.items()})
            entry = tracing.entries()[-1]
            counts.append({"u_moved": sum(not torch.equal(u, old)
                                          for u, old in zip(us, before)),
                           "replayed": bool(entry["counters"].get(
                               "graph_replay")),
                           "ada_norm": kernels.launches["ada_norm"],
                           "ada_norm_bwd": kernels.launches["ada_norm_bwd"],
                           "conv_reflect_dw":
                               kernels.launches["conv_reflect_dw"],
                           "dw_ring": kernels.paths["conv_reflect_dw.ring"],
                           "dw_simt": kernels.launches[SIMT]})
        print(f"ugatit steps: {counts}; losses {losses}", flush=True)
        want = UGATIT_APPS_PER_STEP * UGATIT_NORMS_PER_APP
        for i, c in enumerate(counts):
            if len(us) != UGATIT_SN_BUFFERS or c["u_moved"] != len(us):
                fail(f"ugatit step {i}: moved {c['u_moved']} of {len(us)} "
                     f"u buffers, want all {UGATIT_SN_BUFFERS}")
            if c["ada_norm"] != want or c["ada_norm_bwd"] != want:
                fail(f"ugatit step {i}: K14/K15 launches {c}, want {want}")
            dw = len(ugatit_dw_launches()["conv_reflect_dw"])
            if c["conv_reflect_dw"] != dw or c["dw_ring"] != dw or c[
                    "dw_simt"]:
                fail(f"ugatit step {i}: K9-dW launches {c}, want {dw} on "
                     f"the tap-ring design")
        if not counts[2]["replayed"]:
            fail("ugatit: the third step did not replay its graph")
        if not all(math.isfinite(v) for ls in losses for v in ls.values()):
            fail(f"ugatit: losses {losses}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 5
        for _ in range(n):
            trainer.train_step_fn(trainer.state, *trainer._put(a, b))
        torch.cuda.synchronize()
        img_s = n * BATCH / (time.perf_counter() - t0)
        metrics = {"params": params, "img_s": img_s,
                   "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
                   "peak_allocated_gb":
                       torch.cuda.max_memory_allocated() / 1e9,
                   "steps": counts, "kernel_rows": rows,
                   "max_err": {f"{k}.{d}": v for (k, d), v in errs.items()}}
        print(f"ugatit: {params} parameters, {img_s:.2f} img/s, peak "
              f"reserved {metrics['peak_reserved_gb']:.2f} GB", flush=True)
        del trainer
    gc.collect()
    torch.cuda.empty_cache()
    if out_dir is not None:
        (out_dir / "ugatit.json").write_text(json.dumps(metrics, indent=1))
    return errs, rows, launched, metrics


def _uniform_pair(batch, size, seed=0):
    g = np.random.default_rng(seed)
    return (g.integers(0, 256, (batch, size, size, 3), dtype=np.uint8),
            g.integers(0, 256, (batch, size, size, 3), dtype=np.uint8))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=None,
                        help="directory for per-launch details and the "
                             "profiler traces")
    args = parser.parse_args(argv)
    out_dir = args.out
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
    # phase 24: the default recipe with batch norm
    bn_cfg = batchnorm_config()
    plans["unet_bn_train"] = batchnorm_launches(train_launches(bn_cfg, BATCH,
                                                               SIZE))
    # phases 26-27: a mesh of one over NCCL (the default step's launches),
    # each of RANKS data ranks at its batch, each of RANKS H strips
    plans["dp_nccl1_train"] = train_launches(cfgs["unet"], BATCH, SIZE)
    plans["dp_train"] = train_launches(cfgs["unet"], BATCH // RANKS, SIZE)
    plans["spatial_train"] = spatial_launches(
        train_launches(cfgs["unet"], BATCH, SIZE), RANKS)
    serve_plans["spatial_serve_512"] = spatial_launches(serve_launches(
        cfgs["unet"].generator, SPATIAL_SERVE_BATCH, SPATIAL_SERVE_SIZE),
        RANKS)
    # phase 26 (c): the ResNet recipe on RANKS data ranks at its batch;
    # phase 27 (c): one request to the spatial HTTP server, batch 1;
    # phase 28: the imported converged256 served as phase 4, and one f32
    # step resumed from it at GRAD_BATCH
    plans["resnet_dp_train"] = resnet_train_launches(cfgs["resnet"],
                                                     BATCH // RANKS, SIZE)
    # phase 29: U-GAT-IT's K9-dW launches (its other kernels' shapes are
    # timed in the phase itself)
    plans[UGATIT_PATH] = ugatit_dw_launches()
    serve_plans["spatial_http_512"] = spatial_launches(serve_launches(
        cfgs["unet"].generator, 1, SPATIAL_SERVE_SIZE), RANKS)
    serve_plans["import_serve"] = serve_plans["unet_serve"]
    import_train_plan = train_launches(cfgs["unet"], GRAD_BATCH, SIZE)
    serve_plans["unet_bn_serve"] = batchnorm_launches(
        serve_launches(bn_cfg["generator"], BATCH, SIZE))
    # the ranks' bf16 steps launch no CUDA-core design, and their f32
    # steps' are phase 2's f32 K1 and K5 at the same shapes
    paths = {path: unique_shapes(plan) if path in RANK_PATHS
             else with_simt(unique_shapes(plan))
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
        layout_launches, metrics["serving_layouts"] = serving_layouts(
            cfgs["unet"], out_dir)
        launches.update(layout_launches)
        stamp("phase 20 (serving layouts)")
        (records, launches["unet_export_512"],
         serve_plans["unet_export_512"], forwards["unet_export_512"],
         metrics["export_512"]) = export_512(cfgs["unet"], Path(tmp),
                                             out_dir)
        with no_tf32():
            shapes = unique_shapes(serve_plans["unet_export_512"])
            for key, err in check_kernels(shapes, "512 ").items():
                max_err[key] = max(max_err.get(key, 0.0), err)
            rows += time_kernels({"unet_export_512": shapes})
        stamp("phase 21 (512x512 export)")
        http_launches, metrics["http"] = http_server(cfgs["unet"])
        launches.update(http_launches)
        stamp("phase 22 (HTTP server)")
        eval_launches, metrics["evaluation"] = evaluation(cfgs["unet"],
                                                          records)
        launches.update(eval_launches)
        stamp("phase 23 (evaluation)")
        bn_launches, forwards["unet_bn_serve"], metrics["unet_bn"] = \
            batchnorm(bn_cfg, plans["unet_bn_train"],
                      serve_plans["unet_bn_serve"], Path(tmp), out_dir)
        launches.update(bn_launches)
        stamp("phase 24 (batch norm)")
        data_launches, metrics["data_layer"] = data_layer(Path(tmp))
        launches.update(data_launches)
        stamp("phase 25 (data layer)")
        nccl_note = nccl_two_ranks()
        launches["dp_nccl1_train"], metrics["dp_nccl1"] = world1_nccl(
            cfgs["unet"], plans["dp_nccl1_train"], Path(tmp))
        launches["dp_train"], metrics["data_parallel"] = data_parallel(
            cfgs["unet"], plans["dp_train"])
        metrics["data_parallel"]["nccl_two_ranks_one_card"] = nccl_note
        launches["resnet_dp_train"], metrics["resnet_data_parallel"] = \
            resnet_data_parallel(cfgs["resnet"], plans["resnet_dp_train"])
        stamp("phase 26 (data parallel)")
        with no_tf32():
            for path in ("spatial_serve_512", "spatial_http_512"):
                shapes = unique_shapes(serve_plans[path])
                for key, err in check_kernels(shapes,
                                              "spatial 512 ").items():
                    max_err[key] = max(max_err.get(key, 0.0), err)
                rows += time_kernels({path: shapes})
        (launches["spatial_train"], launches["spatial_serve_512"],
         forwards["spatial_serve_512"], metrics["spatial"]) = spatial(
            cfgs["unet"], plans["spatial_train"],
            serve_plans["spatial_serve_512"])
        (launches["spatial_http_512"], launches["spatial_paired"],
         metrics["spatial_server_paired"]) = spatial_server_paired(
            cfgs["unet"], serve_plans["spatial_http_512"])
        forwards["spatial_http_512"] = 1
        stamp("phase 27 (spatial)")
        with no_tf32():
            shapes = with_simt(unique_shapes(import_train_plan))
            for key, err in check_kernels(shapes, "import ").items():
                max_err[key] = max(max_err.get(key, 0.0), err)
        import_launches, metrics["import_reference"] = import_reference(
            cfgs["unet"], serve_plans["import_serve"], import_train_plan,
            Path(tmp))
        launches.update(import_launches)
        forwards["import_serve"] = 1
        stamp("phase 28 (reference import)")
        (ugatit_errs, ugatit_rows, launches[UGATIT_PATH],
         metrics["ugatit"]) = ugatit(out_dir)
        max_err.update(ugatit_errs)
        rows += ugatit_rows
        stamp("phase 29 (U-GAT-IT)")

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
