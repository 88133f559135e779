"""The CycleGan training runtime (cyclegan_tpu/trainer.py ``CycleGan``).

The epoch loop around one train step (``steps.make_train_step``): per-batch
metrics fetched every ``display_every`` batches in one transfer, validation
each epoch, TensorBoard summaries with the JAX package's tags, fixed sample
images and their translations, a checkpoint every ``summary.model`` epochs
and at the end, and full resume: parameters, every optimizer's state, the
step, the augmentation and dropout generators, the sample images and the
epoch count (``current_epoch``, written at every periodic save). The
checkpoint is the JAX trainer's, so either package resumes the other's
(``utils/checkpoint.py``).

Train config options, as in the JAX trainer: ``compute_dtype`` (float32 or
bfloat16), ``display_every`` (0 = at epoch end), ``nan_check``,
``pallas_norm`` (K13 for the NHWC layout's instance norms), ``tpu_layout``:
true runs the NHCW layout through the kernels K1-K12, false the NHWC layout
through the library convolutions; "auto" (the default) is NHCW on a CUDA
device with bf16 and NHWC otherwise, where the JAX package reads "a TPU"
for "a CUDA device"; ``remat`` and ``fuse_apps`` (the steps' options);
``steps_per_call`` K > 1, which runs the epoch's batches in chunks of K
through ``steps.make_train_multi_step`` (a ragged tail as single steps,
metrics drained per chunk); ``profile_dir`` (with ``profile_steps``, 5 by
default), a ``torch.profiler`` Chrome trace of the first epoch's first
``profile_steps`` train batches, ``<profile_dir>/train_trace.json``, closed
early if the epoch is shorter. ``device`` defaults to ``cuda`` and raises
without a card. The datasets come from the caller (``train.py`` picks the
loader, ``data_loader: memory`` or ``streaming``).

Parallelism (JAX ``trainer.py:62-150, 270-290``): with a ``parallel.Mesh``
every process runs this loop on its own device. ``batch_size`` is what each
process is fed, its data rank's slice of the global batch (the datasets
take ``process_index`` = data rank and ``process_count`` = data size; the
spatial ranks of one data rank load the same images), as in the JAX
trainer on a multi-host pod. Under a spatial axis each process keeps its H
strip of the batch. The steps average over the mesh (``steps.py``);
``dp_shard_map`` picks JAX's explicit per-shard path (per-shard batch-norm
statistics and random streams). Only the lead (rank 0) writes
checkpoints, summaries, sample images and the profile trace, and the other
ranks create no folder; a resume loads the same checkpoint on every rank.
A spatial mesh refuses, at config load, conv-transposes the halo algebra
cannot take (k5, k6), and ``tpu_layout: true`` without ``dp_shard_map``.
"""

from __future__ import annotations

import logging
import time
from os.path import join
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from cyclegan_tpu_torch import tracing
from cyclegan_tpu_torch.config import Namespace, namespace2yaml
from cyclegan_tpu_torch.data.augment import (
    denormalize_to_unit,
    normalize,
    prepare_eval_batch,
    random_jitter_batch,
)
from cyclegan_tpu_torch.data.pipeline import ArrayDataset
from cyclegan_tpu_torch.models import generated_image
from cyclegan_tpu_torch.ops import cuda_norm, layout
from cyclegan_tpu_torch.parallel import replicate, shard_batch
from cyclegan_tpu_torch.parallel.spatial import check_spatial_divisibility
from cyclegan_tpu_torch.steps import (
    build_models,
    init_train_state,
    make_train_multi_step,
    make_train_step,
    make_validate_step,
)
from cyclegan_tpu_torch.utils.checkpoint import (
    load_train_state,
    save_train_state,
)
from cyclegan_tpu_torch.utils.metrics import make_metric_dict
from cyclegan_tpu_torch.utils.summary import SummaryWriter

try:  # pragma: no cover - import guard
    import tqdm
except Exception:  # pragma: no cover
    tqdm = None

logger = logging.getLogger(__name__)

METRIC_NAMES = ["dA_loss", "dB_loss", "gAB_loss", "gBA_loss", "dA_acc",
                "dB_acc"]
CHECKPOINT_FILE = "checkpoint.npz"
PROFILE_FILE = "train_trace.json"


class _Progress:
    """What the loop needs of a tqdm bar, where tqdm is not installed."""

    def __init__(self, iterable, desc: str, total: int):
        self.iterable, self.desc = iterable, desc

    def __iter__(self):
        return iter(self.iterable)

    def set_postfix(self, **values) -> None:
        self.postfix = values

    def refresh(self) -> None:
        pass


def _progress(iterable, desc: str, total: int):
    if tqdm is None:
        return _Progress(iterable, desc, total)
    return tqdm.tqdm(iterable, desc=desc, ncols=0, total=total)


class CycleGan:
    """Owns the four networks, their optimizers, the steps and the
    training loop."""

    def __init__(self, model_config: Namespace, train_config: Namespace,
                 mesh=None, device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CycleGan: no CUDA device; pass device='cpu' "
                               "to train on the CPU")
        self.model_config = model_config
        self.train_config = train_config
        self.mesh = mesh
        self.spatial_axis = ("spatial" if mesh is not None
                             and mesh.axis_size("spatial") > 1 else None)
        if self.spatial_axis is not None:
            from cyclegan_tpu_torch.models import (
                spatial_unsupported_transposes,
            )

            bad = spatial_unsupported_transposes(model_config)
            if bad:
                raise ValueError(
                    "spatial (H-sharded) training does not support these "
                    "conv-transpose kernels (halo algebra needs "
                    "pad_before' % stride == 0; k3/k4/k7/k8 work at "
                    "stride 2): "
                    + ", ".join(f"{net} k{k}" for net, k in bad)
                    + ". Change the offending 'kernels:' entries (e.g. "
                    "5 -> 4), use expansion: upsample, or drop "
                    "--spatial_devices.")
        self.dp_shard_map = bool(train_config.get("dp_shard_map", False))

        self.compute_dtype = str(train_config.get("compute_dtype", "float32"))
        self.display_every = int(train_config.get("display_every", 1))
        self.nan_check = bool(train_config.get("nan_check", True))
        self.pallas_norm = bool(train_config.get("pallas_norm", False))
        self.remat = bool(train_config.get("remat", False))
        self.fuse_apps = bool(train_config.get("fuse_apps", False))
        self.steps_per_call = int(train_config.get("steps_per_call", 1))
        self.profile_dir = train_config.get("profile_dir")
        self.profile_steps = int(train_config.get("profile_steps", 5))
        tpu_layout = train_config.get("tpu_layout", "auto")
        if isinstance(tpu_layout, str) and tpu_layout.lower() == "auto":
            tpu_layout = (self.device.type == "cuda"
                          and self.compute_dtype == "bfloat16"
                          and (self.spatial_axis is None
                               or self.dp_shard_map))
        if (self.spatial_axis is not None and tpu_layout
                and not self.dp_shard_map):
            raise ValueError(
                "tpu_layout: true cannot combine with a spatial mesh "
                "without dp_shard_map (the JAX package's partitioner "
                "cannot split its kernels); set dp_shard_map: true to run "
                "the kernels on H-sharded strips, or leave tpu_layout at "
                "auto/false")
        self.tpu_layout = bool(tpu_layout)

        self.model_folder = join(model_config.location, model_config.name)
        # one writer per artifact: the lead process
        self.is_lead = mesh is None or mesh.rank == 0
        self.train_summaries = SummaryWriter(join(self.model_folder, "train"),
                                             enabled=self.is_lead)
        self.val_summaries = SummaryWriter(join(self.model_folder,
                                                "validation"),
                                           enabled=self.is_lead)

        seed = int(model_config.get("seed", 0))
        self.state = init_train_state(build_models(model_config, seed),
                                      train_config, seed, self.device)
        if mesh is not None:
            replicate(mesh, self.state)
        # The JAX TrainState's key: unused here, carried through checkpoints
        # (jax.random.PRNGKey(seed) until a JAX checkpoint replaces it).
        self.rng = np.array([0, seed], np.uint32)
        image_size = int(train_config.image_size)

        def train_preprocess(generator, a, b, rows=None):
            return (random_jitter_batch(generator, a, image_size, rows),
                    random_jitter_batch(generator, b, image_size, rows))

        loss, weights = model_config.loss, dict(model_config.loss_weights)
        options = dict(tpu_layout=self.tpu_layout,
                       pallas_norm=self.pallas_norm, fuse_apps=self.fuse_apps,
                       mesh=mesh, spatial_axis=self.spatial_axis,
                       shard_map_dp=self.dp_shard_map and mesh is not None)
        self.train_step_fn = make_train_step(
            loss, weights, self.compute_dtype, train_preprocess,
            remat=self.remat, **options)
        self.multi_step_fn = None
        if self.steps_per_call > 1:
            self.multi_step_fn = make_train_multi_step(
                loss, weights, self.compute_dtype, train_preprocess,
                remat=self.remat, **options)
        self.validate_step_fn = make_validate_step(
            loss, weights, self.compute_dtype, prepare_eval_batch, **options)

        self.a_samples: Optional[np.ndarray] = None
        self.b_samples: Optional[np.ndarray] = None
        # per epoch: its metrics, steps and seconds (the summaries hold the
        # same metrics)
        self.history: List[Dict[str, Any]] = []

        # new: true trains from scratch; otherwise resume
        if self.model_config.new:
            self.model_config.new = False
        else:
            self.load_model()

    # ------------------------------------------------------------------
    # training loop
    # ------------------------------------------------------------------

    def train(self, train_dataset: ArrayDataset,
              validation_dataset: ArrayDataset) -> None:
        batch_size = int(self.train_config.batch_size)
        epochs = int(self.train_config.epochs)
        summary = self.train_config.summary
        save_images_every = int(summary["images"])
        tensorboard_samples = int(summary["samples"])
        save_model_every = int(summary["model"])
        if self.spatial_axis is not None:
            check_spatial_divisibility(int(self.train_config.image_size),
                                       self.mesh, self.spatial_axis)

        train_metrics = make_metric_dict(METRIC_NAMES)
        val_metrics = make_metric_dict(METRIC_NAMES)

        # fixed sample images, captured once and kept across resumes
        if self.a_samples is None or self.b_samples is None:
            a_raw, b_raw = validation_dataset.take_pairs(tensorboard_samples)
            self.a_samples = normalize(torch.from_numpy(a_raw)).numpy()
            self.b_samples = normalize(torch.from_numpy(b_raw)).numpy()
            self.val_summaries.images("A", denormalize_to_unit(
                self.a_samples), step=0, max_outputs=tensorboard_samples)
            self.val_summaries.images("B", denormalize_to_unit(
                self.b_samples), step=0, max_outputs=tensorboard_samples)

        current_epoch = int(self.model_config.get("current_epoch", 0))
        for e in range(current_epoch, current_epoch + epochs):
            record = {"epoch": e}
            start = time.perf_counter()
            record["train_steps"] = self._run_train_epoch(
                train_dataset.batches(batch_size, e),
                f"Epoch {e + 1} training",
                train_dataset.num_batches(batch_size), train_metrics,
                profile=bool(self.profile_dir) and e == current_epoch)
            record["train_seconds"] = time.perf_counter() - start
            record["train"] = self._write_summaries(self.train_summaries, e,
                                                    train_metrics)
            if e % save_images_every == 0 and self.is_lead:
                self.write_images(e, self.a_samples, self.b_samples,
                                  tensorboard_samples)

            start = time.perf_counter()
            record["validation_steps"] = self._run_epoch(
                self.validate_step_fn, validation_dataset.batches(
                    batch_size, e), f"Epoch {e + 1} validation",
                validation_dataset.num_batches(batch_size), val_metrics)
            record["validation_seconds"] = time.perf_counter() - start
            record["validation"] = self._write_summaries(self.val_summaries,
                                                         e, val_metrics)
            self.history.append(record)
            logger.info("epoch %d: %s", e + 1, record)

            if e % save_model_every == 0:
                # record the epoch with every periodic save, so a crash
                # resumes from the right epoch
                self.model_config.current_epoch = e + 1
                self.save_model()

        self.model_config.current_epoch = current_epoch + epochs
        self.save_model()

    def _run_train_epoch(self, batches, desc: str, total: int, metrics_dict,
                         profile: bool) -> int:
        """One epoch of train steps: single steps, or chunks of
        ``steps_per_call`` batches through the multi step with a ragged
        tail of single steps; with ``profile`` the first ``profile_steps``
        batches are traced. Metrics are fetched every ``display_every``
        batches (a chunk's once it has run) and at the end."""
        bar = _progress(batches, desc, total)
        profiler = self._start_profile() if profile and self.is_lead \
            else None
        pending, chunk = [], []
        steps = 0
        for images_a, images_b in bar:
            if self.multi_step_fn is not None:
                chunk.append((images_a, images_b))
                if len(chunk) == self.steps_per_call:
                    pending.append(self._run_chunk(chunk))
                    chunk = []
            else:
                pending.append(self.train_step_fn(
                    self.state, *self._put(images_a, images_b)))
            steps += 1
            if profiler is not None and steps >= self.profile_steps \
                    and not chunk:
                self._stop_profile(profiler)
                profiler = None
            if self.display_every and steps % self.display_every == 0:
                self._drain_metrics(metrics_dict, pending)
                self._display_metrics(metrics_dict, bar)
        for images_a, images_b in chunk:  # the ragged tail
            pending.append(self.train_step_fn(
                self.state, *self._put(images_a, images_b)))
        if profiler is not None:  # the epoch was shorter than the trace
            self._stop_profile(profiler)
        self._drain_metrics(metrics_dict, pending)
        self._display_metrics(metrics_dict, bar)
        return steps

    def _run_chunk(self, chunk) -> Dict[str, torch.Tensor]:
        """K batch pairs stacked to (K, B, H, W, C) through the multi
        step; its metrics carry K values each."""
        stack_a = np.stack([a for a, _ in chunk])
        stack_b = np.stack([b for _, b in chunk])
        return self.multi_step_fn(self.state, *self._put(stack_a, stack_b))

    def _start_profile(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profile(self, profiler) -> None:
        """Wait for the traced steps, stop and write the Chrome trace."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        folder = Path(self.profile_dir)
        folder.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(folder / PROFILE_FILE))

    def _run_epoch(self, step_fn, batches, desc: str, total: int,
                   metrics_dict) -> int:
        """Run ``step_fn`` over one epoch's batches; the metrics of the
        steps are fetched every ``display_every`` steps and at the end."""
        bar = _progress(batches, desc, total)
        pending = []
        steps = 0
        for images_a, images_b in bar:
            images_a, images_b = self._put(images_a, images_b)
            pending.append(step_fn(self.state, images_a, images_b))
            steps += 1
            if self.display_every and steps % self.display_every == 0:
                self._drain_metrics(metrics_dict, pending)
                self._display_metrics(metrics_dict, bar)
        self._drain_metrics(metrics_dict, pending)
        self._display_metrics(metrics_dict, bar)
        return steps

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------

    def predict(self, images: np.ndarray, direction: str = "a2b"
                ) -> np.ndarray:
        """A generator's forward on ``images`` ([-1, 1] floats or uint8,
        NHWC) in f32, in the trainer's layout, batch norms on their moving
        statistics; output [-1, 1] float32."""
        model = self.state.models[{"a2b": "g_AB", "b2a": "g_BA"}[direction]]
        x = torch.as_tensor(np.asarray(images)).to(self.device)
        x = prepare_eval_batch(x).to(torch.float32)
        was_training = model.training
        model.eval()
        scope = layout.nhcw() if self.tpu_layout else layout.nhwc()
        try:
            with torch.no_grad(), scope, cuda_norm.scope(self.pallas_norm):
                if self.tpu_layout:
                    y = layout.from_nhcw(generated_image(
                        model(layout.to_nhcw(x))))
                else:
                    y = generated_image(model(x))
        finally:
            model.train(was_training)
        return y.float().cpu().numpy()

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    @staticmethod
    def _write_summaries(summaries: SummaryWriter, epoch: int,
                         metrics_dict) -> Dict[str, float]:
        """Write and reset the epoch's metrics; returns their values."""
        values = {}
        for name, metric in metrics_dict.items():
            values[name] = metric.result()
            summaries.scalar(name, values[name], step=epoch)
            metric.reset_states()
        summaries.flush()
        return values

    def write_images(self, epoch: int, a_samples, b_samples,
                     num_samples: int) -> None:
        for tag, samples, direction in (("A2B_predictions", a_samples, "a2b"),
                                        ("B2A_predictions", b_samples, "b2a")):
            prediction = self.predict(samples, direction)
            self.val_summaries.images(tag, denormalize_to_unit(prediction),
                                      step=epoch, max_outputs=num_samples)

    def _drain_metrics(self, metrics_dict, pending) -> None:
        """Fetch the pending steps' metrics in one transfer and fold them
        into the epoch's means."""
        if not pending:
            return
        names = list(metrics_dict)
        # one row per step: a multi step's metrics carry one value a step
        values = torch.cat([torch.stack([m[name].float().reshape(-1)
                                         for name in names], dim=1)
                            for m in pending]).cpu().numpy()
        for row in values.astype(np.float64):
            for name, value in zip(names, row):
                if self.nan_check and not np.isfinite(value):
                    raise FloatingPointError(
                        f"metric {name} went non-finite ({value}) at step "
                        f"{self.state.step}: training diverged")
                metrics_dict[name].update_state(float(value))
        pending.clear()

    @staticmethod
    def _display_metrics(metrics_dict, progress_bar) -> None:
        evaluated = {k: str(v.result())[:7] for k, v in metrics_dict.items()}
        progress_bar.set_postfix(**evaluated)
        progress_bar.refresh()

    def _put(self, images_a: np.ndarray, images_b: np.ndarray):
        """A fed batch pair on the device; under a spatial axis this
        rank's H strip of it ((K, B, H, ...) chunks: of dim 2). Span
        ``put``; each copy from pageable host memory to the card waits for
        the stream, counted as a ``sync``."""
        with tracing.span("put"):
            out = (torch.from_numpy(images_a).to(self.device),
                   torch.from_numpy(images_b).to(self.device))
            if self.device.type == "cuda":
                tracing.count("sync", 2)
            if self.spatial_axis is None:
                return out
            return shard_batch(self.mesh, out, axis_name=None,
                               batch_dim=out[0].dim() - 4,
                               spatial_axis=self.spatial_axis)

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def save_model(self) -> None:
        """The full train state, the fixed sample images and both configs
        into the model folder, by the lead process alone."""
        if not self.is_lead:
            return
        folder = Path(self.model_folder)
        folder.mkdir(parents=True, exist_ok=True)
        save_train_state(folder / CHECKPOINT_FILE, self.state, self.rng)
        if self.a_samples is not None:
            np.save(folder / "a_samples.npy", self.a_samples)
            np.save(folder / "b_samples.npy", self.b_samples)
        namespace2yaml(folder / "model_config.yaml", self.model_config)
        namespace2yaml(folder / "train_config.yaml", self.train_config)

    def load_model(self) -> None:
        """Restore the train state and the sample images."""
        folder = Path(self.model_folder)
        self.rng = load_train_state(folder / CHECKPOINT_FILE, self.state)
        a_path = folder / "a_samples.npy"
        if a_path.exists():
            self.a_samples = np.load(a_path)
            self.b_samples = np.load(folder / "b_samples.npy")
