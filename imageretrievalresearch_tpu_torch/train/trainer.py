"""The Trainer: training, evaluation, early stopping and best-k
checkpointing on one card.

Counterpart of ``imageretrievalresearch_tpu/train/trainer.py``, which
replaces the reference's ``pl.Trainer(precision=16, ..., callbacks=
[ModelCheckpoint, EarlyStopping, LearningRateMonitor])``
(train/train.py:428-454), here on one device:

- bf16 autocast for the forward and the losses (the fp16-AMP equivalent),
  f32 parameters and optimizer state;
- the batch transform (resize, AutoAugment, to float) on the device, its
  draws and dropout's from two generators seeded from
  ``cfg.seed + 1000 + epoch`` (the streams do not follow ``jax.random``);
- best-k checkpointing and early stopping on the monitored metric
  (``cos_sims``, mode max, patience 10 — train/train.py:448-451), resume;
- metric logging with the reference's key names.

A loader is any iterable of raw batch dicts with ``__len__`` and
``set_epoch(epoch)``: uint8 NHWC numpy arrays (``qry``, ``pos``: [..],
``neg``: [..], or ``image``) plus integer ``cat_idx`` / ``prod_idx`` (or
``label``). Multi-device training (``num_devices`` > 1, FSDP) is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle

import numpy as np
import torch

from imageretrievalresearch_tpu_torch._device import resolve_device
from imageretrievalresearch_tpu_torch.config import TrainConfig
from imageretrievalresearch_tpu_torch.ops.preprocess import (
    TransformSpec,
    build_image_transform,
    build_triplet_transform,
)
from imageretrievalresearch_tpu_torch.train.steps import (
    build_classifier_eval_step,
    build_classifier_train_step,
    build_eval_step,
    build_train_step,
)
from imageretrievalresearch_tpu_torch.train.train_state import (
    TrainState,
    make_optimizer,
    multistep_lr,
)
from imageretrievalresearch_tpu_torch.utils.checkpoint import (
    CheckpointManager,
)
from imageretrievalresearch_tpu_torch.utils.logging import MetricLogger

# batch entries that are labels, not images
_LABELS = ("cat_idx", "prod_idx", "label")


class EarlyStopping:
    """Monitor-based early stop (reference train/train.py:451, patience 10)."""

    def __init__(self, monitor: str = "cos_sims", mode: str = "max",
                 patience: int = 10):
        self.monitor, self.mode, self.patience = monitor, mode, patience
        self.best: float | None = None
        self.bad_epochs = 0

    def update(self, metrics: dict) -> bool:
        """Returns True when training should stop."""
        val = float(metrics[self.monitor])
        better = (self.best is None
                  or (val > self.best if self.mode == "max"
                      else val < self.best))
        if better:
            self.best, self.bad_epochs = val, 0
        else:
            self.bad_epochs += 1
        return self.bad_epochs >= self.patience


def _yaml_scalar(v) -> str:
    """One value as PyYAML's safe_dump writes it, in a form its loader
    reads back as the same value (strings double-quoted)."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    return json.dumps(str(v))


def hparams_yaml(cfg: TrainConfig) -> str:
    """The config as flat YAML, keys sorted, sequences as flow lists — what
    the JAX package's ``yaml.safe_dump`` of it loads back as, written
    without PyYAML."""
    lines = []
    for k, v in sorted(dataclasses.asdict(cfg).items()):
        if isinstance(v, (list, tuple)):
            v = "[" + ", ".join(_yaml_scalar(x) for x in v) + "]"
        else:
            v = _yaml_scalar(v)
        lines.append(f"{k}: {v}")
    return "\n".join(lines) + "\n"


def _generator_seeds(seed: int) -> tuple[int, int]:
    """Two independent seeds (the transform's, dropout's) from one."""
    a, b = np.random.SeedSequence(seed).spawn(2)
    return int(a.generate_state(1)[0]), int(b.generate_state(1)[0])


class Trainer:
    def __init__(self, cfg: TrainConfig, backbone: torch.nn.Module,
                 train_loader, val_loader=None,
                 logger: MetricLogger | None = None, transform=None,
                 eval_transform=None, metric_transforms: dict | None = None):
        """``cfg.device`` ("cuda" by default) is where the model, the
        transforms and the steps run; a CUDA device without a card
        raises. ``transform`` / ``eval_transform``: custom batch transforms
        ``(raw batch, generator) -> float batch``; a custom ``transform``
        is reused for evaluation unless ``eval_transform`` is given (which
        is called with ``generator=None``). ``metric_transforms`` map a
        validation metric's per-batch values before the epoch mean."""
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the trainer runs on the GPU "
                               "by default; pass device='cpu' explicitly to "
                               "run on the CPU")
        if cfg.param_sharding not in ("replicated", "fsdp"):
            raise ValueError(f"param_sharding must be 'replicated' or "
                             f"'fsdp', got {cfg.param_sharding!r}")
        if cfg.param_sharding == "fsdp" or (cfg.num_devices or 1) > 1:
            raise NotImplementedError(
                "multi-device training (num_devices > 1, FSDP) is not "
                "ported yet: the trainer runs on one card")
        self.metric_transforms = dict(metric_transforms or {})
        self.backbone = backbone.to(self.device)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.logger = logger or MetricLogger(
            cfg.checkpoint_dir, log_every_n_steps=cfg.log_every_n_steps)
        # without a val loader the monitored validation metric never
        # exists: fall back to the train loss so weights are still saved
        monitor, monitor_mode = cfg.monitor, cfg.monitor_mode
        if val_loader is None and not monitor.startswith("train"):
            monitor, monitor_mode = "train_loss", "min"
        elif (cfg.effective_task == "classification"
              and monitor == "cos_sims"):
            # the classifier's eval emits val_loss/val_top1/val_top3 only;
            # the reference's T5 monitors val_top1, mode max
            monitor, monitor_mode = "val_top1", "max"
            print("[trainer] monitor cos_sims is a triplet metric; "
                  "classification monitors val_top1 (reference T5)")
        self._monitor, self._monitor_mode = monitor, monitor_mode
        self.ckpt = (CheckpointManager(cfg.checkpoint_dir, monitor=monitor,
                                       mode=monitor_mode,
                                       save_top_k=cfg.save_top_k)
                     if cfg.checkpoint_dir else None)
        if cfg.checkpoint_dir:
            # the reference's Lightning save_hyperparameters yaml
            os.makedirs(cfg.checkpoint_dir, exist_ok=True)
            with open(os.path.join(cfg.checkpoint_dir, "hparams.yaml"),
                      "w") as f:
                f.write(hparams_yaml(cfg))

        steps_per_epoch = max(1, len(train_loader))
        self.schedule = multistep_lr(cfg.learning_rate, cfg.milestones,
                                     cfg.lr_gamma, steps_per_epoch)

        classification = cfg.effective_task == "classification"
        if eval_transform is None:
            eval_transform = transform
        if transform is None:
            spec = (TransformSpec.train_autoaugment(cfg.image_size)
                    if cfg.autoaugment
                    else TransformSpec.train_plain(cfg.image_size))
            spec = dataclasses.replace(spec, dtype=cfg.compute_dtype)
            # evaluation is deterministic: the same pipeline minus the
            # random AutoAugment stage
            espec = dataclasses.replace(spec, autoaugment=False)
            build = (build_image_transform if classification
                     else lambda s, device: build_triplet_transform(
                         s, s, s, device=device))
            transform = build(spec, device=self.device)
            if eval_transform is None:
                eval_transform = build(espec, device=self.device)
        self.transform = transform
        self.eval_transform = eval_transform
        if classification:
            self._train_step = build_classifier_train_step(cfg,
                                                           self.schedule)
            self._eval_step = build_classifier_eval_step(cfg)
        else:
            self._train_step = build_train_step(cfg, self.schedule)
            self._eval_step = build_eval_step(cfg)

    # --- state ---

    def init_state(self) -> TrainState:
        """The backbone (as given, on the device) with a fresh optimizer
        at step 0."""
        opt = make_optimizer(self.cfg.optimizer_name,
                             self.backbone.parameters(),
                             self.cfg.learning_rate, self.cfg.weight_decay)
        return TrainState(self.backbone, opt, 0)

    # --- loops ---

    def _prepare(self, batch: dict) -> dict:
        """The label entries of a transformed batch as int64 tensors on
        the device (the images are there already)."""
        return {k: (torch.as_tensor(v, device=self.device).long()
                    if k in _LABELS else v) for k, v in batch.items()}

    def _generators(self, epoch: int):
        """(transform, dropout) generators on the device for ``epoch``."""
        return tuple(torch.Generator(device=self.device).manual_seed(s)
                     for s in _generator_seeds(self.cfg.seed + 1000 + epoch))

    def train_epoch(self, state: TrainState, epoch: int
                    ) -> tuple[TrainState, dict]:
        self.train_loader.set_epoch(epoch)
        tgen, dgen = self._generators(epoch)
        agg: dict[str, list] = {}
        prof = None
        for i, raw in enumerate(self.train_loader):
            if self.cfg.profile_dir and epoch == 0 and i == 1:
                # trace steps 1-3 of the first epoch (step 0 warms up)
                prof = self._start_profile()
            batch = self._prepare(self.transform(raw, tgen))
            state, metrics = self._train_step(state, batch, dgen)
            if prof is not None and i >= 3:
                prof = self._stop_profile(prof)
            if (i + 1) % self.cfg.log_every_n_steps == 0:
                self.logger.log(metrics, state.step, force=True)
            for k, v in metrics.items():
                agg.setdefault(k, []).append(v)
        if prof is not None:
            self._stop_profile(prof)
        return state, {k: float(np.mean([float(x) for x in v]))
                       for k, v in agg.items()}

    def _start_profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.cfg.profile_dir,
                                              "trace.json"))
        return None

    def _eval_batches(self, state: TrainState, loader
                      ) -> tuple[dict[str, list[float]], list[int]]:
        """Per-batch eval metrics and batch sizes, read once at the end.
        The sizes weight the epoch mean (Lightning's epoch aggregation is
        batch-size-weighted); a partial final batch runs as it is."""
        agg: dict[str, list] = {}
        sizes: list[int] = []
        for raw in loader:
            n = len(raw["qry"] if "qry" in raw else raw["image"])
            metrics = self._eval_step(
                state, self._prepare(self.eval_transform(raw, None)))
            sizes.append(int(n))
            for k, v in metrics.items():
                agg.setdefault(k, []).append(v)
        return {k: [float(x) for x in v] for k, v in agg.items()}, sizes

    def eval_epoch(self, state: TrainState, loader=None,
                   transforms: dict | None = None) -> dict:
        """Batch-size-weighted mean over per-batch eval metrics;
        ``transforms`` map each PER-BATCH value before the mean (the
        reference boosts every logged validation-step value,
        train/find_lr.py:87-95,337)."""
        agg, sizes = self._eval_batches(state, loader or self.val_loader)
        out = {}
        for k, v in agg.items():
            f = (transforms or {}).get(k)
            vals = [float(f(x)) for x in v] if f is not None else v
            out[k] = float(np.average(vals, weights=sizes))
        return out

    def _logged_monitor_best(self) -> float | None:
        """Best monitored value replayed from the run's metrics.jsonl (None
        when no log exists yet): seeds EarlyStopping on resume."""
        if not self.cfg.checkpoint_dir:
            return None
        path = os.path.join(self.cfg.checkpoint_dir, "metrics.jsonl")
        if not os.path.exists(path):
            return None
        vals = []
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue          # torn tail line from a preemption
                if self._monitor in rec:
                    vals.append(float(rec[self._monitor]))
        if not vals:
            return None
        return max(vals) if self._monitor_mode == "max" else min(vals)

    def fit(self, state: TrainState | None = None,
            max_epochs: int | None = None, resume: bool = False
            ) -> tuple[TrainState, dict]:
        """Train. ``resume=True`` restores the latest checkpoint and
        continues from its step."""
        cfg = self.cfg
        state = state if state is not None else self.init_state()
        start_epoch = 0
        if resume and self.ckpt and self.ckpt.latest_step() is not None:
            state.load_state_dict(self.ckpt.restore(
                self.ckpt.latest_step(), map_location=self.device))
            start_epoch = state.step // max(1, len(self.train_loader))
            print(f"[trainer] resumed from step {state.step} "
                  f"(epoch {start_epoch})")
        stopper = EarlyStopping(self._monitor, self._monitor_mode,
                                cfg.early_stop_patience)
        if start_epoch:
            # a resumed run keeps its pre-preemption best, or a worse
            # post-resume value would restart the patience window
            stopper.best = self._logged_monitor_best()
        monitor_warned = False
        history: dict[str, list] = {"epochs": []}
        epochs = max_epochs if max_epochs is not None else cfg.max_epochs
        for epoch in range(start_epoch, epochs):
            state, train_metrics = self.train_epoch(state, epoch)
            epoch_metrics = dict(train_metrics)
            if self.val_loader is not None:
                val_metrics = self.eval_epoch(
                    state, transforms=self.metric_transforms)
                if not val_metrics:
                    print("[trainer] WARNING: validation loader yielded no "
                          "batches — no val metrics, no checkpoints this "
                          "epoch")
                epoch_metrics.update(val_metrics)
                self.logger.log(val_metrics, state.step, force=True)
                if (val_metrics and not monitor_warned
                        and self._monitor not in epoch_metrics):
                    monitor_warned = True
                    print(f"[trainer] WARNING: monitor "
                          f"{self._monitor!r} is not among the validation "
                          f"metrics {sorted(val_metrics)} — no checkpoints "
                          "will be saved and early stopping is disabled")
                if self.ckpt and self._monitor in epoch_metrics:
                    self.ckpt.save(state.step, state.state_dict(),
                                   epoch_metrics)
                if (self._monitor in epoch_metrics
                        and stopper.update(epoch_metrics)):
                    history["epochs"].append(epoch_metrics)
                    history["stopped_early"] = epoch
                    break
            elif self.ckpt and self._monitor in epoch_metrics:
                # no validation loader: checkpoint per epoch on the train
                # metric so fit() never ends with no saved weights
                self.ckpt.save(state.step, state.state_dict(), epoch_metrics)
            history["epochs"].append(epoch_metrics)
        return state, history

    def test(self, state: TrainState, test_loader,
             results_path: str | None = None, score_booster=None) -> dict:
        """Evaluate on ``test_loader`` and optionally pickle the results
        (the reference's trainer.test + pickle flow, train/find_lr.py:
        440-457): test_loss / test_top3 / test_top1 (batch-size-weighted),
        the per-batch cos_sims as ``test_scores`` (each through
        ``score_booster`` when given) and their mean."""
        per_batch, sizes = self._eval_batches(state, test_loader)

        def mean(v):
            return float(np.average(v, weights=sizes)) if v else None

        scores = per_batch.get("cos_sims", [])
        if score_booster is not None:
            scores = [float(score_booster(s)) for s in scores]
        results = {
            "test_loss": mean(per_batch.get("val_loss")),
            "test_top3": mean(per_batch.get("val_top3")),
            "test_top1": mean(per_batch.get("val_top1")),
            "test_scores": scores,
            "test_scores_mean": mean(scores),
        }
        if results_path:
            os.makedirs(os.path.dirname(results_path) or ".", exist_ok=True)
            with open(results_path, "wb") as f:
                pickle.dump(results, f, protocol=pickle.HIGHEST_PROTOCOL)
        return results
