"""The Trainer: training, evaluation, early stopping and best-k
checkpointing, on one card or over a process group.

Counterpart of ``imageretrievalresearch_tpu/train/trainer.py``, which
replaces the reference's ``pl.Trainer(precision=16, strategy='ddp',
devices=3, callbacks=[ModelCheckpoint, EarlyStopping,
LearningRateMonitor])`` (train/train.py:428-454):

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
``label``).

Multi-device training is data-parallel over a ``torch.distributed``
process group, one process per device (``parallel.distributed``), and
the trainer takes one of three places:

- a rank of a group (one is running when the trainer is built: the
  multi-host flags of the CLIs, or a worker of a launch): the model is
  wrapped in ``DistributedDataParallel`` (replicated state) or sharded by
  FSDP2 (``param_sharding='fsdp'``), each rank takes its rows of every
  batch (``parallel.mesh.shard_batch``), and BatchNorm's statistics, the
  losses' mean and the metrics cover the global batch, as JAX's do over a
  sharded batch. Only rank 0 writes logs, ``hparams.yaml`` and
  checkpoints;
- no group and one device (``num_devices`` 1, or None with one card
  visible, or the CPU): the model trains in this process, as it is;
- no group and more devices (``num_devices`` > 1, or None with several
  cards visible; or FSDP): :meth:`Trainer.fit` launches one fresh worker
  process per card (``distributed.launch``), each a rank as above, and
  loads rank 0's result. The loaders, custom transforms, metric
  transforms and logger go to the workers by pickle, so they must be
  importable by module (not defined in ``__main__``).

The random draws (AutoAugment's, dropout's) are the global batch's, each
rank keeping its rows', so an R-rank step is the 1-rank step on the same
global batch.
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
from imageretrievalresearch_tpu_torch.parallel import distributed
from imageretrievalresearch_tpu_torch.parallel.fsdp import (
    constrain_fsdp,
    put_fsdp,
)
from imageretrievalresearch_tpu_torch.parallel.mesh import (
    make_mesh,
    put_replicated,
    shard_batch,
)
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
from imageretrievalresearch_tpu_torch.utils import profiling
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


def _ranks(cfg: TrainConfig, device: torch.device) -> int:
    """The devices to train on outside a process group: ``num_devices``,
    or (None) every visible card (one for an explicit ``cuda:i`` or the
    CPU)."""
    n = cfg.num_devices
    if device.type == "cuda":
        visible = torch.cuda.device_count()
        if n is None:
            n = 1 if device.index is not None else visible
        if n > visible:
            raise ValueError(f"num_devices={n}, but {visible} CUDA devices "
                             "are visible")
    n = 1 if n is None else n
    if n < 1:
        raise ValueError(f"num_devices must be >= 1, got {n}")
    return n


def _generator_seeds(seed: int) -> tuple[int, int]:
    """Two independent seeds (the transform's, dropout's) from one."""
    a, b = np.random.SeedSequence(seed).spawn(2)
    return int(a.generate_state(1)[0]), int(b.generate_state(1)[0])


class Trainer:
    def __init__(self, cfg: TrainConfig, backbone: torch.nn.Module,
                 train_loader, val_loader=None,
                 logger: MetricLogger | None = None, mesh=None,
                 transform=None, eval_transform=None,
                 metric_transforms: dict | None = None):
        """``cfg.device`` ("cuda" by default) is where the model, the
        transforms and the steps run; a CUDA device without a card
        raises. Inside a process group the trainer is one of its ranks
        (``mesh``: the group's, ``make_mesh()`` by default) and runs on
        the rank's device. ``transform`` / ``eval_transform``: custom
        batch transforms ``(raw batch, generator) -> float batch``, called
        with ``rows=(first, total)`` too where the batch is one rank's
        part (see ``ops.preprocess.build_triplet_transform``); a custom
        ``transform`` is reused for evaluation unless ``eval_transform``
        is given (which is called with ``generator=None``).
        ``metric_transforms`` map a validation metric's per-batch values
        before the epoch mean."""
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the trainer runs on the GPU "
                               'by default; pass TrainConfig(device="cpu") '
                               "to run on the CPU")
        if cfg.param_sharding not in ("replicated", "fsdp"):
            raise ValueError(f"param_sharding must be 'replicated' or "
                             f"'fsdp', got {cfg.param_sharding!r}")
        self._fsdp = cfg.param_sharding == "fsdp"
        # outside a group: the ranks fit() launches (0: train here)
        self._launch = 0
        self.mesh = None
        if distributed.in_group():
            self.mesh = mesh if mesh is not None else make_mesh()
            if self.mesh.rank is None:
                raise ValueError("the trainer's mesh is a process group's "
                                 "(make_mesh() inside the group)")
            if tuple(self.mesh.axis_names) != ("data",):
                # as JAX's trainer, which builds 1-D meshes only
                raise ValueError(
                    f"the trainer trains on a one-axis ('data',) mesh, got "
                    f"{self.mesh.axis_names}: a (data, model) mesh is "
                    "driven through put_fsdp(mesh, model, "
                    "axis_name='model'), shard_batch and the steps built "
                    "with mesh=")
            n = self.mesh.shape["data"]
            if cfg.num_devices is not None and cfg.num_devices != n:
                raise ValueError(f"num_devices={cfg.num_devices} in a "
                                 f"process group of {n} ranks")
            if self._fsdp and distributed.process_count() > 1:
                # as JAX's trainer: FSDP runs over the ranks of one launch
                raise NotImplementedError(
                    "param_sharding='fsdp' is single-process "
                    "(single-controller) only; multi-process runs use "
                    "replicated state")
            if self.mesh.local_device.type != self.device.type:
                raise ValueError(f"cfg.device {cfg.device!r} in a group on "
                                 f"{self.mesh.local_device}")
            self.device = self.mesh.local_device
        else:
            if mesh is not None:
                raise ValueError("training runs on a process group's mesh: "
                                 "start the group first "
                                 "(parallel.distributed.init_group)")
            n = _ranks(cfg, self.device)
            if n > 1 or self._fsdp:
                self._launch = n
        self._is_main = distributed.rank() == 0
        self._given = {"logger": logger, "transform": transform,
                       "eval_transform": eval_transform,
                       "metric_transforms": metric_transforms}
        self.metric_transforms = dict(metric_transforms or {})
        self.backbone = backbone.to(self.device)
        self.model = self.backbone
        if self.mesh is not None:
            if self._fsdp:
                self.model = put_fsdp(self.mesh, self.backbone)
            else:
                put_replicated(self.mesh, self.backbone)
                # T4's cos_only loss never reaches the classifier head:
                # DDP must not wait for its gradients
                unused = (cfg.effective_task != "classification"
                          and cfg.loss_mode == "cos_only")
                self.model = torch.nn.parallel.DistributedDataParallel(
                    self.backbone,
                    device_ids=([self.device.index]
                                if self.device.type == "cuda" else None),
                    broadcast_buffers=False,
                    find_unused_parameters=unused)
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
        if cfg.checkpoint_dir and self._is_main:
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
        """The model (the backbone as given, on the device; wrapped or
        sharded for a group) with a fresh optimizer at step 0."""
        opt = make_optimizer(self.cfg.optimizer_name,
                             self.model.parameters(),
                             self.cfg.learning_rate, self.cfg.weight_decay)
        return TrainState(self.model, opt, 0)

    # --- loops ---

    def _prepare(self, batch: dict) -> dict:
        """The label entries of a transformed batch as int64 tensors on
        the device (the images are there already)."""
        return {k: (torch.as_tensor(v, device=self.device).long()
                    if k in _LABELS else v) for k, v in batch.items()}

    def _batch(self, raw: dict, transform, generator,
               sharded: bool = True) -> dict:
        """A raw batch transformed and prepared for a step: in a group
        (and ``sharded``) this rank's rows of it, drawn as the global
        batch's and marked with ``rows``; otherwise the whole batch."""
        if self.mesh is None or not sharded:
            return self._prepare(transform(raw, generator))
        raw = shard_batch(self.mesh, raw)
        rows = self.mesh.rows_of(len(raw["qry"] if "qry" in raw
                                     else raw["image"]))
        return {**self._prepare(transform(raw, generator, rows=rows)),
                "rows": rows}

    def train_batch(self, state: TrainState, raw: dict, generators,
                    step=None) -> tuple[TrainState, dict]:
        """One train step on a raw batch: the transform (its draws from
        ``generators[0]``), then ``step`` (the trainer's by default; its
        dropout draws from ``generators[1]``)."""
        tgen, dgen = generators
        with profiling.span("train.step"):
            with profiling.span("train.transform"):
                batch = self._batch(raw, self.transform, tgen)
            state, metrics = (step or self._train_step)(state, batch, dgen)
            if self._fsdp:
                constrain_fsdp(self.mesh, state.model, state.optimizer)
        return state, metrics

    def _generators(self, epoch: int):
        """(transform, dropout) generators on the device for ``epoch``."""
        return tuple(torch.Generator(device=self.device).manual_seed(s)
                     for s in _generator_seeds(self.cfg.seed + 1000 + epoch))

    def train_epoch(self, state: TrainState, epoch: int
                    ) -> tuple[TrainState, dict]:
        self.train_loader.set_epoch(epoch)
        gens = self._generators(epoch)
        agg: dict[str, list] = {}
        prof = None
        for i, raw in enumerate(self.train_loader):
            if (self.cfg.profile_dir and epoch == 0 and i == 1
                    and self._is_main):
                # trace steps 1-3 of the first epoch (step 0 warms up)
                prof = profiling.start()
            state, metrics = self.train_batch(state, raw, gens)
            if prof is not None and i >= 3:
                self._stop_profile(prof)
                prof = None
            if (i + 1) % self.cfg.log_every_n_steps == 0:
                self.logger.log(metrics, state.step, force=True)
            for k, v in metrics.items():
                agg.setdefault(k, []).append(v)
        if prof is not None:
            self._stop_profile(prof)
        return state, {k: float(np.mean([float(x) for x in v]))
                       for k, v in agg.items()}

    def _stop_profile(self, prof) -> None:
        profiling.stop(prof, os.path.join(self.cfg.profile_dir, "trace.json"),
                       self.device)

    def _eval_sharded(self, n: int) -> bool | None:
        """Whether an eval batch of ``n`` rows (this process's) runs
        sharded over the group; None: skip it. One launch holds the whole
        batch on every rank: a batch the ranks do not divide runs whole on
        each (JAX runs it unsharded on one device). Where each process
        loads its own slice (the multi-host flags) the slices must be
        equal, and this decision, which gates a collective step, is the
        same on every rank: a batch whose slices differ is skipped, with
        JAX's warning."""
        if self.mesh is None:
            return False
        r = self.mesh.shape["data"]
        if distributed.process_count() == 1:
            return n % r == 0
        sizes = distributed.all_gather_rows(
            torch.tensor([n], device=self.device), self.mesh.batch_group)
        if bool((sizes == n).all()):
            return True
        if self._is_main:
            print(f"[trainer] WARNING: multi-process eval skipped a final "
                  f"partial batch of {n} local items (the processes' "
                  f"slices {sizes.tolist()} differ); metrics cover the "
                  "remaining batches only")
        return None

    def _eval_batches(self, state: TrainState, loader
                      ) -> tuple[dict[str, list[float]], list[int]]:
        """Per-batch eval metrics and batch sizes, read once at the end.
        The sizes weight the epoch mean (Lightning's epoch aggregation is
        batch-size-weighted); a partial final batch runs as it is (see
        :meth:`_eval_sharded` in a group)."""
        agg: dict[str, list] = {}
        sizes: list[int] = []
        for raw in loader:
            n = len(raw["qry"] if "qry" in raw else raw["image"])
            sharded = self._eval_sharded(n)
            if sharded is None:
                continue
            metrics = self._eval_step(state, self._batch(
                raw, self.eval_transform, None, sharded))
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
        continues from its step. Outside a group with more than one device
        (or FSDP), the training runs on launched workers (see the module's
        docstring) and the returned state holds rank 0's result on this
        process's device."""
        if self._launch:
            return self._fit_launched(state, max_epochs, resume)
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
                # every rank stops with rank 0
                if (self._monitor in epoch_metrics
                        and distributed.broadcast(
                            stopper.update(epoch_metrics))):
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
        if results_path and self._is_main:
            os.makedirs(os.path.dirname(results_path) or ".", exist_ok=True)
            with open(results_path, "wb") as f:
                pickle.dump(results, f, protocol=pickle.HIGHEST_PROTOCOL)
        return results

    def _fit_launched(self, state: TrainState | None,
                      max_epochs: int | None, resume: bool
                      ) -> tuple[TrainState, dict]:
        """``fit`` on ``self._launch`` fresh worker processes, one per
        device, each a rank of one group; loads rank 0's state."""
        n = self._launch
        devices = ([f"cuda:{i}" for i in range(n)]
                   if self.device.type == "cuda" else ["cpu"] * n)
        payload = {"cfg": dataclasses.replace(self.cfg, num_devices=n),
                   "backbone": self.backbone, **self._given,
                   "train_loader": self.train_loader,
                   "val_loader": self.val_loader,
                   "state": None if state is None else state.state_dict(),
                   "max_epochs": max_epochs, "resume": resume}
        sd, history = distributed.launch(
            "imageretrievalresearch_tpu_torch.train.trainer:_fit_rank", n,
            payload, devices=devices)[0]
        state = self.init_state()
        state.load_state_dict(sd)
        return state, history


def _fit_rank(payload: dict):
    """One rank of :meth:`Trainer.fit`'s launch: the trainer rebuilt in
    the group, fit, and (rank 0) the whole state and the history."""
    p = dict(payload)
    trainer = Trainer(p.pop("cfg"), p.pop("backbone"), p.pop("train_loader"),
                      p.pop("val_loader"), logger=p.pop("logger"),
                      transform=p.pop("transform"),
                      eval_transform=p.pop("eval_transform"),
                      metric_transforms=p.pop("metric_transforms"))
    state = None
    if p["state"] is not None:
        state = trainer.init_state()
        state.load_state_dict(p["state"])
    state, history = trainer.fit(state, max_epochs=p["max_epochs"],
                                 resume=p["resume"])
    sd = state.state_dict()
    return (sd, history) if distributed.rank() == 0 else None
