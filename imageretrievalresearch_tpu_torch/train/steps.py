"""Train and eval steps: the reference's loss combinations.

Counterpart of ``imageretrievalresearch_tpu/train/steps.py``. A triplet
step takes a float batch ``{'qry': (B,H,W,3), 'pos': [(B,H,W,3)],
'neg': [(B,H,W,3)], 'cat_idx': (B,), 'prod_idx': (B,)}`` on the model's
device and runs the three roles as ONE backbone pass, so BatchNorm sees the
3B rows together (the reference runs three passes). Loss modes
(train/train.py:211-243):

- cos_ce:      cos-embed(pos,+1)+(neg,-1)  +  CE(lbl_qry,cat)+CE(lbl_pos,cat)
- cos_con_ce:  + contrastive(pos,1)+(neg,0)    (T3, margins 0.3/0.3)
- cos_only:    the cosine-embedding pair only   (T4)
- ce_only:     CE(lbl_qry, prod_idx) only       (the reference's CE-only
               branch targets *prod* labels, :239)

``compute_dtype='bfloat16'`` runs the forward and the losses under
``torch.autocast`` in bf16. A train step updates the state in place and
returns it with its metrics (tensors on the device, so a step does not wait
for the card; ``lr`` is a float).

On a rank of a process group the batch is that rank's part of a global
batch, and ``batch['rows'] = (first, total)`` says which: its rows are
``[first, first + B)`` of each role's ``total``. The forward goes through
the model's ``__call__`` (which a ``DistributedDataParallel`` or FSDP
wrapper hooks for the gradient reduction), dropout draws the global
batch's masks and keeps this rank's (``Backbone.features_and_logits``),
and the metrics cover the global batch, as JAX's over a sharded batch: the
in-batch top-k ranks the embeddings and labels gathered from every rank
(no gradient), the row means (losses, the cosine statistics, the
classifier top-k) are averaged over the ranks, whose parts are equal. The
losses themselves stay this rank's row means: DDP averages their
gradients over the ranks. A batch without ``rows`` is whole, and nothing
is gathered. A step built with a ``mesh`` of more axes (a ``(data,
model)`` mesh, where the ranks at one ``data`` index hold the same rows)
runs these collectives and BatchNorm's over ``mesh.batch_group``, the
ranks that hold distinct rows; with a one-axis mesh or none, over the
whole group.
"""

from __future__ import annotations

from typing import Callable

import torch

from imageretrievalresearch_tpu_torch import losses as L
from imageretrievalresearch_tpu_torch import metrics as M
from imageretrievalresearch_tpu_torch.config import TrainConfig
from imageretrievalresearch_tpu_torch.parallel.distributed import (
    all_gather_rows,
    mean_over_group,
)
from imageretrievalresearch_tpu_torch.train.train_state import TrainState
from imageretrievalresearch_tpu_torch.utils.profiling import span

_COMPUTE_DTYPES = ("float32", "bfloat16")


def _autocast(cfg: TrainConfig, device: torch.device):
    if cfg.compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {_COMPUTE_DTYPES}, "
                         f"got {cfg.compute_dtype!r}")
    return torch.autocast(device.type, dtype=torch.bfloat16,
                          enabled=cfg.compute_dtype == "bfloat16")


def _group(mesh):
    """The process group of the batch-wide collectives (None: the whole
    group)."""
    return None if mesh is None else mesh.batch_group


def _features_and_logits(model, x: torch.Tensor, batch: dict, train: bool,
                         generator: torch.Generator | None, roles: int,
                         group=None):
    """One pass of ``x`` (``roles`` roles of the batch's rows, stacked)
    through the model's ``__call__``; dropout draws for the global rows
    where the batch is one rank's part, BatchNorm's statistics cover
    ``group``'s rows."""
    rows = None
    if "rows" in batch:
        first, total = batch["rows"]
        b = x.shape[0] // roles
        local = torch.arange(first, first + b, device=x.device)
        rows = (roles * total, torch.cat([local + r * total
                                          for r in range(roles)]))
    model.train(train)
    kw = {} if group is None else {"group": group}
    return model(x, features_and_logits=True, train=train,
                 generator=generator, rows=rows, **kw)


def _forward_triplet(model, batch: dict, train: bool,
                     generator: torch.Generator | None, group=None):
    """(fm_q, fm_p, fm_n), (lb_q, lb_p, lb_n) from one pass over the
    concatenated roles."""
    qry = batch["qry"]
    b = qry.shape[0]
    x = torch.cat([qry, batch["pos"][0], batch["neg"][0]], dim=0)
    emb, logits = _features_and_logits(model, x, batch, train, generator, 3,
                                       group)
    return emb.split(b), logits.split(b)


def _inbatch_topk(fms, batch: dict, group=None) -> dict:
    """The in-batch top-k over the global batch: gathered over ``group``
    where the batch is one rank's part."""
    fm_q, fm_p, classes = fms[0], fms[1], batch["cat_idx"]
    if "rows" in batch:
        fm_q, fm_p, classes = (all_gather_rows(t, group) for t in
                               (fm_q.detach(), fm_p.detach(), classes))
    return M.inbatch_topk(fm_q, fm_p, classes, k=3)


def _global_means(batch: dict, values: dict, group=None) -> dict:
    """Row means over the global batch: averaged over ``group``'s ranks
    where the batch is one rank's part."""
    return mean_over_group(values, group) if "rows" in batch else values


def _losses_for_mode(cfg: TrainConfig, fms, lbls, batch: dict) -> dict:
    fm_q, fm_p, fm_n = fms
    lb_q, lb_p, _ = lbls
    clss, regs = batch["cat_idx"], batch["prod_idx"]
    mode = cfg.loss_mode
    out: dict[str, torch.Tensor] = {}
    if mode in ("cos_ce", "cos_con_ce", "cos_only"):
        out.update(L.triplet_losses(fm_q, fm_p, fm_n,
                                    cos_margin=cfg.cos_margin))
        total = out["loss_cos"]
    if mode == "cos_con_ce":
        out.update(L.contrastive_pair_losses(fm_q, fm_p, fm_n,
                                             margin=cfg.con_margin))
        total = total + out["loss_con"]
    if mode in ("cos_ce", "cos_con_ce"):
        out["loss_ce_ims"] = L.cross_entropy_loss(lb_q, clss)
        out["loss_ce_poss"] = L.cross_entropy_loss(lb_p, clss)
        out["loss_ce"] = out["loss_ce_ims"] + out["loss_ce_poss"]
        total = total + out["loss_ce"]
    if mode == "ce_only":
        out["loss_ce_ims"] = L.cross_entropy_loss(lb_q, regs)
        total = out["loss_ce_ims"]
    out["loss"] = total
    return out


def _update(state: TrainState, loss: torch.Tensor, schedule) -> float | None:
    """Backward and one optimizer update at the schedule's rate for the
    step before the increment (the rate this update uses)."""
    with span("train.optimizer"):
        lr_used = schedule(state.step) if schedule is not None else None
        if lr_used is not None:
            for group in state.optimizer.param_groups:
                group["lr"] = lr_used
        state.optimizer.zero_grad(set_to_none=True)
    with span("train.backward"):
        loss.backward()
    with span("train.optimizer"):
        state.optimizer.step()
    state.step += 1
    return lr_used


def _train_metrics(loss, tk, lr_used) -> dict:
    metrics = {"train_loss": loss, "train_top3": tk["top3"],
               "train_top1": tk["top1"]}
    if lr_used is not None:
        metrics["lr"] = lr_used
    return metrics


def build_train_step(cfg: TrainConfig, schedule=None, mesh=None
                     ) -> Callable:
    """``train_step(state, batch, generator) -> (state, metrics)``;
    ``generator`` (on the batch's device) drives dropout; ``mesh``: the
    process group's mesh the batch was sharded on (see the module's
    docstring)."""
    group = _group(mesh)

    def train_step(state: TrainState, batch: dict,
                   generator: torch.Generator | None = None):
        with span("train.forward"), _autocast(cfg, batch["qry"].device):
            fms, lbls = _forward_triplet(state.model, batch, True, generator,
                                         group)
            loss_dict = _losses_for_mode(cfg, fms, lbls, batch)
        lr_used = _update(state, loss_dict["loss"], schedule)
        with span("train.metrics"), torch.no_grad():
            means = {"loss": loss_dict["loss"].detach()}
            if cfg.loss_mode == "ce_only":
                tk = M.classifier_topk(lbls[0], batch["prod_idx"], k=3)
                means.update(tk)
            else:
                tk = _inbatch_topk(fms, batch, group)
            means = _global_means(batch, means, group)
            tk = {k: means.get(k, v) for k, v in tk.items()}
        return state, _train_metrics(means["loss"], tk, lr_used)

    return train_step


def build_eval_step(cfg: TrainConfig, mesh=None) -> Callable:
    """``eval_step(state, batch) -> metrics`` with the reference's
    validation keys (train/train.py:365-373): val_loss and each loss
    component, cos_sims / cos_unsims, val_top3 / val_top1."""
    group = _group(mesh)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict:
        with _autocast(cfg, batch["qry"].device):
            fms, lbls = _forward_triplet(state.model, batch, False, None,
                                         group)
            loss_dict = _losses_for_mode(cfg, fms, lbls, batch)
        pair = M.pairwise_cos_stats(*fms)
        inbatch = cfg.loss_mode != "ce_only"
        if inbatch:
            tk = _inbatch_topk(fms, batch, group)
        else:
            tk = M.classifier_topk(lbls[0], batch["prod_idx"], k=3)
        metrics = {"val_loss": loss_dict["loss"],
                   "cos_sims": pair["cos_sims"],
                   "cos_unsims": pair["cos_unsims"],
                   "val_top3": tk["top3"], "val_top1": tk["top1"]}
        for k, v in loss_dict.items():
            if k != "loss":
                metrics[f"val_{k}"] = v
        # the in-batch top-k is global already; every other value is a
        # row mean
        metrics.update(_global_means(batch, {
            k: v for k, v in metrics.items()
            if not (inbatch and k in ("val_top3", "val_top1"))}, group))
        return metrics

    return eval_step


def build_classifier_train_step(cfg: TrainConfig, schedule=None,
                                mesh=None) -> Callable:
    """Single-image CE classification step (T5,
    train/train_vit_crossentropy.py:180-223) on ``{'image': (B,H,W,3),
    'label': (B,)}``: CE over the folder classes, logit top-1/top-3."""
    group = _group(mesh)

    def train_step(state: TrainState, batch: dict,
                   generator: torch.Generator | None = None):
        with span("train.forward"), _autocast(cfg, batch["image"].device):
            _, logits = _features_and_logits(state.model, batch["image"],
                                             batch, True, generator, 1,
                                             group)
            loss = L.cross_entropy_loss(logits, batch["label"])
        lr_used = _update(state, loss, schedule)
        with span("train.metrics"), torch.no_grad():
            tk = M.classifier_topk(logits, batch["label"], k=3)
            m = _global_means(batch, {"loss": loss.detach(), **tk}, group)
        return state, _train_metrics(m["loss"], m, lr_used)

    return train_step


def build_classifier_eval_step(cfg: TrainConfig, mesh=None) -> Callable:
    """Validation with the reference's keys
    (train/train_vit_crossentropy.py:265-268): val_loss, val_top3,
    val_top1."""
    group = _group(mesh)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict:
        with _autocast(cfg, batch["image"].device):
            _, logits = _features_and_logits(state.model, batch["image"],
                                             batch, False, None, 1, group)
            loss = L.cross_entropy_loss(logits, batch["label"])
        tk = M.classifier_topk(logits, batch["label"], k=3)
        return _global_means(batch, {"val_loss": loss, "val_top3": tk["top3"],
                                     "val_top1": tk["top1"]}, group)

    return eval_step
