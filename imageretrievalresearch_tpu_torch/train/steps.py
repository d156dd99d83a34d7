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
"""

from __future__ import annotations

from typing import Callable

import torch

from imageretrievalresearch_tpu_torch import losses as L
from imageretrievalresearch_tpu_torch import metrics as M
from imageretrievalresearch_tpu_torch.config import TrainConfig
from imageretrievalresearch_tpu_torch.train.train_state import TrainState

_COMPUTE_DTYPES = ("float32", "bfloat16")


def _autocast(cfg: TrainConfig, device: torch.device):
    if cfg.compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {_COMPUTE_DTYPES}, "
                         f"got {cfg.compute_dtype!r}")
    return torch.autocast(device.type, dtype=torch.bfloat16,
                          enabled=cfg.compute_dtype == "bfloat16")


def _forward_triplet(model, batch: dict, train: bool,
                     generator: torch.Generator | None):
    """(fm_q, fm_p, fm_n), (lb_q, lb_p, lb_n) from one pass over the
    concatenated roles."""
    qry = batch["qry"]
    b = qry.shape[0]
    x = torch.cat([qry, batch["pos"][0], batch["neg"][0]], dim=0)
    emb, logits = model.features_and_logits(x, train=train,
                                            generator=generator)
    return emb.split(b), logits.split(b)


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
    lr_used = schedule(state.step) if schedule is not None else None
    if lr_used is not None:
        for group in state.optimizer.param_groups:
            group["lr"] = lr_used
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return lr_used


def _train_metrics(loss, tk, lr_used) -> dict:
    metrics = {"train_loss": loss.detach(), "train_top3": tk["top3"],
               "train_top1": tk["top1"]}
    if lr_used is not None:
        metrics["lr"] = lr_used
    return metrics


def build_train_step(cfg: TrainConfig, schedule=None) -> Callable:
    """``train_step(state, batch, generator) -> (state, metrics)``;
    ``generator`` (on the batch's device) drives dropout."""

    def train_step(state: TrainState, batch: dict,
                   generator: torch.Generator | None = None):
        with _autocast(cfg, batch["qry"].device):
            fms, lbls = _forward_triplet(state.model, batch, True, generator)
            loss_dict = _losses_for_mode(cfg, fms, lbls, batch)
        lr_used = _update(state, loss_dict["loss"], schedule)
        with torch.no_grad():
            if cfg.loss_mode == "ce_only":
                tk = M.classifier_topk(lbls[0], batch["prod_idx"], k=3)
            else:
                tk = M.inbatch_topk(fms[0], fms[1], batch["cat_idx"], k=3)
        return state, _train_metrics(loss_dict["loss"], tk, lr_used)

    return train_step


def build_eval_step(cfg: TrainConfig) -> Callable:
    """``eval_step(state, batch) -> metrics`` with the reference's
    validation keys (train/train.py:365-373): val_loss and each loss
    component, cos_sims / cos_unsims, val_top3 / val_top1."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict:
        with _autocast(cfg, batch["qry"].device):
            fms, lbls = _forward_triplet(state.model, batch, False, None)
            loss_dict = _losses_for_mode(cfg, fms, lbls, batch)
        pair = M.pairwise_cos_stats(*fms)
        if cfg.loss_mode == "ce_only":
            tk = M.classifier_topk(lbls[0], batch["prod_idx"], k=3)
        else:
            tk = M.inbatch_topk(fms[0], fms[1], batch["cat_idx"], k=3)
        metrics = {"val_loss": loss_dict["loss"],
                   "cos_sims": pair["cos_sims"],
                   "cos_unsims": pair["cos_unsims"],
                   "val_top3": tk["top3"], "val_top1": tk["top1"]}
        for k, v in loss_dict.items():
            if k != "loss":
                metrics[f"val_{k}"] = v
        return metrics

    return eval_step


def build_classifier_train_step(cfg: TrainConfig, schedule=None
                                ) -> Callable:
    """Single-image CE classification step (T5,
    train/train_vit_crossentropy.py:180-223) on ``{'image': (B,H,W,3),
    'label': (B,)}``: CE over the folder classes, logit top-1/top-3."""

    def train_step(state: TrainState, batch: dict,
                   generator: torch.Generator | None = None):
        with _autocast(cfg, batch["image"].device):
            _, logits = state.model.features_and_logits(
                batch["image"], train=True, generator=generator)
            loss = L.cross_entropy_loss(logits, batch["label"])
        lr_used = _update(state, loss, schedule)
        with torch.no_grad():
            tk = M.classifier_topk(logits, batch["label"], k=3)
        return state, _train_metrics(loss, tk, lr_used)

    return train_step


def build_classifier_eval_step(cfg: TrainConfig) -> Callable:
    """Validation with the reference's keys
    (train/train_vit_crossentropy.py:265-268): val_loss, val_top3,
    val_top1."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict:
        with _autocast(cfg, batch["image"].device):
            _, logits = state.model.features_and_logits(batch["image"],
                                                        train=False)
            loss = L.cross_entropy_loss(logits, batch["label"])
        tk = M.classifier_topk(logits, batch["label"], k=3)
        return {"val_loss": loss, "val_top3": tk["top3"],
                "val_top1": tk["top1"]}

    return eval_step
