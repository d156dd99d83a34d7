"""Plain PyTorch training step of the triplet recipes: losses, AdamW and
the step itself, in float32 with TF32 off. Nothing here imports the
program.

The recipes' losses (the reference repository's train scripts):

- ``cos_ce`` (T1): CosineEmbeddingLoss(margin) of (qry, pos, +1) and
  (qry, neg, -1) + cross entropy of the query's and the positive's logits
  against the category;
- ``cos_con_ce`` (T3): the same plus the Euclidean contrastive loss
  ``0.5 (y d + (1 - y) relu(m - sqrt(d + 1e-9))^2)``, d the squared
  distance, of (qry, pos, 1) and (qry, neg, 0).

The three roles go through the net as one batch (BatchNorm's statistics
over all of them), as the program's step does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cosine_embedding(x1, x2, target: float, margin: float):
    dot = (x1 * x2).sum(-1)
    cos = dot / torch.sqrt(((x1 * x1).sum(-1) + 1e-12)
                           * ((x2 * x2).sum(-1) + 1e-12))
    loss = 1.0 - cos if target > 0 else torch.clamp(cos - margin, min=0.0)
    return loss.mean()


def contrastive(x1, x2, label: float, margin: float):
    d = ((x2 - x1) ** 2).sum(1)
    hinge = torch.relu(margin - torch.sqrt(d + 1e-9))
    return (0.5 * (label * d + (1.0 - label) * hinge ** 2)).mean()


def triplet_loss(recipe: dict, emb, logits, cat_idx):
    b = emb.shape[0] // 3
    q, p, n = emb[:b], emb[b:2 * b], emb[2 * b:]
    lq, lp = logits[:b], logits[b:2 * b]
    m = recipe["cos_margin"]
    loss = cosine_embedding(q, p, 1.0, m) + cosine_embedding(q, n, -1.0, m)
    if recipe["loss"] == "cos_con_ce":
        c = recipe["con_margin"]
        loss = loss + contrastive(q, p, 1.0, c) + contrastive(q, n, 0.0, c)
    elif recipe["loss"] != "cos_ce":
        raise ValueError(f"unknown loss {recipe['loss']!r}")
    return loss + F.cross_entropy(lq, cat_idx) + F.cross_entropy(lp, cat_idx)


class AdamW:
    """Decoupled weight decay, bias-corrected moments (torch's AdamW
    update, written out)."""

    def __init__(self, params: dict, lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.wd = params, lr, weight_decay
        self.b1, self.b2 = betas
        self.eps = eps
        self.t = 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for k, p in self.params.items():
            g = p.grad
            p.mul_(1.0 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def first_step_from(recipe: dict, emb, logits, cat_idx) -> dict:
    """The loss of a first forward that another run made (its embeddings
    and logits, float) and its gradient of the classifier's bias: the sum
    over the rows of the loss's gradient in the logits."""
    logits = logits.detach().float().requires_grad_(True)
    loss = triplet_loss(recipe, emb.detach().float(), logits, cat_idx)
    (g,) = torch.autograd.grad(loss, logits)
    return {"loss1": float(loss.detach()), "head_grad": g.sum(0)}


def run_steps(net, batches, recipe: dict, dropout_masks):
    """``len(batches)`` steps of ``net`` (train mode) on float NHWC
    triplet batches ``{'x': (3B, H, W, 3), 'cat_idx': (B,)}``: each step's
    loss and the first step's embeddings and logits (``first``), each
    parameter's gradient at the first step, and each parameter's change
    over all the steps (dicts by timm name)."""
    params = {k[len("net."):]: p for k, p in net.named_parameters()}
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = AdamW(params, recipe["learning_rate"], recipe["weight_decay"])
    net.train()
    losses, first_grad, first = [], None, {}
    for batch, mask in zip(batches, dropout_masks):
        for p in params.values():
            p.grad = None
        emb, logits = net(batch["x"], dropout_mask=mask)
        loss = triplet_loss(recipe, emb.float(), logits.float(),
                            batch["cat_idx"])
        loss.backward()
        if first_grad is None:
            first_grad = {k: p.grad.detach().clone()
                          for k, p in params.items()}
            first = {"emb": emb.detach().float(),
                     "logits": logits.detach().float()}
        opt.step()
        losses.append(float(loss.detach()))
    change = {k: (p.detach() - start[k]) for k, p in params.items()}
    first["losses"] = losses
    return first, first_grad, change
