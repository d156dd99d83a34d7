"""Training cells: ``Trainer.train_batch`` of a recipe
(``recipes.make_config``) on raw triplet batches from host memory, as a
loader hands them over, one after another.

Set-up builds one trainer and its state from the seed and drives it
through its first ``compare_steps`` steps on distinct batches (then
``warmup_steps`` more); the window takes that same state on. End-to-end:
``train_triplets_per_s`` (triplets stepped in the window over its
seconds, the window ending when the device has finished) and
``setup_s``. A traced run profiles ``trace_steps`` further steps after
the window.

``correct``: after the window, with the program freed, the plain
reference (``reference/``: the transform, the net, the losses and AdamW in
float32, TF32 off) takes the same first steps on the same batches from
the same weights and draws (AutoAugment's generator, the head dropout's
masks). The readings (``compare``):

- ``input_gap``: the largest difference between the transformed first
  batch the program stepped on and the reference's, cast to the
  configuration's compute type;
- ``emb_rel`` / ``emb_rel_median``: the largest / median
  ||e - e_ref|| / ||e_ref|| over the rows of the first step's forward
  embeddings (a hook on the program's backbone);
- ``loss_gap`` / ``loss1_gap``: the largest relative gap between the two
  losses of a step / of the first step;
- ``loss1_from_emb``: the relative gap between the program's first loss
  and the reference's loss of the program's own first forward (its
  embeddings and logits, the batch's classes);
- ``head_grad_from_logits``: ||g - g_ref|| / ||g_ref|| for the first
  gradient of the classifier's bias, g_ref the reference's from the
  program's own first logits. These two judge the loss and the head's
  backward stage by stage, from the program's forward, which
  ``emb_rel`` judges against the reference's own; rows left out after
  the forward (in the loss or its mean) show here, where the forward's
  readings do not;
- ``grad_gap`` / ``grad_gap_median``: over the parameter tensors
  ("leaves"), the largest / median gap between the norm of the first
  step's gradient (the program's read from its AdamW state after the
  step: the first moment over ``1 - beta1``) and the reference's, over
  the larger of the reference's norm of that leaf and the median leaf's;
- ``update_gap`` / ``update_gap_median``: the same for the norm of each
  leaf's change over the compared steps.

Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by round-off alone and are left out of the leaf
readings. The workload file says which readings are compared, with
their limits; the others are printed for the record.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from port_bench import generator as gen
from port_bench.kinds import common
from port_bench.reference import models as ref_models
from port_bench.reference import train as ref_train
from port_bench.reference import transforms as ref_transforms
from port_bench.trace import Profiled, Reading
from port_bench.work import counts

ZERO_GRAD_SHARE = 1e-3


class PoolLoader:
    """The loader interface the trainer's schedule reads (its length, in
    steps per epoch); the batches are handed to ``train_batch``."""

    def __init__(self, steps: int):
        self.steps = steps

    def __len__(self) -> int:
        return self.steps

    def set_epoch(self, epoch: int) -> None:
        pass


def recipe_mismatches(tc, t: dict, cfg: dict) -> list:
    """Where the program's recipe departs from the traffic file's numbers
    (which the reference follows)."""
    want = {"model_name": cfg["model_name"], "loss_mode": t["loss"],
            "cos_margin": t["cos_margin"],
            "learning_rate": t["learning_rate"],
            "weight_decay": t["weight_decay"],
            "autoaugment": t["autoaugment"], "optimizer_name": "Adam",
            "image_size": cfg["image_size"]}
    if t["loss"] == "cos_con_ce":
        want["con_margin"] = t["con_margin"]
    return [f"{k}: {getattr(tc, k)!r} != {v!r}" for k, v in want.items()
            if getattr(tc, k) != v]


class Program:
    """One trainer and its state, from the seed."""

    def __init__(self, cell, s: dict, device):
        from imageretrievalresearch_tpu_torch.models.backbone import (
            create_model,
        )
        from imageretrievalresearch_tpu_torch.recipes import make_config
        from imageretrievalresearch_tpu_torch.train.trainer import Trainer
        cfg, t = cell.config, cell.traffic
        tc = make_config(t["recipe"], batch_size=t["triplets"],
                         image_size=cfg["image_size"], device=str(device),
                         num_devices=1,
                         compute_dtype=t["compute_dtype"])
        bad = recipe_mismatches(tc, t, cfg)
        if bad:
            raise ValueError(f"recipe {t['recipe']!r} departs from "
                             f"{cell.name}'s traffic: {bad}")
        model = create_model(cfg["model_name"],
                             num_classes=cfg["num_classes"], device=device,
                             seed=None)
        model.load_timm_state_dict(gen.weights(cfg, s["weights"],
                                               device))
        self.trainer = Trainer(tc, model, PoolLoader(t["steps_per_epoch"]))
        self.state = self.trainer.init_state()
        self.gens = (gen.device_generator(s["augment"], device),
                     gen.device_generator(s["dropout"], device))

    def step(self, raw: dict) -> dict:
        self.state, metrics = self.trainer.train_batch(self.state, raw,
                                                       self.gens)
        return metrics


def first_steps(prog: Program, pool: list, n: int, head_bias: str) -> dict:
    """The program's first ``n`` steps on ``pool[:n]``: losses, the first
    gradient's and the change's norm per leaf, the first gradient of the
    classifier's bias (``head_bias``), the first transformed batch and the
    first forward's embeddings and logits (a hook on the backbone)."""
    params = dict(prog.trainer.backbone.net.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    transform, seen, outs = prog.trainer.transform, [], []
    hook = prog.trainer.backbone.register_forward_hook(
        lambda module, inputs, out: outs.append(
            [o.detach().float() for o in out[:2]]))

    def capture(raw, generator=None, **kw):
        out = transform(raw, generator, **kw)
        seen.append(out)
        return out

    prog.trainer.transform = capture
    losses, grad, head = [], {}, None
    try:
        for i in range(n):
            losses.append(float(prog.step(pool[i])["train_loss"]))
            if i == 0:
                prog.trainer.transform = transform
                hook.remove()
                opt = prog.state.optimizer
                beta1 = opt.param_groups[0]["betas"][0]
                grad = {k: float(torch.linalg.vector_norm(
                    opt.state[p]["exp_avg"])) / (1.0 - beta1)
                    if p in opt.state else 0.0 for k, p in params.items()}
                p = params[head_bias]
                head = (opt.state[p]["exp_avg"].detach().float().cpu()
                        / (1.0 - beta1) if p in opt.state
                        else torch.zeros(p.shape))
    finally:
        prog.trainer.transform = transform
        hook.remove()
    change = {k: float(torch.linalg.vector_norm(p.detach() - start[k]))
              for k, p in params.items()}
    x = seen[0]
    return {"losses": losses, "grad": grad, "change": change,
            "head_grad": head,
            "x": torch.cat([x["qry"], x["pos"][0], x["neg"][0]]),
            "emb": outs[0][0], "logits": outs[0][1]}


def drive(cell, s: dict, args, device, fault=None) -> dict:
    """Build the program, take its first steps, warm up, then the window
    (until ``args.seconds`` have passed) and the traced slice."""
    t, cfg = cell.traffic, cell.config
    t0 = time.perf_counter()
    prog = Program(cell, s, device)
    if fault is not None:
        fault(prog)
    common.phase("program", t0)
    pool = gen.triplet_pool(t, cfg["num_classes"], s["batches"], device)
    n0 = t["compare_steps"]
    if len(pool) <= n0:
        raise ValueError("the pool must hold more batches than the "
                         "compared steps")
    common.phase("batches", t0)
    program = first_steps(prog, pool, n0, ref_models.head_bias(cfg))
    common.phase("first_steps", t0)
    j = n0
    for _ in range(t["warmup_steps"]):
        prog.step(pool[j % len(pool)])
        j += 1
    common.sync(device)
    common.phase("warmup", t0)
    ready = time.perf_counter()
    steps = 0
    end = ready + args.seconds
    while time.perf_counter() < end:
        prog.step(pool[(j + steps) % len(pool)])
        steps += 1
    common.sync(device)
    window_s = time.perf_counter() - ready
    trace = None
    if args.trace:
        m = t["trace_steps"]
        with Profiled(torch, m) as prof:
            for i in range(m):
                prog.step(pool[(j + steps + i) % len(pool)])
        trace = prof.trace
    for k in ("x", "emb", "logits"):
        program[k] = program[k].cpu()
    return {"program": program, "ready": ready, "steps": steps,
            "window_s": window_s, "trace": trace,
            "peak": common.peak_bytes(device), "pool": pool}


def run(cell, args, start: float, device="cuda", fault=None):
    """One run; ``fault`` (tests only) breaks the program underneath:
    ``fault(program)`` before its first step."""
    t = cell.traffic
    s = gen.seeds(args.seed)
    common.phase("imports", start)
    first = drive(cell, s, args, device, fault)
    setup_s = first["ready"] - start
    pool, trace = first.pop("pool"), first["trace"]
    common.release()

    ref = reference_steps(cell, s, pool, device)
    ref["own"] = ref_train.first_step_from(
        t, first["program"]["emb"].to(device),
        first["program"]["logits"].to(device),
        torch.as_tensor(pool[0]["cat_idx"], device=device).long())
    values = compare(first["program"], ref, t["compute_dtype"])
    b, steps = t["triplets"], first["steps"]
    reading = Reading(trace, counts={"steps": steps, "triplets": steps * b},
                      work=work(cell), peaks=counts.peaks())
    return common.Outcome(
        attempted=steps, failed=0,
        end_to_end={"setup_s": setup_s,
                    "train_triplets_per_s": steps * b / first["window_s"]},
        checks=common.checks(values, cell.workload), readings=values,
        device=common.device_info(device, cell.chips, first["peak"], trace),
        reading=reading)


def work(cell) -> dict:
    """Per step: 3 x the forward FLOPs of its 3B images (forward and
    backward), and the planes and size of the transform's image
    kernels."""
    t, cfg = cell.traffic, cell.config
    size = cfg["image_size"]
    images = 3 * t["triplets"]
    return {"step_flops": 3 * images * counts.forward_flops(cfg, size),
            "augment_planes": images if t["autoaugment"] else 0,
            "augment_hw": (size, size)}


def reference_steps(cell, s: dict, pool: list, device,
                    precision: str = "float32") -> dict:
    """The reference's first steps from the same seed. ``precision``:
    ``float32`` (TF32 off), the reference itself; ``bfloat16``, under
    bfloat16 autocast as the program's recipe runs (a witness of what
    that rounding alone reads); ``float8``, bfloat16 autocast with the
    products' operands rounded to float8 (the control)."""
    cfg, t = cell.config, cell.traffic
    n, b = t["compare_steps"], t["triplets"]
    common.precise(True)
    net = ref_models.build(cfg, device=device)
    net.load_timm_state_dict(gen.weights(cfg, s["weights"], device))
    aug = gen.device_generator(s["augment"], device)
    batches = []
    for raw in pool[:n]:
        roles = [raw["qry"], raw["pos"][0], raw["neg"][0]]
        x = torch.cat([ref_transforms.train_transform(
            torch.as_tensor(r, device=device), cfg["image_size"],
            t["autoaugment"], aug) for r in roles])
        batches.append({"x": x, "cat_idx": torch.as_tensor(
            raw["cat_idx"], device=device).long()})
    masks = gen.dropout_masks(n, 3 * b, cfg["num_features"],
                              1.0 - cfg["drop_rate"], s["dropout"], device)
    if precision not in ("float32", "bfloat16", "float8"):
        raise ValueError(f"unknown precision {precision!r}")
    with contextlib.ExitStack() as lower:
        if precision != "float32":
            lower.enter_context(torch.autocast(
                torch.device(device).type, dtype=torch.bfloat16))
        if precision == "float8":
            lower.enter_context(ref_models.fake_fp8())
        first, grad, change = ref_train.run_steps(net, batches, t, masks)
    norm = torch.linalg.vector_norm
    return {"losses": first["losses"], "emb": first["emb"],
            "logits": first["logits"],
            "head_grad": grad[ref_models.head_bias(cfg)].float(),
            "grad": {k: float(norm(v)) for k, v in grad.items()},
            "change": {k: float(norm(v)) for k, v in change.items()},
            "x": batches[0]["x"]}


def _leaf_gaps(got: dict, want: dict, leaves: list) -> list:
    """Per leaf: the gap between the two norms over the larger of the
    reference's norm of the leaf and the median leaf's."""
    med = float(np.median([want[k] for k in leaves]))
    return [abs(got[k] - want[k]) / max(want[k], med) for k in leaves]


def compare(program: dict, ref: dict, compute_dtype: str) -> dict:
    """The readings of a run against the reference: ``ref`` holds its
    own steps and, under ``own``, what ``reference.train.first_step_from``
    makes of the program's first forward. Beside the worst step and the
    worst leaf, the first step's loss and the median leaf, which the later
    steps' divergence and the noise of single leaves do not move."""
    grads = list(ref["grad"].values())
    med = float(np.median(grads))
    leaves = [k for k, v in ref["grad"].items() if v >= ZERO_GRAD_SHARE * med]
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        compute_dtype]
    x_ref, e_ref = ref["x"].to(dtype).float(), ref["emb"]
    x = program["x"].float().to(x_ref.device)
    e = program["emb"].float().to(e_ref.device)
    emb_rel = (torch.linalg.vector_norm(e - e_ref, dim=1)
               / torch.linalg.vector_norm(e_ref, dim=1)
               if e.shape == e_ref.shape else torch.tensor([float("inf")]))
    losses = [abs(a - r) / abs(r) for a, r in zip(program["losses"],
                                                   ref["losses"])]
    grad = _leaf_gaps(program["grad"], ref["grad"], leaves)
    change = _leaf_gaps(program["change"], ref["change"], leaves)
    own = ref["own"]
    g, g_ref = (program["head_grad"].float().cpu(),
                own["head_grad"].float().cpu())
    return {
        "input_gap": (float((x - x_ref).abs().max())
                      if x.shape == x_ref.shape else float("inf")),
        "emb_rel": float(emb_rel.max()),
        "emb_rel_median": float(emb_rel.median()),
        "loss_gap": max(losses),
        "loss1_gap": losses[0],
        "loss1_from_emb": abs(program["losses"][0] - own["loss1"])
        / abs(own["loss1"]),
        "head_grad_from_logits": float(torch.linalg.vector_norm(g - g_ref)
                                       / torch.linalg.vector_norm(g_ref)),
        "grad_gap": max(grad),
        "grad_gap_median": float(np.median(grad)),
        "update_gap": max(change),
        "update_gap_median": float(np.median(change)),
    }
