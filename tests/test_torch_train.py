"""The port's training path against the JAX package on the CPU: losses and
training metrics, config and recipes, schedule and optimizers, the triplet
train and eval steps on a shrunken b3a from shared weights, and the
Trainer (fit, best-k checkpointing, resume, early stopping,
hparams.yaml)."""

import copy
import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from imageretrievalresearch_tpu import losses as JL
from imageretrievalresearch_tpu import metrics as JM
from imageretrievalresearch_tpu.config import TrainConfig as JaxConfig
from imageretrievalresearch_tpu.models import create_model as jax_create
from imageretrievalresearch_tpu.recipes import RECIPES as JAX_RECIPES
from imageretrievalresearch_tpu.train import steps as JS
from imageretrievalresearch_tpu.train import train_state as JT
from imageretrievalresearch_tpu_torch import losses as L
from imageretrievalresearch_tpu_torch import metrics as M
from imageretrievalresearch_tpu_torch.config import LOSS_MODES, TrainConfig
from imageretrievalresearch_tpu_torch.models import create_model
from imageretrievalresearch_tpu_torch.models.convert import params_from_jax
from imageretrievalresearch_tpu_torch.recipes import RECIPES, make_config
from imageretrievalresearch_tpu_torch.train import (
    Trainer,
    TrainState,
    build_eval_step,
    build_train_step,
    make_optimizer,
    multistep_lr,
)
from imageretrievalresearch_tpu_torch.train import steps as S
from imageretrievalresearch_tpu_torch.train.trainer import hparams_yaml
from imageretrievalresearch_tpu_torch.utils.checkpoint import (
    CheckpointManager,
)

# the shrunken b3a of the step parity: 32 px, 5 classes, no dropout
W, D, SIZE, N_CLS, B = 0.5, 0.1, 32, 5, 4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# losses and metrics
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def emb():
    rng = np.random.default_rng(0)
    q, p, n = (rng.normal(size=(6, 16)).astype(np.float32) for _ in range(3))
    # a near-dead row (norm 1e-5), where the squared-norm eps decides
    q[0] *= 1e-5 / np.linalg.norm(q[0])
    p[1] = q[1]
    return q, p, n


@pytest.mark.parametrize("target,margin,reduction", [
    (1.0, 0.0, "mean"), (-1.0, 0.3, "mean"), (-1.0, 0.5, "sum"),
    (1.0, 0.2, "none")])
def test_cosine_embedding_loss_matches_jax(emb, target, margin, reduction):
    q, p, _ = emb
    got = L.cosine_embedding_loss(_t(q), _t(p), target, margin=margin,
                                  reduction=reduction)
    want = JL.cosine_embedding_loss(q, p, target, margin=margin,
                                    reduction=reduction)
    _close(got, want)


@pytest.mark.parametrize("name", ["triplet", "contrastive", "ce"])
def test_loss_pieces_match_jax(emb, name):
    q, p, n = emb
    if name == "triplet":
        got = L.triplet_losses(_t(q), _t(p), _t(n), cos_margin=0.3)
        want = JL.triplet_losses(q, p, n, cos_margin=0.3)
    elif name == "contrastive":
        got = L.contrastive_pair_losses(_t(q), _t(p), _t(n), margin=0.3)
        want = JL.contrastive_pair_losses(q, p, n, margin=0.3)
    else:
        labels = np.array([0, 3, 15, 2, 2, 9])
        got = {r: L.cross_entropy_loss(_t(q), _t(labels), reduction=r)
               for r in ("mean", "sum", "none")}
        want = {r: JL.cross_entropy_loss(q, labels, reduction=r)
                for r in ("mean", "sum", "none")}
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("mode", LOSS_MODES)
def test_losses_for_every_mode_match_jax(emb, mode):
    q, p, n = emb
    rng = np.random.default_rng(1)
    lbls = [rng.normal(size=(6, 7)).astype(np.float32) for _ in range(3)]
    batch = {"cat_idx": np.array([0, 1, 2, 0, 1, 6]),
             "prod_idx": np.array([3, 3, 5, 1, 0, 2])}
    flags = {"cos_ce": (True, True, False), "cos_con_ce": (True, True, True),
             "cos_only": (True, None, False), "ce_only": (None, True, False)}
    of, ol, con = flags[mode]
    kw = dict(only_feature_embeddings=of, only_target_labels=ol,
              use_contrastive=con, cos_margin=0.3, con_margin=0.3)
    cfg, jcfg = TrainConfig(**kw), JaxConfig(**kw)
    assert cfg.loss_mode == jcfg.loss_mode == mode
    got = S._losses_for_mode(cfg, [_t(a) for a in (q, p, n)],
                             [_t(a) for a in lbls],
                             {k: _t(v) for k, v in batch.items()})
    want = JS._losses_for_mode(jcfg, (q, p, n), lbls, batch)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])


def test_inbatch_topk_ties_and_small_batches_match_jax():
    """Engineered ties (duplicate positives: lax.top_k keeps the lowest
    index) and batches smaller than k (k clamped, the key kept)."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(8, 5)).astype(np.float32)
    p = rng.normal(size=(8, 5)).astype(np.float32)
    p[3] = p[1] = p[6]
    q[2] = p[6]
    classes = np.array([0, 1, 2, 3, 1, 2, 0, 3])
    for b in (8, 2, 1):
        got = M.inbatch_topk(_t(q[:b]), _t(p[:b]), _t(classes[:b]), k=3)
        want = JM.inbatch_topk(q[:b], p[:b], classes[:b], k=3)
        assert set(got) == set(want) == {"top3", "top1"}
        for k in want:
            _close(got[k], want[k])
    sims = M.cosine_sim_matrix(_t(q), _t(p))
    _close(sims, JM.cosine_sim_matrix(q, p))
    for ks in ((1, 3), (1, 5, 20)):
        got = M.gallery_topk_index_match(sims, ks=ks)
        want = JM.gallery_topk_index_match(jnp.asarray(sims.numpy()), ks=ks)
        for k in want:
            _close(got[k], want[k])


def test_pairwise_and_classifier_metrics_match_jax(emb):
    q, p, n = emb
    got = M.pairwise_cos_stats(_t(q), _t(p), _t(n))
    want = JM.pairwise_cos_stats(q, p, n)
    for k in want:
        _close(got[k], want[k])
    logits = np.zeros((5, 6), np.float32)
    logits[:, 2] = logits[:, 4] = 1.0          # tied top logits
    logits[0, 5] = 3.0
    labels = np.array([5, 4, 2, 0, 4])
    got = M.classifier_topk(_t(logits), _t(labels), k=3)
    want = JM.classifier_topk(logits, labels, k=3)
    for k in want:
        _close(got[k], want[k])


# ---------------------------------------------------------------------------
# config, recipes, schedule, optimizers
# ---------------------------------------------------------------------------

def test_config_and_recipes_match_jax():
    assert RECIPES == JAX_RECIPES
    ours = dataclasses.asdict(TrainConfig())
    theirs = dataclasses.asdict(JaxConfig())
    assert ours.pop("device") == "cuda" and theirs.pop("device") == "tpu"
    assert ours == theirs
    for name in RECIPES:
        cfg = make_config(name, batch_size=8)
        jcfg = JaxConfig(**dataclasses.asdict(cfg))
        assert cfg.loss_mode == jcfg.loss_mode
        assert cfg.effective_task == jcfg.effective_task
    with pytest.raises(ValueError):
        make_config("train", nope=1)
    with pytest.raises(ValueError):
        TrainConfig(only_feature_embeddings=None,
                    only_target_labels=None).loss_mode


def test_multistep_lr_matches_optax():
    ours = multistep_lr(4.7863e-3, (2, 5, 5, 7), 0.1, 3)
    theirs = JT.multistep_lr(4.7863e-3, (2, 5, 5, 7), 0.1, 3)
    for step in range(30):
        assert ours(step) == float(theirs(step)), step


@pytest.mark.parametrize("name", ["Adam", "SGD"])
def test_optimizer_steps_match_optax(name):
    """Two updates from the same parameters and gradients, at a schedule
    that drops between them."""
    rng = np.random.default_rng(3)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in (("a", (4, 3)), ("b", (5,)))}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    grads[0]["b"][0] = 0.0
    sched = multistep_lr(1e-2, (1,), 0.1, 1)
    tx = JT.make_optimizer(name, JT.multistep_lr(1e-2, (1,), 0.1, 1), 1e-2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v.copy())) for k, v in params.items()}
    opt = make_optimizer(name, tp.values(), 1e-2, 1e-2)
    for step, g in enumerate(grads):
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for group in opt.param_groups:
            group["lr"] = sched(step)
        for k, p in tp.items():
            p.grad = _t(g[k])
        opt.step()
    for k in params:
        _close(tp[k].detach(), jp[k], rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the train and eval steps against JAX, shared weights
# ---------------------------------------------------------------------------

def _batches(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = {r: rng.random((B, SIZE, SIZE, 3), dtype=np.float32)
             for r in ("qry", "pos", "neg")}
        out.append({"qry": x["qry"], "pos": [x["pos"]], "neg": [x["neg"]],
                    "cat_idx": rng.integers(0, N_CLS, B),
                    "prod_idx": rng.integers(0, N_CLS, B)})
    return out


def _jax_variables(bb):
    shapes = jax.eval_shape(bb.init, jax.random.key(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    rng = np.random.default_rng(7)

    def leaf(path, x):
        key = path[-1].key
        if key == "kernel":
            fan_in = int(np.prod(x.shape[:-1]))
            return rng.normal(0, np.sqrt(1.0 / fan_in), x.shape)
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape)
        return rng.normal(0, 0.1, x.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(leaf(p, x), jnp.float32), shapes)


def _bn_rows(model, batch) -> dict:
    """Rows each BatchNorm normalizes over (N * H * W) in one train pass,
    by state-dict prefix (on a copy: a train pass updates the running
    statistics)."""
    rows, hooks = {}, []
    model = copy.deepcopy(model)
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp, name=name: rows.__setitem__(
                    name, inp[0].numel() // inp[0].shape[1])))
    with torch.no_grad():
        S._forward_triplet(model, batch, True, None)
    for h in hooks:
        h.remove()
    return rows


def _torch_batch(b):
    return {"qry": _t(b["qry"]), "pos": [_t(b["pos"][0])],
            "neg": [_t(b["neg"][0])], "cat_idx": _t(b["cat_idx"]),
            "prod_idx": _t(b["prod_idx"])}


@pytest.fixture(scope="module")
def step_runs():
    """Two train steps (SGD, so that parameters are linear in the
    gradients; AdamW's first updates are sign-like and would turn rounding
    differences of tiny gradients into +-lr) of cos_con_ce and of
    ce_only, and an eval step, in both packages from the same weights.
    Three JAX compiles."""
    bb = jax_create("efficientnet_b3a", num_classes=N_CLS, width_mult=W,
                    depth_mult=D, drop_rate=0.0)
    variables = _jax_variables(bb)
    batches = _batches(5, 3)
    runs = {}
    for mode, of in (("cos_con_ce", True), ("ce_only", None)):
        kw = dict(optimizer_name="SGD", learning_rate=0.005,
                  weight_decay=1e-2, only_feature_embeddings=of,
                  use_contrastive=True, cos_margin=0.3, con_margin=0.3,
                  compute_dtype="float32", milestones=(1,))
        jcfg, cfg = JaxConfig(**kw), TrainConfig(**kw, device="cpu")
        jsched = JT.multistep_lr(cfg.learning_rate, cfg.milestones, 0.1, 1)
        state = JT.EmbedTrainState.from_backbone(
            bb, variables, JT.make_optimizer("SGD", jsched, 1e-2))
        jstep = jax.jit(JS.build_train_step(bb, jcfg, jsched))
        jm = []
        for b in batches[:2]:
            state, m = jstep(state, b, jax.random.key(0))
            jm.append(jax.device_get(m))
        run = {"jax_metrics": jm, "jax_vars": jax.device_get(
            state.backbone_variables())}
        if mode == "cos_con_ce":
            run["jax_eval"] = jax.device_get(jax.jit(
                JS.build_eval_step(bb, jcfg))(state, batches[2]))

        model = create_model("efficientnet_b3a", num_classes=N_CLS,
                             width_mult=W, depth_mult=D, drop_rate=0.0,
                             device="cpu", seed=None)
        model.load_timm_state_dict(params_from_jax(variables, model))
        run["v0"] = {k: v.clone() for k, v in model.state_dict().items()}
        run["bn_rows"] = _bn_rows(model, _torch_batch(batches[0]))
        tstate = TrainState(model, make_optimizer(
            "SGD", model.parameters(), cfg.learning_rate, 1e-2), 0)
        step = build_train_step(cfg, multistep_lr(cfg.learning_rate,
                                                  cfg.milestones, 0.1, 1))
        run["metrics"] = [step(tstate, _torch_batch(b))[1]
                          for b in batches[:2]]
        run["state"] = tstate
        if mode == "cos_con_ce":
            # the eval step on JAX's trained variables (the running
            # variances differ by design, see below)
            trained = create_model("efficientnet_b3a", num_classes=N_CLS,
                                   width_mult=W, depth_mult=D, device="cpu",
                                   seed=None)
            trained.load_timm_state_dict(params_from_jax(run["jax_vars"],
                                                         trained))
            run["eval"] = build_eval_step(cfg)(TrainState(trained, None),
                                               _torch_batch(batches[2]))
        runs[mode] = run
    return runs


@pytest.mark.parametrize("mode", ["cos_con_ce", "ce_only"])
def test_train_step_losses_and_metrics_match_jax(step_runs, mode):
    run = step_runs[mode]
    assert run["state"].step == 2
    for got, want in zip(run["metrics"], run["jax_metrics"]):
        assert set(got) == set(want) == {"train_loss", "train_top3",
                                         "train_top1", "lr"}
        assert got["lr"] == float(want["lr"])
        for k in ("train_loss", "train_top3", "train_top1"):
            _close(got[k], want[k], rtol=1e-4, atol=1e-5)
    assert run["metrics"][0]["lr"] != run["metrics"][1]["lr"]


@pytest.mark.parametrize("mode", ["cos_con_ce", "ce_only"])
def test_train_step_parameters_after_two_steps_match_jax(step_runs, mode):
    """The two-step updates agree: over all parameters within 1e-3 of
    their norm, and each tensor's within 5% of its largest element. The
    gradients differ by f32 rounding through train-mode BatchNorm over a
    few rows (1 x 1 maps of 12 images at the end); a gradient that nearly
    cancels, such as the first block's BN shift under cos_con_ce, keeps
    the largest relative difference (3%)."""
    run = step_runs[mode]
    want = params_from_jax(run["jax_vars"], run["state"].model)
    got = run["state"].model.net.state_dict()
    assert set(got) == set(want)
    diff2 = upd2 = 0.0
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        upd = v.double() - run["v0"][f"net.{k}"].double()
        diff = got[k].double() - v.double()
        assert diff.abs().max() <= 0.05 * upd.abs().max() + 1e-6, k
        diff2 += float(diff.square().sum())
        upd2 += float(upd.square().sum())
    assert diff2 ** 0.5 <= 1e-3 * upd2 ** 0.5


def test_train_step_batchnorm_statistics_match_jax(step_runs):
    """The running means agree. The running variances differ by torch's
    unbiased update: flax's BatchNorm takes the biased batch variance,
    torch's BatchNorm2d (the reference's) the unbiased one, so after two
    steps at momentum 0.1, v - 0.81 v0 = n / (n - 1) x (flax's v - 0.81 v0),
    n the rows each layer normalizes over (3B x H x W)."""
    run = step_runs["cos_con_ce"]
    want = params_from_jax(run["jax_vars"], run["state"].model)
    got = run["state"].model.net.state_dict()
    v0 = run["v0"]
    n_checked = 0
    for name, rows in run["bn_rows"].items():
        key = name[len("net."):]
        _close(got[f"{key}.running_mean"], want[f"{key}.running_mean"],
               rtol=1e-4, atol=1e-5)
        base = 0.81 * v0[f"{name}.running_var"].double()
        flax = want[f"{key}.running_var"].double() - base
        ours = got[f"{key}.running_var"].double() - base
        _close(ours, flax * rows / (rows - 1), rtol=2e-4, atol=1e-5)
        n_checked += 1
    assert n_checked == len([k for k in got if k.endswith("running_var")])


def test_eval_step_matches_jax(step_runs):
    """The same keys, and every loss and cosine statistic, on JAX's trained
    variables. The top-k values are not compared here: random weights map
    every image to nearly one direction (all in-batch cosines above
    0.9999), so the in-batch ranking is a near-tie that f32 rounding
    decides; ``inbatch_topk`` itself is held against JAX on engineered ties
    above."""
    run = step_runs["cos_con_ce"]
    got, want = run["eval"], run["jax_eval"]
    assert set(got) == set(want)
    assert float(want["cos_sims"]) > 0.9999
    for k in want:
        if not k.startswith("val_top"):
            _close(got[k], want[k], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the Trainer, on the CPU
# ---------------------------------------------------------------------------

class MemoryLoader:
    """Seeded uint8 triplet batches (the last may be partial)."""

    def __init__(self, seed, sizes, src=40):
        rng = np.random.default_rng(seed)

        def u8(b):
            return rng.integers(0, 256, (b, src, src, 3), dtype=np.uint8)
        self.batches = [{"qry": u8(b), "pos": [u8(b)], "neg": [u8(b)],
                         "cat_idx": rng.integers(0, N_CLS, b),
                         "prod_idx": rng.integers(0, N_CLS, b)}
                        for b in sizes]
        self.epochs = []

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)

    def set_epoch(self, epoch):
        self.epochs.append(epoch)


def _tiny():
    return create_model("efficientnet_b3a", num_classes=N_CLS, width_mult=W,
                        depth_mult=D, device="cpu", seed=1)


def _t3(tmp_path, **kw):
    return make_config("train_efficient_cos_con_ce_loss", batch_size=B,
                       image_size=SIZE, compute_dtype="float32",
                       device="cpu", checkpoint_dir=str(tmp_path), **kw)


def test_fit_metric_keys_checkpoints_and_test(tmp_path, step_runs):
    train, val = MemoryLoader(0, [B, B]), MemoryLoader(1, [B, 3])
    trainer = Trainer(_t3(tmp_path, log_every_n_steps=1,
                          profile_dir=str(tmp_path / "profile")), _tiny(),
                      train, val)
    state, hist = trainer.fit(max_epochs=2)
    assert state.step == 4 and train.epochs == [0, 1]
    assert os.path.exists(tmp_path / "profile" / "trace.json")
    keys = (set(step_runs["cos_con_ce"]["jax_metrics"][0])
            | set(step_runs["cos_con_ce"]["jax_eval"]))
    assert [set(e) for e in hist["epochs"]] == [keys, keys]
    assert all(np.isfinite(v) for e in hist["epochs"] for v in e.values())
    with open(tmp_path / "metrics.jsonl") as f:
        logged = [json.loads(line) for line in f]
    assert [r["step"] for r in logged if "train_loss" in r] == [1, 2, 3, 4]
    assert os.listdir(tmp_path / "last") == ["4"]
    assert len(os.listdir(tmp_path / "best")) == 1
    # the partial val batch weighs 3/7
    per, sizes = trainer._eval_batches(state, val)
    assert sizes == [B, 3]
    epoch = trainer.eval_epoch(state)
    _close(epoch["val_loss"], np.average(per["val_loss"], weights=sizes))
    res = trainer.test(state, val, results_path=str(tmp_path / "r.pkl"))
    with open(tmp_path / "r.pkl", "rb") as f:
        assert pickle.load(f) == res
    _close(res["test_loss"], epoch["val_loss"])
    assert len(res["test_scores"]) == 2


def test_best_k_keeps_the_earliest_of_exact_ties(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), monitor="cos_sims",
                             save_top_k=2)
    for step, v in ((1, 0.5), (2, 0.7), (3, 0.7), (4, 0.2), (5, 0.7)):
        ckpt.save(step, {"w": torch.tensor(float(step))}, {"cos_sims": v})
    assert sorted(ckpt._steps("best")) == [2, 3] and ckpt.best_step() == 2
    assert ckpt.latest_step() == 5
    assert float(ckpt.restore()["w"]) == 2.0
    assert float(ckpt.restore(5)["w"]) == 5.0
    # a resumed manager continues above every retained ordinal: a new tie
    # still loses to the earlier saves
    again = CheckpointManager(str(tmp_path), monitor="cos_sims",
                              save_top_k=2)
    again.save(6, {"w": torch.tensor(6.0)}, {"cos_sims": 0.7})
    assert sorted(again._steps("best")) == [2, 3]
    low = CheckpointManager(str(tmp_path / "min"), monitor="train_loss",
                            mode="min")
    for step, v in ((1, 3.0), (2, 1.0), (3, 1.0)):
        low.save(step, {}, {"train_loss": v})
    assert low.best_step() == 2


def test_resume_continues_and_seeds_early_stopping(tmp_path):
    train, val = MemoryLoader(0, [B, B]), MemoryLoader(1, [B])
    cfg = _t3(tmp_path, early_stop_patience=1)
    Trainer(cfg, _tiny(), train, val).fit(max_epochs=2)
    # the resumed run's monitor is made worse than the logged best: seeded
    # from metrics.jsonl, early stopping ends it after one epoch
    resumed = Trainer(cfg, _tiny(), train, val,
                      metric_transforms={"cos_sims": lambda v: -1.0})
    assert resumed._logged_monitor_best() is not None
    state, hist = resumed.fit(max_epochs=5, resume=True)
    assert state.step == 6 and hist["stopped_early"] == 2
    assert train.epochs[-1] == 2


def test_hparams_yaml_loads_as_what_jax_writes(tmp_path):
    cfg = _t3(tmp_path, ims_path="data: sketchy #1", weight_decay=1e-5,
              expdir=None, milestones=(6, 15, 22))
    Trainer(cfg, _tiny(), MemoryLoader(0, [B]))
    with open(tmp_path / "hparams.yaml") as f:
        ours = yaml.safe_load(f)
    jax_cfg = JaxConfig(**dataclasses.asdict(cfg))
    theirs = yaml.safe_load(yaml.safe_dump(
        {k: (list(v) if isinstance(v, tuple) else v)
         for k, v in dataclasses.asdict(jax_cfg).items()}))
    assert ours == theirs
    assert hparams_yaml(cfg) == open(tmp_path / "hparams.yaml").read()


def test_trainer_raises_without_a_device_and_without_cuda(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = _tiny()
    cfg = make_config("train_efficient_cos_con_ce_loss")
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, model, MemoryLoader(0, [B]))
    # more devices, or FSDP, outside a process group: fit() launches that
    # many workers (one for FSDP on one device)
    for kw, ranks in ((dict(num_devices=2), 2),
                      (dict(param_sharding="fsdp"), 1)):
        trainer = Trainer(_t3(tmp_path, **kw), model, MemoryLoader(0, [B]))
        assert trainer._launch == ranks and trainer.mesh is None
    # more cards than are visible
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="1 CUDA devices are visible"):
        Trainer(dataclasses.replace(cfg, num_devices=2), model,
                MemoryLoader(0, [B]))



def test_trainer_no_card_message_names_the_config_field(monkeypatch):
    # the device comes from the config alone: the message must name it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = make_config("train_efficient_cos_con_ce_loss")
    with pytest.raises(RuntimeError) as info:
        Trainer(cfg, _tiny(), MemoryLoader(0, [B]))
    assert 'pass TrainConfig(device="cpu")' in str(info.value)
    assert "device='cpu'" not in str(info.value)


# ---------------------------------------------------------------------------
# when the train step replays CUDA graphs (the decision alone: the CPU
# captures none; tests/test_torch_train_graph.py replays on the card)
# ---------------------------------------------------------------------------

def _sized_batch(b, **extra):
    x = torch.zeros(b, 8, 8, 3)
    i = torch.zeros(b, dtype=torch.long)
    return {"qry": x, "pos": [x], "neg": [x], "cat_idx": i, "prod_idx": i,
            **extra}


@pytest.mark.parametrize("case,sizes,want", [
    ("cpu", [4, 4, 4], ["eager"] * 3),
    ("rows", [4, 4, 4], ["eager"] * 3),
    ("mesh", [4, 4, 4], ["eager"] * 3),
    ("depthwise_opt_in", [4, 4, 4], ["eager"] * 3),
    # two hooked steps, then the hook removed: the hooked steps saw the
    # signature
    ("hooked", [4, 4, 4, 4], ["eager", "eager", "capture", "replay"]),
    ("sightings", [4, 4, 4, 4], ["eager", "capture", "replay", "replay"]),
    ("third_signature", [4, 4, 3, 3, 2, 2, 4, 3],
     ["eager", "capture", "eager", "capture", "eager", "eager", "replay",
      "replay"]),
])
def test_train_step_graph_engagement(monkeypatch, case, sizes, want):
    cfg = TrainConfig(device="cpu", compute_dtype="float32")
    cache = S._GraphCache(cfg, object() if case == "mesh" else None)
    if case != "cpu":
        monkeypatch.setattr(S, "_on_card", lambda batch: True)
    if case == "depthwise_opt_in":
        monkeypatch.setenv("IRT_FORCE_PALLAS_DW", "1")
    model = torch.nn.Linear(3, 2)
    hook = (model.register_forward_hook(lambda *a: None)
            if case == "hooked" else None)
    state = TrainState(model, None, 0)
    got = []
    for i, b in enumerate(sizes):
        if hook is not None and i == 2:
            hook.remove()
        extra = {"rows": (0, 2 * b)} if case == "rows" else {}
        action, sig = cache.action(state, _sized_batch(b, **extra), None)
        if action == "capture":
            cache.held[sig] = object()     # what a capture leaves
        got.append(action)
    assert got == want
    # another model (new parameter storages) is another signature
    if case == "sightings":
        other = TrainState(torch.nn.Linear(3, 2), None, 0)
        assert cache.action(other, _sized_batch(4), None)[0] == "eager"
