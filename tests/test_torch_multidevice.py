"""Multi-device training on the port against the JAX package, on the CPU.

The port trains data-parallel over a ``torch.distributed`` process group,
one process per device (gloo here); JAX over conftest's 8 virtual CPU
devices. One launch of 2 gloo ranks (the port's launcher: fresh
interpreters that import this module by name) covers, on the shrunken
``efficientnet_b0`` (depth 0.1, width 0.5, 32 px, f32) and a global batch
of 16 = 2 x 8:

(i) the DDP step against JAX's 8-device mesh step from the same weights
    (tests/test_parallel.py's setup, without dropout, with
    tests/test_fsdp.py's SGD: Adam's first update is about lr * sign(g),
    which turns rounding differences of near-zero gradients between the
    two packages into full-size sign flips): the loss, every parameter,
    the BatchNorm running statistics, the train metrics;
(ii) the eval metrics against JAX's mesh eval step;
(iii) the FSDP step against the replicated one (SGD, as
    tests/test_fsdp.py), each large leaf holding half its elements;
(iv) the group-wide BatchNorm against ``nn.BatchNorm2d`` over the
    concatenated batch, forward and backward;
(v) the AutoAugment transform's and dropout's draws, which do not depend
    on the rank layout.

The JAX side runs in this process while the ranks run. In-process groups
of one rank (a fixture) hold the group-wide BatchNorm bitwise to
``nn.BatchNorm2d`` and drive the Trainer's FSDP fit and resume and a DDP
checkpoint. This module imports JAX only inside its tests: the ranks
import it.
"""

import copy
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu_torch.config import TrainConfig
from imageretrievalresearch_tpu_torch.models import create_model
from imageretrievalresearch_tpu_torch.models.layers import GroupBatchNorm2d
from imageretrievalresearch_tpu_torch.ops.preprocess import (
    TransformSpec,
    build_triplet_transform,
)
from imageretrievalresearch_tpu_torch.parallel import (
    fsdp_spec,
    make_mesh,
)
from imageretrievalresearch_tpu_torch.parallel import distributed
from imageretrievalresearch_tpu_torch.train import Trainer, TrainState
from imageretrievalresearch_tpu_torch.train import steps as S
from imageretrievalresearch_tpu_torch.utils.checkpoint import (
    CheckpointManager,
)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
# the shrunken b0 of tests/test_parallel.py, without dropout; 2 ranks x 8
B, RANKS, SIZE, N_CLS = 16, 2, 32, 4
MODEL = dict(num_classes=N_CLS, depth_mult=0.1, width_mult=0.5)


def _batch(rng, b=B, s=SIZE):
    return {"qry": rng.random((b, s, s, 3)).astype(np.float32),
            "pos": [rng.random((b, s, s, 3)).astype(np.float32)],
            "neg": [rng.random((b, s, s, 3)).astype(np.float32)],
            "cat_idx": rng.integers(0, 4, b).astype(np.int32),
            "prod_idx": rng.integers(0, 4, b).astype(np.int32)}


def identity(batch, generator=None, rows=None):
    """The loaders here yield float batches already."""
    return batch


def _cfg(**kw):
    return TrainConfig(model_name="efficientnet_b0", image_size=SIZE,
                       compute_dtype="float32", device="cpu", **kw)


def _model(weights, **kw):
    model = create_model("efficientnet_b0", **{**MODEL, "drop_rate": 0.0,
                                               "drop_path_rate": 0.0, **kw},
                         device="cpu", seed=None)
    model.load_state_dict(weights)
    return model


def _numpy(sd: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _rank_main(p: dict) -> dict:
    """One rank of the 2-rank launch: every check's local results."""
    torch.set_num_threads(2)
    r = distributed.rank()
    out = {}
    # (ii) eval and (i) the DDP step, then (iii) the FSDP step, through
    # the Trainer's rank path: shard_batch, the steps' gathers
    for layout in ("replicated", "fsdp"):
        tr = Trainer(_cfg(optimizer_name="SGD", learning_rate=1e-2,
                          weight_decay=0.0, param_sharding=layout),
                     _model(p["weights"]), [p["batch"]], transform=identity)
        st = tr.init_state()
        if layout == "replicated":
            out["eval"] = {k: float(v) for k, v in tr._eval_step(
                st, tr._batch(p["batch"], identity, None)).items()}
        st, m = tr.train_batch(st, p["batch"], (None, None))
        out[layout] = {"metrics": {k: float(v) for k, v in m.items()},
                       "model": _numpy(st.state_dict()["model"])}
        if layout == "fsdp":
            out["fsdp"]["local"] = {
                n: (w.to_local().numel(), w.numel())
                for n, w in st.model.named_parameters()}
    # (iv) group-wide BatchNorm over this rank's half
    bn_in = p["bn"]
    half = bn_in["x"].shape[0] // RANKS
    bn = GroupBatchNorm2d(bn_in["x"].shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(bn_in["w"]))
        bn.bias.copy_(torch.from_numpy(bn_in["b"]))
    x = torch.from_numpy(bn_in["x"][r * half:(r + 1) * half]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(bn_in["dy"][r * half:(r + 1) * half])).sum(
        ).backward()
    out["bn"] = {"y": y.detach().numpy(), "dx": x.grad.numpy(),
                 "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
                 "running_mean": bn.running_mean.numpy(),
                 "running_var": bn.running_var.numpy()}
    # (v) the draws: AutoAugment on this rank's rows, and one train-mode
    # pass with dropout and drop-path on this rank's rows
    raw = p["raw"]
    b = len(raw["qry"]) // RANKS
    local = {k: ([a[r * b:(r + 1) * b] for a in v] if isinstance(v, list)
                 else v[r * b:(r + 1) * b]) for k, v in raw.items()}
    spec = TransformSpec.train_autoaugment(SIZE)
    tf = build_triplet_transform(spec, spec, spec, device="cpu")
    aug = tf(local, torch.Generator().manual_seed(5), rows=(r * b, 2 * b))
    drop = _model(p["drop_weights"], drop_rate=0.5, drop_path_rate=0.3)
    x = torch.cat([aug["qry"], aug["pos"][0], aug["neg"][0]])
    with torch.no_grad():
        emb, logits = S._features_and_logits(
            drop, x, {"rows": (r * b, 2 * b)}, True,
            torch.Generator().manual_seed(6), 3)
    out["draws"] = {"aug": {k: (v[0] if isinstance(v, list) else v).numpy()
                            for k, v in aug.items()
                            if k in ("qry", "pos", "neg")},
                    "emb": emb.numpy(), "logits": logits.numpy()}
    return out


def _rank_fails(p):
    if distributed.rank() == 1:
        raise RuntimeError("planted failure")
    return None


# ---------------------------------------------------------------------------
# the JAX side and the launch, run together
# ---------------------------------------------------------------------------

def _jax_reference(bb, variables, batch):
    """tests/test_parallel.py's setup without dropout: the 8-device mesh
    train step (SGD, as tests/test_fsdp.py) and eval step."""
    import jax

    from imageretrievalresearch_tpu.config import TrainConfig as JC
    from imageretrievalresearch_tpu.parallel.mesh import (
        make_mesh as jmesh,
        replicate,
        shard_batch,
    )
    from imageretrievalresearch_tpu.train import (
        EmbedTrainState,
        build_eval_step,
        build_train_step,
        make_optimizer,
    )

    cfg = JC(model_name="efficientnet_b0", image_size=SIZE,
             compute_dtype="float32")
    state = EmbedTrainState.from_backbone(bb, variables,
                                          make_optimizer("SGD", 1e-2, 0.0))
    mesh = jmesh(8)
    placed = jax.device_put(state, replicate(mesh))
    sharded = shard_batch(mesh, batch)
    m_eval = jax.jit(build_eval_step(bb, cfg))(placed, sharded)
    new, m = jax.jit(build_train_step(bb, cfg))(placed, sharded,
                                               jax.random.key(1))
    return (jax.device_get(m_eval), jax.device_get(m),
            jax.device_get(new.backbone_variables()))


def _bn_rows(model, x) -> dict:
    """Rows each BatchNorm normalizes over in one train pass of ``x``."""
    rows, hooks = {}, []
    model = copy.deepcopy(model).train()
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp, name=name: rows.__setitem__(
                    name, inp[0].numel() // inp[0].shape[1])))
    with torch.no_grad():
        model.embed(x)
    for h in hooks:
        h.remove()
    return rows


@pytest.fixture(scope="module")
def launched():
    """The JAX reference, and the 2-rank launch on its inputs (the launch
    needs the JAX weights, converted: JAX's init runs first, then its
    steps run while the ranks do)."""
    import jax
    import jax.numpy as jnp

    from imageretrievalresearch_tpu.models import create_model as jcreate
    from imageretrievalresearch_tpu_torch.models.convert import (
        params_from_jax,
    )

    rng = np.random.default_rng(42)
    batch = _batch(rng)
    bb = jcreate("efficientnet_b0", drop_rate=0.0, drop_path_rate=0.0,
                 **MODEL)
    # seeded He-normal kernels and identity BatchNorms in the init's
    # shapes (flax's eager init takes half a minute here): the launch
    # needs them before JAX's steps compile. The embeddings keep their
    # in-batch top-3 margins above 1e-4, far above f32 rounding.
    shapes = jax.eval_shape(bb.init, jax.random.key(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    leaf_rng = np.random.default_rng(0)

    def leaf(path, x):
        key = path[-1].key
        if key == "kernel":
            fan_in = int(np.prod(x.shape[:-1]))
            v = leaf_rng.normal(0, np.sqrt(2.0 / fan_in), x.shape)
        else:
            v = np.full(x.shape, float(key in ("scale", "var")))
        return jnp.asarray(v, jnp.float32)

    variables = jax.tree_util.tree_map_with_path(leaf, shapes)
    model = create_model("efficientnet_b0", **MODEL, drop_rate=0.0,
                         drop_path_rate=0.0, device="cpu", seed=None)
    model.load_timm_state_dict(params_from_jax(variables, model))
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    drop_weights = create_model(
        "efficientnet_b0", **MODEL, drop_rate=0.5, drop_path_rate=0.3,
        device="cpu", seed=3).state_dict()
    r2 = np.random.default_rng(7)
    bn = {"x": r2.normal(1.0, 2.0, (8, 6, 5, 5)).astype(np.float32),
          "dy": r2.normal(size=(8, 6, 5, 5)).astype(np.float32),
          "w": r2.uniform(0.5, 1.5, 6).astype(np.float32),
          "b": r2.normal(size=6).astype(np.float32)}
    raw = {k: ([r2.integers(0, 256, (4, 40, 40, 3), dtype=np.uint8)]
               if k in ("pos", "neg")
               else r2.integers(0, 256, (4, 40, 40, 3), dtype=np.uint8))
           for k in ("qry", "pos", "neg")}
    payload = {"weights": weights, "batch": batch, "bn": bn, "raw": raw,
               "drop_weights": drop_weights}
    box = {}

    def go():
        try:
            box["ranks"] = distributed.launch(
                "test_torch_multidevice:_rank_main", RANKS, payload,
                devices=["cpu"] * RANKS, env={"PYTHONPATH": TESTS},
                timeout_s=300)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["error"] = e

    t = threading.Thread(target=go)
    t.start()
    ref = _jax_reference(bb, variables, batch)
    t.join()
    if "error" in box:
        raise box["error"]
    x = torch.from_numpy(np.concatenate(
        [batch["qry"], batch["pos"][0], batch["neg"][0]]))
    return {"ranks": box["ranks"], "jax": ref, "payload": payload,
            "model": model, "bn_rows": _bn_rows(model, x)}


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def test_ddp_step_matches_jax_mesh_step(launched):
    """(i) The 2-rank DDP step on 2 x 8 rows against JAX's step on its
    8-device mesh: the loss (rel 1e-4) and train metrics, every parameter
    (rtol 1e-3, atol 1e-6), the running means, and the running variances
    up to torch's unbiased factor from the global row count."""
    from imageretrievalresearch_tpu_torch.models.convert import (
        params_from_jax,
    )
    _, jm, jvars = launched["jax"]
    ranks = launched["ranks"]
    got = ranks[0]["replicated"]
    assert got["metrics"] == ranks[1]["replicated"]["metrics"]
    assert got["metrics"]["train_loss"] == pytest.approx(
        float(jm["train_loss"]), rel=1e-4)
    for k in ("train_top3", "train_top1"):
        assert got["metrics"][k] == pytest.approx(float(jm[k]), abs=1e-6)
    model = launched["model"]
    want = params_from_jax(jvars, model)
    v0 = launched["payload"]["weights"]
    n_checked = 0
    for k, w in want.items():
        mine = got["model"][f"net.{k}"]
        np.testing.assert_array_equal(mine, ranks[1]["replicated"]["model"][
            f"net.{k}"])
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith("running_var"):
            rows = launched["bn_rows"][f"net.{k[:-len('.running_var')]}"]
            base = 0.9 * v0[f"net.{k}"].double().numpy()
            _close(mine - base, (w.double().numpy() - base)
                   * rows / (rows - 1), rtol=1e-4, atol=1e-5)
            n_checked += 1
        elif k.endswith("running_mean"):
            _close(mine, w, rtol=1e-4, atol=1e-5)
        else:
            _close(mine, w, rtol=1e-3, atol=1e-6)
    assert n_checked == len(launched["bn_rows"]) > 10


def test_eval_metrics_match_jax_mesh_eval(launched):
    """(ii) The eval metrics of the 2-rank sharded batch (losses and
    cosine statistics averaged over the ranks, the in-batch top-k on the
    gathered embeddings) against JAX's 8-device eval step."""
    jeval, _, _ = launched["jax"]
    got = launched["ranks"][0]["eval"]
    assert got == launched["ranks"][1]["eval"]
    assert set(got) == set(jeval)
    for k in got:
        assert got[k] == pytest.approx(float(jeval[k]), rel=1e-4,
                                       abs=1e-6), k


def test_fsdp_step_matches_replicated_and_halves_large_leaves(launched):
    """(iii) The FSDP step's loss and update against the replicated step
    (SGD: the update is linear in the gradient), and each leaf that
    fsdp_spec shards holds half its elements on each rank."""
    for rank in launched["ranks"]:
        rep, fs = rank["replicated"], rank["fsdp"]
        assert fs["metrics"]["train_loss"] == pytest.approx(
            rep["metrics"]["train_loss"], rel=1e-4)
        assert set(fs["model"]) == set(rep["model"])
        for k, w in rep["model"].items():
            _close(fs["model"][k], w, rtol=1e-3, atol=1e-6)
        big = [n for n, (_, total) in fs["local"].items()
               if fsdp_spec(launched["model"].get_parameter(n).shape,
                            RANKS) != ()]
        assert len(big) >= 3
        for n in big:
            local, total = fs["local"][n]
            assert local == total // RANKS, n


def test_group_batch_norm_matches_batch_norm_over_both_halves(launched):
    """(iv) Forward and backward of the group-wide BatchNorm, each rank
    on its half, against nn.BatchNorm2d over the whole batch: outputs and
    input gradients row for row, the parameter gradients summed over the
    ranks, the running statistics (unbiased from the global count)."""
    p = launched["payload"]["bn"]
    bn = torch.nn.BatchNorm2d(6)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["w"]))
        bn.bias.copy_(torch.from_numpy(p["b"]))
    x = torch.from_numpy(p["x"]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(p["dy"])).sum().backward()
    ranks = [r["bn"] for r in launched["ranks"]]
    _close(np.concatenate([r["y"] for r in ranks]), y.detach(), 1e-5, 1e-5)
    _close(np.concatenate([r["dx"] for r in ranks]), x.grad, 1e-4, 1e-5)
    _close(sum(r["dw"] for r in ranks), bn.weight.grad, 1e-5, 1e-5)
    _close(sum(r["db"] for r in ranks), bn.bias.grad, 1e-5, 1e-5)
    for key in ("running_mean", "running_var"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
        _close(ranks[0][key], getattr(bn, key), 1e-5, 1e-6)


def test_draws_do_not_depend_on_the_rank_layout(launched):
    """(v) Each rank's AutoAugment rows equal those rows of the 1-rank
    transform (bitwise); its dropout / drop-path pass (train-mode, the
    group-wide BatchNorm) equals those rows of the 1-rank pass."""
    p = launched["payload"]
    spec = TransformSpec.train_autoaugment(SIZE)
    tf = build_triplet_transform(spec, spec, spec, device="cpu")
    full = tf(p["raw"], torch.Generator().manual_seed(5))
    b = len(p["raw"]["qry"]) // RANKS
    for r, rank in enumerate(launched["ranks"]):
        for k in ("qry", "pos", "neg"):
            want = full[k][0] if k != "qry" else full[k]
            np.testing.assert_array_equal(rank["draws"]["aug"][k],
                                          want[r * b:(r + 1) * b])
    drop = _model(p["drop_weights"], drop_rate=0.5, drop_path_rate=0.3)
    x = torch.cat([full["qry"], full["pos"][0], full["neg"][0]])
    with torch.no_grad():
        emb, logits = S._features_and_logits(
            drop, x, {}, True, torch.Generator().manual_seed(6), 3)
    for got, want in (("emb", emb), ("logits", logits)):
        rows = [np.concatenate([want[i * 2 * b + r * b:
                                     i * 2 * b + (r + 1) * b]
                                for i in range(3)]) for r in range(RANKS)]
        _close(np.concatenate([rk["draws"][got]
                               for rk in launched["ranks"]]),
               np.concatenate(rows), 1e-4, 1e-5)
    # the masks took effect: the pass differs from one without dropout
    plain = _model(p["drop_weights"])
    with torch.no_grad():
        _, quiet = S._features_and_logits(plain, x, {}, True, None, 3)
    assert not torch.allclose(quiet, logits, atol=1e-3)


def test_launch_fails_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="(?s)of 2 exited.*planted "
                                           "failure"):
        distributed.launch("test_torch_multidevice:_rank_fails", 2, None,
                           devices=["cpu", "cpu"],
                           env={"PYTHONPATH": TESTS}, timeout_s=120)
    with pytest.raises(ValueError, match="__main__"):
        distributed.launch("__main__:f", 1, devices=["cpu"])


# ---------------------------------------------------------------------------
# in-process groups of one rank
# ---------------------------------------------------------------------------

@pytest.fixture
def group():
    distributed.init_group(
        world_size=1, rank=0, device="cpu",
        init_method=f"tcp://localhost:{distributed.free_port()}")
    try:
        yield make_mesh()
    finally:
        distributed.destroy_group()


def _bn_pass(bn, x, dy):
    x = x.clone().requires_grad_()
    y = bn(x)
    (y * dy).sum().backward()
    return (y.detach(), x.grad, bn.weight.grad, bn.bias.grad,
            bn.running_mean.clone(), bn.running_var.clone(),
            bn.num_batches_tracked.clone())


@pytest.mark.parametrize("in_group", [True, False])
def test_group_batch_norm_is_batch_norm_at_one_rank(in_group, request):
    """At world size 1 in a group, and outside any group, the group-wide
    BatchNorm is nn.BatchNorm2d bit for bit: forward, backward, running
    statistics, and the same state-dict keys."""
    if in_group:
        request.getfixturevalue("group")
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 5, 6, 6), generator=g) * 3 + 1
    dy = torch.randn((4, 5, 6, 6), generator=g)
    ours, ref = GroupBatchNorm2d(5), torch.nn.BatchNorm2d(5)
    assert isinstance(ours, torch.nn.BatchNorm2d)
    assert list(ours.state_dict()) == list(ref.state_dict())
    with torch.no_grad():
        for m in (ours, ref):
            m.weight.copy_(torch.linspace(0.5, 1.5, 5))
            m.bias.copy_(torch.linspace(-1, 1, 5))
    for a, b in zip(_bn_pass(ours, x, dy), _bn_pass(ref, x, dy)):
        assert torch.equal(a, b)
    ours.eval(), ref.eval()
    assert torch.equal(ours(x), ref(x))


@pytest.mark.parametrize("case", [
    ((64,), 8, {}), ((9001, 3), 8, {"min_elems": 1}),
    ((16, 4096), 8, {"min_elems": 1}), ((4096, 16), 8, {"min_elems": 1}),
    ((3, 3, 256, 256), 8, {"min_elems": 1}),
    ((999, 256), 8, {"min_elems": 1}), ((), 8, {})])
def test_fsdp_spec_matches_jax(case):
    """tests/test_fsdp.py's spec cases, each against JAX's fsdp_spec."""
    from imageretrievalresearch_tpu.parallel import fsdp_spec as jax_spec
    shape, n, kw = case
    assert fsdp_spec(shape, n, **kw) == tuple(jax_spec(shape, n, **kw))


class _Loader:
    def __init__(self, seed, n=2, b=8):
        rng = np.random.default_rng(seed)
        self.batches = [_batch(rng, b) for _ in range(n)]

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)

    def set_epoch(self, epoch):
        pass


def test_trainer_fsdp_fit_and_resume_in_a_group(group, tmp_path):
    """tests/test_fsdp.py's Trainer integration at one rank: the state is
    sharded as fsdp_spec says, fit runs, and resume restores the
    checkpoint's values sharded again."""
    from torch.distributed.tensor import DTensor, Shard

    cfg = _cfg(batch_size=8, param_sharding="fsdp", max_epochs=1,
               checkpoint_dir=str(tmp_path / "ckpt"))
    bb = create_model("efficientnet_b0", **MODEL, device="cpu", seed=0)
    tr = Trainer(cfg, bb, _Loader(0), transform=identity)
    state = tr.init_state()

    def check_layout(model):
        for name, p in model.named_parameters():
            spec = fsdp_spec(p.shape, 1)
            assert isinstance(p, DTensor), name
            assert p.placements == (Shard(spec.index("data") if spec
                                          else 0),), name
    check_layout(state.model)
    state, hist = tr.fit(state, max_epochs=1)
    assert np.isfinite(hist["epochs"][0]["train_loss"])
    saved = CheckpointManager(cfg.checkpoint_dir, monitor="train_loss",
                              mode="min").restore(2)
    assert not any(k.startswith("module.") for k in saved["model"])
    state2, _ = tr.fit(resume=True, max_epochs=1)
    assert state2.step == 2
    check_layout(state2.model)
    for k, v in state2.state_dict()["model"].items():
        assert torch.equal(v, saved["model"][k]), k


def test_ddp_checkpoint_loads_into_an_unwrapped_model(group, tmp_path):
    """A checkpoint of a DDP-wrapped run holds the model's own keys: it
    loads into a model and an optimizer on one card, without a group."""
    cfg = _cfg(batch_size=8, max_epochs=1,
               checkpoint_dir=str(tmp_path / "ckpt"))
    bb = create_model("efficientnet_b0", **MODEL, device="cpu", seed=0)
    tr = Trainer(cfg, bb, _Loader(1), transform=identity)
    assert isinstance(tr.model, torch.nn.parallel.DistributedDataParallel)
    state, _ = tr.fit(max_epochs=1)
    saved = tr.ckpt.restore(tr.ckpt.latest_step())
    fresh = create_model("efficientnet_b0", **MODEL, device="cpu", seed=9)
    fresh.load_state_dict(saved["model"])
    for k, v in bb.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    one = TrainState(fresh, torch.optim.AdamW(fresh.parameters()))
    one.load_state_dict(saved)
    assert one.step == state.step == 2


# ---------------------------------------------------------------------------
# the CLI across processes (slow, as tests/test_multihost.py)
# ---------------------------------------------------------------------------

_CLI = r"""
import sys
from imageretrievalresearch_tpu_torch.cli import train
_, hist = train.run(train.build_parser().parse_args(sys.argv[1:]))
last = hist["epochs"][-1]
print(f"FINAL_LOSS {last['train_loss']:.9g}", flush=True)
"""


@pytest.mark.slow
def test_cli_two_processes_match_one(tmp_path):
    """Two processes x cli.train over the multi-host flags give one
    process's training loss: each loads its slice of every batch, and
    the group-wide BatchNorm, the loss mean and the draws cover the
    global batch. SGD: Adam's sign-like first updates turn the two
    layouts' rounding differences into full-size steps, which the epoch's
    later losses carry (2e-4 apart after one epoch here, 1e-5 with
    SGD)."""
    from imageretrievalresearch_tpu_torch.data.synthetic import (
        make_sketchy_tree,
    )
    tree = make_sketchy_tree(str(tmp_path / "sk"), n_cats=3, n_prods=1,
                             n_photos=8, n_sketches=4, size=32)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}

    def start(save, extra):
        return subprocess.Popen(
            [sys.executable, "-c", _CLI, "--ims_path", tree, "-mn",
             "efficientnet_b0", "-bs", "8", "--image_size", "32",
             "--max_epochs", "1", "--compute_dtype", "float32",
             "--num_workers", "2", "--device", "cpu", "-on", "SGD", "-sp",
             str(tmp_path / save), *extra], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def loss(out):
        return float(next(line.split()[1] for line in out.splitlines()
                          if line.startswith("FINAL_LOSS")))

    procs = [start("multi", ["--coordinator_address", f"localhost:{port}",
                             "--num_processes", "2", "--process_id",
                             str(i)]) for i in range(2)]
    outs = [p.communicate(timeout=540) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, (so, se)
    single = start("single", [])
    so, se = single.communicate(timeout=540)
    assert single.returncode == 0, (so, se)
    assert loss(outs[0][0]) == pytest.approx(loss(outs[1][0]), rel=1e-6)
    assert loss(outs[0][0]) == pytest.approx(loss(so), rel=1e-4)
