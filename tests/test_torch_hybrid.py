"""The 2-D ``(data, model)`` hybrid layout on the port against the JAX
package, on the CPU.

JAX's case (tests/test_fsdp.py::test_hybrid_2d_mesh_dp_x_weight_sharding)
puts the batch over ``data`` and the parameters and optimizer state over
``model`` of a (data=4, model=2) mesh, and holds one step against the
single-device step. The port's layout is FSDP2's HSDP over a ``(data,
model)`` DeviceMesh of a process group. One launch of 4 gloo ranks, a
(data=2, model=2) mesh (the port's launcher: fresh interpreters that
import this module by name), covers:

(i)   JAX's shrunken ``swin_s3_tiny_224`` (depths (1, 1), heads (3, 6),
      windows (8, 8), 64 px, 4 classes, SGD 1e-2, f32, batch 8) against
      JAX's single-device step from the same numpy weights and batch, at
      JAX's tolerances (loss rel 1e-4; parameters rtol 1e-3, atol 1e-6),
      each large parameter holding half its elements before and after;
(ii)  the shrunken b3a of tests/test_torch_train.py (grouped convs and
      BatchNorm: width 0.5, depth 0.1, 32 px, 5 classes, T3's cos_con_ce)
      the same (its parameters at tests/test_torch_train.py's limits for
      b3a against JAX, which the port's one-rank step needs too), against
      JAX's step and the port's one-rank step: the
      running means, the running variances (against JAX up to torch's
      unbiased factor n / (n - 1), n the global batch's rows; Flax keeps
      the biased variance) and the in-batch top-1 / top-3, which a
      collective over the whole group instead of the ``data`` sub-group
      would get wrong (its rows counted twice);
(iii) the AutoAugment draws: the ranks at one ``data`` index draw the same
      and keep their ``data`` row's rows.

The parameters come back through ``export_timm_state_dict``, which
gathers the FSDP shards whole. The JAX side runs in this process while
the ranks run. In-process cases need no group (a ``Mesh`` at each rank):
the mesh's shape and coordinates, ``shard_batch``'s placement,
``fsdp_spec`` over ``model`` against JAX's, and the refusals. This module
imports JAX only inside its tests: the ranks import it.
"""

import os
import threading

import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu_torch.config import TrainConfig
from imageretrievalresearch_tpu_torch.models import create_model
from imageretrievalresearch_tpu_torch.models.convert import (
    export_timm_state_dict,
    params_from_jax,
)
from imageretrievalresearch_tpu_torch.ops.preprocess import (
    TransformSpec,
    build_triplet_transform,
)
from imageretrievalresearch_tpu_torch.parallel import (
    Mesh,
    constrain_fsdp,
    distributed,
    fsdp_spec,
    group_mesh,
    put_fsdp,
    shard_batch,
)
from imageretrievalresearch_tpu_torch.train import (
    TrainState,
    Trainer,
    build_train_step,
    make_optimizer,
)

TESTS = os.path.dirname(os.path.abspath(__file__))
SHAPE, AXES = (2, 2), ("data", "model")
RANKS = 4
# (name, architecture, image size, classes, batch, config)
SWIN = ("swin_s3_tiny_224", dict(img_size=64, drop_path_rate=0.0,
                                 depths=(1, 1), num_heads=(3, 6),
                                 window_sizes=(8, 8)), 64, 4, 8, {})
B3A = ("efficientnet_b3a", dict(width_mult=0.5, depth_mult=0.1,
                                drop_rate=0.0), 32, 5, 8,
       dict(only_feature_embeddings=True, use_contrastive=True,
            cos_margin=0.3, con_margin=0.3))
CASES = {"swin": SWIN, "b3a": B3A}
LR = 1e-2


def _batch(rng, b, s, classes):
    return {"qry": rng.random((b, s, s, 3)).astype(np.float32),
            "pos": [rng.random((b, s, s, 3)).astype(np.float32)],
            "neg": [rng.random((b, s, s, 3)).astype(np.float32)],
            "cat_idx": rng.integers(0, classes, b).astype(np.int32),
            "prod_idx": rng.integers(0, classes, b).astype(np.int32)}


def _cfg(case):
    name, _, size, _, _, kw = CASES[case]
    return TrainConfig(model_name=name, image_size=size,
                       compute_dtype="float32", device="cpu",
                       optimizer_name="SGD", learning_rate=LR,
                       weight_decay=0.0, **kw)


def _model(case, weights):
    name, arch, _, classes, _, _ = CASES[case]
    model = create_model(name, num_classes=classes, device="cpu", seed=None,
                         **arch)
    model.load_timm_state_dict(weights)
    return model


def _step_batch(b):
    """A batch of numpy arrays or tensors as the steps take it: tensors,
    the labels int64."""
    def one(x):
        x = torch.as_tensor(x)
        return x.long() if x.dtype == torch.int32 else x
    return {k: [one(x) for x in v] if isinstance(v, list) else one(v)
            for k, v in b.items()}


def _step(case, model, batch, mesh=None):
    """One SGD train step; (metrics, the state)."""
    state = TrainState(model, make_optimizer("SGD", model.parameters(), LR,
                                             0.0))
    state, m = build_train_step(_cfg(case), mesh=mesh)(state, batch)
    return {k: float(v) for k, v in m.items()}, state


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _local_sizes(model) -> dict:
    return {n: (p.to_local().numel(), p.numel(), tuple(map(repr, p.placements)))
            for n, p in model.named_parameters()}


def _rank_main(p: dict) -> dict:
    """One rank of the (2, 2) launch: each case's step on this rank's rows
    of the global batch, and the draws."""
    torch.set_num_threads(1)
    mesh = group_mesh(SHAPE, AXES)
    out = {"coords": mesh.coords}
    for case in CASES:
        model = _model(case, p[case]["weights"])
        put_fsdp(mesh, model, axis_name="model")
        before = _local_sizes(model)
        local = _step_batch(shard_batch(mesh, p[case]["batch"]))
        local["rows"] = mesh.rows_of(len(local["qry"]))
        metrics, state = _step(case, model, local, mesh)
        constrain_fsdp(mesh, model, state.optimizer, axis_name="model")
        out[case] = {"metrics": metrics, "before": before,
                     "after": _local_sizes(model),
                     "sd": export_timm_state_dict(model)}
    raw = p["raw"]
    b = len(raw["qry"]) // SHAPE[0]
    d = mesh.coords["data"]
    mine = shard_batch(mesh, raw)
    mine = {k: ([x.numpy() for x in v] if isinstance(v, list) else v.numpy())
            for k, v in mine.items()}
    spec = TransformSpec.train_autoaugment(32)
    tf = build_triplet_transform(spec, spec, spec, device="cpu")
    aug = tf(mine, torch.Generator().manual_seed(5), rows=mesh.rows_of(b))
    assert mesh.rows_of(b) == (d * b, 2 * b)
    out["aug"] = {k: (v[0] if isinstance(v, list) else v).numpy()
                  for k, v in aug.items() if k in ("qry", "pos", "neg")}
    return out


# ---------------------------------------------------------------------------
# the JAX side and the launch, run together
# ---------------------------------------------------------------------------

def _jax_variables(bb, size, seed):
    """He-normal kernels, identity normalizations, small bias tables, in
    the init's shapes (flax's eager init is slow here)."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(bb.init, jax.random.key(0),
                            jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        key = path[-1].key
        if key == "kernel":
            fan_in = int(np.prod(x.shape[:-1]))
            v = rng.normal(0, np.sqrt(2.0 / fan_in), x.shape)
        elif key == "relative_position_bias_table":
            v = rng.normal(0, 0.02, x.shape)
        else:
            v = np.full(x.shape, float(key in ("scale", "var")))
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_step(case, bb, variables, batch):
    """JAX's single-device step (its test's): (metrics, new variables)."""
    import jax

    from imageretrievalresearch_tpu.config import TrainConfig as JC
    from imageretrievalresearch_tpu.train import (
        EmbedTrainState,
        build_train_step as jbuild,
        make_optimizer as jopt,
    )
    name, _, size, _, _, kw = CASES[case]
    cfg = JC(model_name=name, image_size=size, compute_dtype="float32", **kw)
    state = EmbedTrainState.from_backbone(bb, variables, jopt("SGD", LR, 0.0))
    new, m = jax.jit(jbuild(bb, cfg))(state, jax.tree.map(np.asarray, batch),
                                      jax.random.key(1))
    return jax.device_get(m), jax.device_get(new.backbone_variables())


@pytest.fixture(scope="module")
def launched():
    from imageretrievalresearch_tpu.models import create_model as jcreate

    rng = np.random.default_rng(42)
    payload, jax_models = {}, {}
    for i, (case, (name, arch, size, classes, b, _)) in enumerate(
            CASES.items()):
        bb = jcreate(name, num_classes=classes, **arch)
        variables = _jax_variables(bb, size, seed=i)
        port = create_model(name, num_classes=classes, device="cpu",
                            seed=None, **arch)
        payload[case] = {"weights": params_from_jax(variables, port),
                         "batch": _batch(rng, b, size, classes)}
        jax_models[case] = (bb, variables)
    payload["raw"] = {k: ([rng.integers(0, 256, (4, 40, 40, 3), np.uint8)]
                          if k in ("pos", "neg") else
                          rng.integers(0, 256, (4, 40, 40, 3), np.uint8))
                      for k in ("qry", "pos", "neg")}
    box = {}

    def go():
        try:
            box["ranks"] = distributed.launch(
                "test_torch_hybrid:_rank_main", RANKS, payload,
                devices=["cpu"] * RANKS, env={"PYTHONPATH": TESTS},
                timeout_s=300)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["error"] = e

    t = threading.Thread(target=go)
    t.start()
    jax_runs = {case: _jax_step(case, *jax_models[case],
                                payload[case]["batch"]) for case in CASES}
    one = {}
    for case in CASES:
        model = _model(case, payload[case]["weights"])
        rows = _bn_rows(model, _step_batch(payload[case]["batch"]))
        m, state = _step(case, model, _step_batch(payload[case]["batch"]))
        one[case] = {"metrics": m, "sd": export_timm_state_dict(model),
                     "bn_rows": rows}
    t.join()
    if "error" in box:
        raise box["error"]
    return {"ranks": box["ranks"], "jax": jax_runs, "one": one,
            "payload": payload}


def _bn_rows(model, batch) -> dict:
    """Rows each BatchNorm normalizes over in one train pass of the whole
    batch, by timm key prefix."""
    import copy

    from imageretrievalresearch_tpu_torch.train import steps as S
    rows, hooks = {}, []
    model = copy.deepcopy(model)
    for name, m in model.net.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp, name=name: rows.__setitem__(
                    name, inp[0].numel() // inp[0].shape[1])))
    with torch.no_grad():
        S._forward_triplet(model, batch, True, None)
    for h in hooks:
        h.remove()
    return rows


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def _same_on_every_rank(launched, case):
    ranks = launched["ranks"]
    for r in ranks[1:]:
        assert r[case]["metrics"] == ranks[0][case]["metrics"]
        for k, v in ranks[0][case]["sd"].items():
            assert torch.equal(r[case]["sd"][k], v), k
    return ranks[0][case]


@pytest.mark.parametrize("case", list(CASES))
def test_hybrid_step_matches_jax_single_device_step(launched, case):
    """(i), (ii): the (2, 2) step against JAX's single-device step: the
    loss (rel 1e-4) and the in-batch top-1 / top-3; every parameter (the
    ranks hold the same values): Swin's at JAX's rtol 1e-3, atol 1e-6,
    b3a's at tests/test_torch_train.py's limits (each tensor within 5% of
    its largest update, all within 1e-3 of the update's norm); with
    BatchNorm the running means and the running variances (n / (n - 1) x
    Flax's update)."""
    got = _same_on_every_rank(launched, case)
    jm, jvars = launched["jax"][case]
    assert got["metrics"]["train_loss"] == pytest.approx(
        float(jm["train_loss"]), rel=1e-4)
    for k in ("train_top3", "train_top1"):
        assert got["metrics"][k] == pytest.approx(float(jm[k]), abs=1e-6), k
    want = params_from_jax(jvars, _model(case, launched["payload"][case][
        "weights"]))
    v0 = launched["payload"][case]["weights"]
    rows = launched["one"][case]["bn_rows"]
    assert set(got["sd"]) == set(want)
    n_stats = 0
    diff2 = upd2 = 0.0
    for k, w in want.items():
        mine = got["sd"][k]
        if k.endswith("num_batches_tracked"):
            assert int(mine) == 1, k
        elif k.endswith("running_var"):
            n = rows[k[:-len(".running_var")]]
            base = 0.9 * v0[k].double()
            _close(mine.double() - base, (w.double() - base) * n / (n - 1),
                   1e-4, 1e-5, k)
            n_stats += 1
        elif k.endswith("running_mean"):
            _close(mine, w, 1e-4, 1e-5, k)
        elif case == "swin":
            _close(mine, w, 1e-3, 1e-6, k)
        else:
            # tests/test_torch_train.py's limits for b3a against JAX: the
            # port's own one-rank step is up to 1.6x past JAX's
            # elementwise limit at the stem (7e-6 of updates of 0.7)
            upd = w.double() - v0[k].double()
            diff = mine.double() - w.double()
            assert diff.abs().max() <= 0.05 * upd.abs().max() + 1e-6, k
            diff2 += float(diff.square().sum())
            upd2 += float(upd.square().sum())
    assert diff2 ** 0.5 <= 1e-3 * upd2 ** 0.5
    assert n_stats == len(rows) and (n_stats > 10) == (case == "b3a")


@pytest.mark.parametrize("case", list(CASES))
def test_hybrid_step_matches_one_rank_step(launched, case):
    """The (2, 2) step against the port's step on one rank over the whole
    batch: the loss (rel 1e-5), the in-batch top-1 / top-3 (equal), the
    parameters (rtol 1e-3, atol 1e-6: the group-wide BatchNorm sums in
    another order) and the BatchNorm running statistics (rtol 1e-5)."""
    got = _same_on_every_rank(launched, case)
    one = launched["one"][case]
    assert got["metrics"]["train_loss"] == pytest.approx(
        one["metrics"]["train_loss"], rel=1e-5)
    for k in ("train_top3", "train_top1"):
        assert got["metrics"][k] == one["metrics"][k], k
    for k, w in one["sd"].items():
        if k.endswith(("running_mean", "running_var")):
            _close(got["sd"][k], w, 1e-5, 1e-6, k)
        elif not k.endswith("num_batches_tracked"):
            _close(got["sd"][k], w, 1e-3, 1e-6, k)


@pytest.mark.parametrize("case", list(CASES))
def test_large_parameters_are_half_sized_over_model(launched, case):
    """Each parameter that fsdp_spec shards over the 2-wide ``model`` axis
    holds half its elements on every rank, before and after the step,
    replicated over ``data`` and sharded on fsdp_spec's dim over
    ``model``."""
    model = _model(case, launched["payload"][case]["weights"])
    for rank in launched["ranks"]:
        sizes = rank[case]
        big = 0
        for name, (local, total, placements) in sizes["before"].items():
            assert sizes["after"][name] == (local, total, placements), name
            spec = fsdp_spec(model.get_parameter(name).shape, 2, "model")
            dim = spec.index("model") if spec else 0
            assert placements == ("Replicate()", f"Shard(dim={dim})"), name
            if spec:
                assert local == total // 2, name
                big += 1
        assert big >= 3


def test_draws_follow_the_data_row(launched):
    """(iii) Each rank's AutoAugment rows equal its data row's rows of the
    one-rank transform, bitwise: the ranks at one data index draw alike."""
    raw = launched["payload"]["raw"]
    spec = TransformSpec.train_autoaugment(32)
    tf = build_triplet_transform(spec, spec, spec, device="cpu")
    full = tf(raw, torch.Generator().manual_seed(5))
    b = len(raw["qry"]) // SHAPE[0]
    for rank in launched["ranks"]:
        d = rank["coords"]["data"]
        for k in ("qry", "pos", "neg"):
            want = full[k][0] if k != "qry" else full[k]
            np.testing.assert_array_equal(rank["aug"][k],
                                          want[d * b:(d + 1) * b])
    assert [r["coords"] for r in launched["ranks"]] == [
        {"data": r // 2, "model": r % 2} for r in range(RANKS)]


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------

def test_mesh_shape_and_coordinates():
    """A (data, model) mesh lays its ranks out row-major, as JAX's
    ``devices.reshape(data, model)``; a one-axis mesh is unchanged."""
    meshes = [Mesh(["cpu"] * 6, AXES, (3, 2), rank=r) for r in range(6)]
    assert meshes[0].shape == {"data": 3, "model": 2}
    assert [m.coords for m in meshes] == [
        {"data": r // 2, "model": r % 2} for r in range(6)]
    assert [m.rows_of(4) for m in meshes] == [
        (4 * (r // 2), 12) for r in range(6)]
    one = Mesh(["cpu"] * 3, rank=1)
    assert one.shape == {"data": 3} and one.rows_of(4) == (4, 12)
    assert one.batch_group is None and meshes[0].batch_group is None
    assert Mesh(["cpu"] * 3).shape == {"data": 3}
    for bad in (dict(shape=(2, 2)), dict(shape=(3,))):
        with pytest.raises(ValueError):
            Mesh(["cpu"] * 6, AXES[:len(bad["shape"])], **bad, rank=0)
    with pytest.raises(ValueError, match="one axis"):
        Mesh(["cpu"] * 4, AXES, (2, 2))


def test_shard_batch_splits_over_data_and_keeps_model_whole():
    """Rank (d, m) of a (2, 2) mesh takes data row d of the global batch,
    the same rows for both m."""
    batch = {"x": np.arange(8 * 3).reshape(8, 3),
             "pos": [np.arange(8)]}
    for r in range(RANKS):
        mesh = Mesh(["cpu"] * RANKS, AXES, SHAPE, rank=r)
        got = shard_batch(mesh, batch)
        d = r // 2
        np.testing.assert_array_equal(got["x"].numpy(),
                                      batch["x"][4 * d:4 * (d + 1)])
        np.testing.assert_array_equal(got["pos"][0].numpy(),
                                      batch["pos"][0][4 * d:4 * (d + 1)])


@pytest.mark.parametrize("shape,n,kw", [
    ((64,), 2, {}), ((9001, 3), 2, {"min_elems": 1}),
    ((16, 4096), 2, {"min_elems": 1}), ((96, 288), 2, {}),
    ((3, 3, 256, 256), 4, {"min_elems": 1}), ((999, 256), 2, {}),
    ((), 2, {})])
def test_fsdp_spec_over_model_matches_jax(shape, n, kw):
    """fsdp_spec with axis_name='model' against JAX's."""
    from imageretrievalresearch_tpu.parallel import fsdp_spec as jax_spec
    assert fsdp_spec(shape, n, "model", **kw) == tuple(
        jax_spec(shape, n, "model", **kw))


def test_fsdp_over_data_on_a_2d_mesh_is_refused():
    """FSDP2 shards over its mesh's last dim: on a (data, model) mesh the
    parameters go over 'model'; 'data' there is refused with a message,
    before anything is sharded."""
    model = create_model("efficientnet_b0", num_classes=4, width_mult=0.25,
                         depth_mult=0.1, device="cpu", seed=0)
    mesh = Mesh(["cpu"] * RANKS, AXES, SHAPE, rank=0)
    with pytest.raises(ValueError, match="not over 'data'"):
        put_fsdp(mesh, model, axis_name="data")
    assert not any(type(p).__name__ == "DTensor" for p in model.parameters())


def test_trainer_refuses_a_2d_mesh_and_model_name_is_accepted():
    """The Trainer builds one-axis meshes, as JAX's; a (1, 1) mesh of a
    group of one has its DeviceMesh and sub-groups, and put_fsdp takes
    JAX's model_name= for a grouped-conv family."""
    distributed.init_group(
        world_size=1, rank=0, device="cpu",
        init_method=f"tcp://localhost:{distributed.free_port()}")
    try:
        mesh = group_mesh((1, 1), AXES)
        assert mesh.device_mesh.shape == (1, 1)
        assert torch.distributed.get_world_size(mesh.batch_group) == 1
        model = create_model("efficientnet_b0", num_classes=4,
                             width_mult=0.25, depth_mult=0.1, device="cpu",
                             seed=0)
        with pytest.raises(ValueError, match="one-axis"):
            Trainer(TrainConfig(model_name="efficientnet_b0",
                                device="cpu"), model, [], mesh=mesh)
        put_fsdp(mesh, model, axis_name="model",
                 model_name="efficientnet_b3a")
        constrain_fsdp(mesh, model, axis_name="model",
                       model_name="efficientnet_b3a")
    finally:
        distributed.destroy_group()
