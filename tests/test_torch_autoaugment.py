"""The port's AutoAugment (``ops/autoaugment.py``) and its training
transforms held against the JAX package on the CPU: the per-image ops,
the batched ops, both policy stages with the same draws, and
``build_batch_transform(train_autoaugment)`` end to end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu.ops import autoaugment as JA
from imageretrievalresearch_tpu.ops import preprocess as JP
from imageretrievalresearch_tpu_torch.ops import autoaugment as TA
from imageretrievalresearch_tpu_torch.ops import preprocess as TP


def _both(rng, shape=(4, 32, 40, 3), lo=0, hi=256):
    imgs = rng.integers(lo, hi, shape, dtype=np.uint8)
    return imgs, jnp.asarray(imgs), torch.from_numpy(imgs)


def _diff(ours: torch.Tensor, ref) -> np.ndarray:
    assert ours.dtype == torch.uint8
    return np.abs(ours.numpy().astype(int) - np.asarray(ref).astype(int))


def _near(diff: np.ndarray) -> None:
    """±1 on rounding ties of another f32 grouping, on < 1e-3 of the
    pixels (the JAX package's own bound for its two shear forms)."""
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (
        diff.max(), (diff > 0).mean())


def _within_one(diff: np.ndarray) -> None:
    """Enhancement ops: ±1 (an f32 blend truncated to uint8)."""
    assert diff.max() <= 1, diff.max()


def _exact(diff: np.ndarray) -> None:
    assert diff.max() == 0, (diff.max(), (diff > 0).mean())


_ENH = [0.1, 0.55, 1.0, 1.9]
# per-image op -> (magnitudes of the four images, tolerance)
_OPS = {
    "op_invert": ([0, 0, 0, 0], _exact),
    "op_posterize": ([4, 5, 7, 8], _exact),
    "op_solarize": ([0, 57, 128, 256], _exact),
    "op_equalize": ([0, 0, 0, 0], _exact),
    "op_autocontrast": ([0, 0, 0, 0], _exact),
    "op_translate_x": ([-0.3, 0.15, 0.0, 0.45], _exact),
    "op_translate_y": ([-0.2, 0.4, 0.05, -0.45], _exact),
    "op_rotate": ([-30.0, -9.0, 3.33, 26.666666], _exact),
    "op_color": (_ENH, _within_one),
    "op_contrast": (_ENH, _within_one),
    "op_brightness": (_ENH, _within_one),
    "op_sharpness": (_ENH, _within_one),
    "op_shear_x": ([-0.3, -0.1, 0.1, 0.3], _near),
    "op_shear_y": ([-0.2, 0.25, 0.05, -0.3], _near),
}


@pytest.mark.parametrize("name", sorted(_OPS))
def test_per_image_op_matches_jax(rng, name):
    mags, check = _OPS[name]
    _, ji, ti = _both(rng)
    m = np.asarray(mags, np.float32)
    ref = jax.vmap(getattr(JA, name))(ji, jnp.asarray(m))
    check(_diff(getattr(TA, name)(ti, torch.from_numpy(m)), ref))


@pytest.mark.parametrize("case", ["random", "flat", "narrow"])
def test_batched_equalize_autocontrast_exact(rng, case):
    # flat: every channel one value (equalize's step == 0 branch and
    # autocontrast's hi == lo branch); narrow: a compressed range
    if case == "flat":
        imgs = np.broadcast_to(rng.integers(0, 256, (3, 1, 1, 3)),
                               (3, 24, 32, 3)).astype(np.uint8)
    else:
        imgs = _both(rng, (3, 24, 32, 3),
                     *((0, 256) if case == "random" else (90, 140)))[0]
    for name in ("batched_equalize", "batched_autocontrast"):
        ref = getattr(JA, name)(jnp.asarray(imgs))
        _exact(_diff(getattr(TA, name)(torch.from_numpy(imgs)), ref))


def test_batched_shear_x_matches_jax(rng):
    _, ji, ti = _both(rng)
    vm = np.array([-0.3, 0.05, 0.28, -0.1], np.float32)
    ref = JA.batched_shear_x(ji, jnp.asarray(vm))
    _near(_diff(TA.batched_shear_x(ti, torch.from_numpy(vm)), ref))


@pytest.mark.parametrize("degrees", [[30.0, -30.0, 26.666666, -10.0],
                                     [3.33, -9.0, 17.0, 0.0]])
def test_batched_rotate_matches_jax(rng, degrees):
    # the 3-shear rotate (the card's rotate) against JAX's, whose CPU form
    # is the same three integer row shifts as roll-selects
    _, ji, ti = _both(rng)
    dg = np.asarray(degrees, np.float32)
    ref = JA.batched_rotate(ji, jnp.asarray(dg))
    _exact(_diff(TA.batched_rotate(ti, torch.from_numpy(dg)), ref))


def _stage_draws(rng, op_set):
    """One image per selectable op (plus one that does not run), random
    magnitudes from the policy table's values, random signs."""
    b = len(op_set) + 1
    ops = np.array(list(op_set) + [op_set[0]], np.int32)
    mags = np.array([TA._MAGS[k, rng.integers(0, 10)] for k in ops],
                    np.float32)
    do = np.array([True] * (b - 1) + [False])
    sign = rng.choice([-1.0, 1.0], b).astype(np.float32)
    return ops, mags, do, sign


# JAX's stages are jitted here, and under jit XLA contracts the f32
# enhancement blend into FMAs (±1 on ~1 % of an image's pixels); the
# cubic shearX differs at rounding ties. Every other op is exact.
_APPROX_OPS = set(TA._ENH_OPS) | {TA.SHEAR_X}
_jax_stage = jax.jit(JA._apply_stage, static_argnums=5)


def _check_per_image(ours: torch.Tensor, ref, ops, do) -> None:
    """One stage: exact for images whose op is exact or did not run, else
    within ±1."""
    diff = _diff(ours, ref)
    for i in range(diff.shape[0]):
        approx = do[i] and int(ops[i]) in _APPROX_OPS
        (_within_one if approx else _exact)(diff[i])


@pytest.mark.parametrize("stage", [0, 1])
def test_apply_stage_matches_jax(rng, stage):
    op_set = TA._STAGE_OPS[stage]
    assert op_set == JA._STAGE_OPS[stage]
    draws = _stage_draws(rng, op_set)
    imgs, ji, ti = _both(rng, (len(draws[0]), 32, 32, 3))
    ref = _jax_stage(ji, *map(jnp.asarray, draws), op_set)
    ours = TA._apply_stage(ti, *map(torch.from_numpy, draws), op_set)
    _check_per_image(ours, ref, draws[0], draws[2])
    np.testing.assert_array_equal(ours.numpy()[-1], imgs[-1])


@pytest.mark.parametrize("src", [32, 48])
def test_batch_transform_end_to_end(rng, src):
    """train_autoaugment(32) on uint8 batches: the port's transform equals
    its pieces (resize, round to uint8, both stages with the draws its
    generator made, ToTensor), and each piece holds against JAX's on the
    same input. At 48 px the two f32 resizes differ by ulps
    (test_torch_preprocess), which moves pixels on a rounding tie by ±1."""
    _, ji, ti = _both(rng, (6, src, src, 3))
    fn = TP.build_batch_transform(TP.TransformSpec.train_autoaugment(32),
                                  device="cpu")
    ours = fn(ti, generator=torch.Generator().manual_seed(3))
    assert ours.dtype == torch.float32 and ours.shape == (6, 32, 32, 3)
    draws = TA.draw_policy(6, torch.Generator().manual_seed(3))
    x = ti
    if src != 32:
        x = torch.clamp(torch.round(TP.resize_bilinear(ti, (32, 32))), 0,
                        255).to(torch.uint8)
        _near(_diff(x, jnp.clip(jnp.round(JP.resize_bilinear(
            ji, (32, 32))), 0, 255).astype(jnp.uint8)))
    for s in (0, 1):
        stage = [d[:, s] for d in draws]
        out = TA._apply_stage(x, *stage, TA._STAGE_OPS[s])
        ref = _jax_stage(jnp.asarray(x.numpy()),
                         *(jnp.asarray(d.numpy()) for d in stage),
                         JA._STAGE_OPS[s])
        _check_per_image(out, ref, stage[0].numpy(), stage[2].numpy())
        x = out
    assert torch.equal(ours, x.float() / 255.0)


def test_policy_deterministic_per_seed(rng):
    _, _, ti = _both(rng, (6, 32, 32, 3))
    a, b, c = (TA.imagenet_policy_batch(ti, torch.Generator().manual_seed(s))
               for s in (7, 7, 8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    one = TA.imagenet_policy(ti[0], torch.Generator().manual_seed(7))
    assert one.shape == ti[0].shape and one.dtype == torch.uint8


def test_triplet_transform_draw_order_and_dtype(rng):
    """Roles draw from the one generator in the order qry, pos..., neg...:
    the same as the batch transform called role by role."""
    batch = {"qry": rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8),
             "pos": [rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
                     for _ in range(2)],
             "neg": [rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)],
             "cat_idx": np.arange(2)}
    spec = TP.TransformSpec(resize=(32, 32), autoaugment=True,
                            dtype="bfloat16")
    out = TP.build_triplet_transform(spec, spec, spec, device="cpu")(
        batch, generator=torch.Generator().manual_seed(5))
    one = TP.build_batch_transform(spec, device="cpu")
    gen = torch.Generator().manual_seed(5)
    for got, images in zip([out["qry"], *out["pos"], *out["neg"]],
                           [batch["qry"], *batch["pos"], *batch["neg"]]):
        assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
        assert torch.equal(got, one(images, generator=gen))
    np.testing.assert_array_equal(out["cat_idx"], batch["cat_idx"])


def test_autoaugment_requires_a_generator(rng):
    fn = TP.build_batch_transform(TP.TransformSpec.train_autoaugment(32),
                                  device="cpu")
    with pytest.raises(ValueError, match="requires a generator"):
        fn(_both(rng, (1, 32, 32, 3))[2])


def test_numpy_batches_default_to_the_card(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = TP.build_batch_transform(TP.TransformSpec.train_plain(32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(_both(rng, (1, 32, 32, 3))[0])


def test_cpu_tensors_default_to_the_card(rng, monkeypatch):
    """A CPU tensor with no device goes to the card like a numpy batch: no
    entry point runs the policy on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    images = _both(rng, (1, 32, 32, 3))[2]
    spec = TP.TransformSpec.train_autoaugment(32)
    calls = [lambda g: TP.build_batch_transform(spec)(images, g),
             lambda g: TP.build_image_transform(spec)({"image": images}, g),
             lambda g: TP.build_triplet_transform(spec, spec, spec)(
                 {"qry": images, "pos": [images], "neg": [images]}, g)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(torch.Generator().manual_seed(0))
