"""The port's RexNet, Swin, ResNe(X)t and DarkNet held against the JAX
forward on the CPU, with the JAX weights carried across by
``params_from_jax``; their full-size state dicts against the frozen timm
manifests; the registry, the recipes' models and the checkpoint paths of
every family; the depthwise planner at RexNet-150's layers.

Sizes of the parity cases (written out, each JAX compile a few seconds):
RexNet at width 0.5, depth 0.5 (10 blocks, depthwise widths 32, 96, 150,
204, 258, 312, 366, 420, 474, 528: seven with C % 8 != 0), 32 px; Swin at
embed_dim 32, depths (2, 2, 2), heads (2, 4, 8), windows (4, 4, 4) at 32
px (8 x 8 tokens: a shifted window with its mask, then 4 x 4 and 2 x 2,
where the window clamps to the resolution) and 40 px (10 x 10 tokens
padded to 12 x 12, then the odd 5 x 5 grid padded to 8 x 8 and merged
into 3 x 3, where the window clamps); ResNeXt with one Bottleneck per
stage, 4 groups of width 16 per 64 planes, 32 px; DarkNet at width 0.25
with depths (1, 1, 1), 32 px, behind the ``conv_input`` stem."""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu.models import create_model as jax_create
from imageretrievalresearch_tpu.models import list_models as jax_list_models
from imageretrievalresearch_tpu.ops.pallas_conv import depthwise_conv2d
from imageretrievalresearch_tpu_torch.config import TrainConfig
from imageretrievalresearch_tpu_torch.models import create_model
from imageretrievalresearch_tpu_torch.models.convert import (
    load_checkpoint,
    params_from_jax,
)
from imageretrievalresearch_tpu_torch.models.layers import DepthwiseConv2d
from imageretrievalresearch_tpu_torch.ops import _cuda
from imageretrievalresearch_tpu_torch.ops import depthwise as DW
from imageretrievalresearch_tpu_torch.recipes import make_config

GOLDEN = Path(__file__).resolve().parent / "golden"
N_CLS = 7
SWIN = dict(embed_dim=32, depths=(2, 2, 2), num_heads=(2, 4, 8),
            window_sizes=(4, 4, 4))
# (id, registry name, architecture overrides, image size, conv_input)
CASES = [
    ("rexnet", "rexnet_100", dict(width_mult=0.5, depth_mult=0.5), 32,
     False),
    ("swin32", "swin_tiny_patch4_window7_224", dict(img_size=32, **SWIN), 32,
     False),
    ("swin40", "swin_tiny_patch4_window7_224", dict(img_size=40, **SWIN), 40,
     False),
    ("resnext", "resnext50_32x4d",
     dict(layers=(1, 1, 1, 1), groups=4, base_width=16), 32, False),
    ("darknet", "darknet53", dict(depths=(1, 1, 1), width_mult=0.25), 32,
     True),
]
# RexNet-150's depthwise layers at 224 px: (C, H, W, K, stride)
REXNET_150_DW = [
    (48, 112, 112, 3, 1), (144, 112, 112, 3, 2), (246, 56, 56, 3, 1),
    (348, 56, 56, 3, 2), (450, 28, 28, 3, 1), (552, 28, 28, 3, 2),
    (648, 14, 14, 3, 1), (750, 14, 14, 3, 1), (852, 14, 14, 3, 1),
    (954, 14, 14, 3, 1), (1056, 14, 14, 3, 1), (1158, 14, 14, 3, 2),
    (1260, 7, 7, 3, 1), (1356, 7, 7, 3, 1), (1458, 7, 7, 3, 1),
    (1560, 7, 7, 3, 1)]
# a T1 step's depthwise batch: 32 triplets, three roles
T1_N = 96
H100_SMS = 132


def _jax_variables(bb, size, conv_input=False, seed=0):
    """JAX variables with every leaf drawn from numpy: He-scale kernels,
    non-trivial BatchNorm and LayerNorm parameters and statistics."""
    variables = jax.eval_shape(bb.init, jax.random.key(0),
                               jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        key = path[-1].key
        if key == "kernel":
            fan_in = int(np.prod(x.shape[:-1]))
            return rng.normal(0, np.sqrt(2.0 / fan_in), x.shape)
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape)
        return rng.normal(0, 0.1, x.shape)     # bias, mean, bias tables

    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(leaf(p, x), jnp.float32), variables)


def _pair(name, kw, size, conv_input=False, **port_kw):
    """(JAX backbone, its variables, the port's model with them)."""
    bb = jax_create(name, num_classes=N_CLS, conv_input=conv_input, **kw)
    variables = _jax_variables(bb, size, conv_input)
    port = create_model(name, num_classes=N_CLS, conv_input=conv_input,
                        device="cpu", seed=None, **kw, **port_kw)
    port.load_timm_state_dict(params_from_jax(variables, port))
    return bb, variables, port


def _images(size, n=2, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_forwards():
    """Each case's JAX features, embedding and logits (one jit each)."""
    out = {}
    for cid, name, kw, size, stem in CASES:
        bb, variables, _ = _pair(name, kw, size, stem)
        x = _images(size)

        @jax.jit
        def forward(v, xx, bb=bb):
            fm = bb.forward_features(v, xx)
            return fm, bb.embed(v, xx), bb.head(v, fm)

        out[cid] = (x, *map(np.asarray, forward(variables, jnp.asarray(x))))
    return out


@pytest.mark.parametrize("cid,name,kw,size,stem", CASES,
                         ids=[c[0] for c in CASES])
def test_features_embedding_and_logits_match_jax(jax_forwards, cid, name,
                                                 kw, size, stem):
    x, ref_fm, ref_emb, ref_logits = jax_forwards[cid]
    _, _, port = _pair(name, kw, size, stem)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        fm = port.forward_features(xt).numpy()
        emb = port.embed(xt).numpy()
        logits = port(xt).numpy()
    assert fm.shape == ref_fm.shape     # NHWC maps, Swin's (B, L, C)
    assert np.abs(ref_emb).max() > 1e-2
    np.testing.assert_allclose(fm, ref_fm, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(emb, ref_emb, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits, ref_logits, rtol=1e-4, atol=1e-4)


def test_rexnet_depthwise_opt_in_matches_jax(jax_forwards, monkeypatch):
    """With IRT_FORCE_PALLAS_DW set, RexNet's depthwise layers run the
    kernels' plain versions (CPU tensors), widths with C % 8 != 0
    included, reached as channels-last views (no layout copy)."""
    cid, name, kw, size, stem = CASES[0]
    x, ref_fm, ref_emb, ref_logits = jax_forwards[cid]
    _, _, port = _pair(name, kw, size, stem)
    widths = [m.in_channels for m in port.modules()
              if isinstance(m, DepthwiseConv2d)]
    assert widths == [32, 96, 150, 204, 258, 312, 366, 420, 474, 528]
    monkeypatch.setenv("IRT_FORCE_PALLAS_DW", "1")

    def no_grouped_conv(*args):
        raise AssertionError("the grouped conv ran with the opt-in set")

    monkeypatch.setattr(DepthwiseConv2d, "_conv_forward", no_grouped_conv)
    with _cuda.ledger() as recorded, torch.no_grad():
        logits = port(torch.from_numpy(x)).numpy()
    assert not recorded
    np.testing.assert_allclose(logits, ref_logits, rtol=1e-4, atol=1e-4)


def _bn_rows(model, x) -> dict:
    """Rows each BatchNorm normalizes over in one train pass, by module
    name (SE's BatchNorm: one per image)."""
    rows, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp, name=name: rows.__setitem__(
                    name, inp[0].numel() // inp[0].shape[1])))
    with torch.no_grad():
        model.features_and_logits(x, train=True)
    for h in hooks:
        h.remove()
    return rows


def test_rexnet_train_mode_pass_and_running_stats_match_jax():
    """One train-mode pass over 8 images of 48 px (no dropout): the
    embedding and logits on batch statistics agree, and so do the running
    means of every BatchNorm, SE's included. The running variances differ
    by torch's unbiased update: at momentum 0.1, v - 0.9 v0 = n / (n - 1)
    x (flax's v - 0.9 v0), n the rows a layer normalizes over (8 for
    SE's). (At 32 px over 4 images, BatchNorm over 4 values at the 1 x 1
    maps amplifies f32 rounding past 1e-4 in a few embedding elements.)"""
    kw = dict(width_mult=0.5, depth_mult=0.5, drop_rate=0.0)
    bb, variables, port = _pair("rexnet_100", kw, 48)
    x = _images(48, n=8, seed=2)
    emb, logits, upd = jax.jit(lambda v, xx: bb.features_and_logits(
        v, xx, train=True, mutable=True))(variables, jnp.asarray(x))
    want = params_from_jax(bb.merge_updates(variables, upd), port)
    v0 = {k: v.clone() for k, v in port.net.state_dict().items()}
    rows = _bn_rows(port, torch.from_numpy(x))
    port.load_state_dict({f"net.{k}": v for k, v in v0.items()})
    with torch.no_grad():
        got_emb, got_logits = port.features_and_logits(torch.from_numpy(x),
                                                       train=True)
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(emb), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits),
                               rtol=1e-4, atol=1e-4)
    got = port.net.state_dict()
    se = [n for n in rows if ".se." in n]
    assert se and all(rows[n] == len(x) for n in se)
    for name, n in rows.items():
        key = name[len("net."):]
        np.testing.assert_allclose(got[f"{key}.running_mean"].numpy(),
                                   want[f"{key}.running_mean"].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=key)
        base = 0.9 * v0[f"{key}.running_var"].double()
        flax = want[f"{key}.running_var"].double() - base
        ours = got[f"{key}.running_var"].double() - base
        np.testing.assert_allclose(ours.numpy(), (flax * n / (n - 1)).numpy(),
                                   rtol=2e-4, atol=1e-5, err_msg=key)
    assert len(rows) == len([k for k in got if k.endswith("running_var")])


@pytest.mark.parametrize("name", ["rexnet_150", "rexnet_200",
                                  "swin_s3_tiny_224", "swin_s3_small_224",
                                  "swin_s3_base_224", "resnet50",
                                  "darknet53"])
def test_full_size_state_dict_equals_the_golden_manifest(name):
    model = create_model(name, device="meta", seed=None)
    got = {k: list(v.shape) for k, v in model.net.state_dict().items()}
    golden = json.loads((GOLDEN / f"{name}.keys.json").read_text())
    assert got == {k: list(v) for k, v in golden.items()}


@pytest.mark.parametrize("name", jax_list_models())
def test_every_jax_registry_name_builds(name):
    """The same names, and each model's embedding width equals JAX's."""
    model = create_model(name, device="meta", seed=None)
    assert model.num_features == jax_create(name).num_features


def test_embedding_widths_of_the_recipes_models():
    widths = {name: create_model(name, device="meta", seed=None).num_features
              for name in ("rexnet_150", "swin_s3_base_224", "resnet50",
                           "darknet53")}
    assert widths == {"rexnet_150": 1920, "swin_s3_base_224": 768,
                      "resnet50": 2048, "darknet53": 1024}


@pytest.mark.parametrize("recipe", [None, "train", "find_lr",
                                    "train_vit_triplet",
                                    "train_vit_crossentropy"])
def test_default_config_and_recipes_build_their_models(recipe):
    cfg = TrainConfig() if recipe is None else make_config(recipe)
    model = create_model(cfg.model_name, num_classes=125, device="meta",
                         seed=None)
    assert model.name == cfg.model_name


def _small_swin(seed):
    return create_model("swin_tiny_patch4_window7_224", num_classes=N_CLS,
                        img_size=32, device="cpu", seed=seed, **SWIN)


def test_swin_buffers_stay_out_of_the_state_dict_and_are_dropped_on_load():
    """The index and masks are non-persistent buffers (the manifests have
    neither); a timm 0.4.12 dict that carries them loads, and any other
    extra key is refused."""
    src, model = _small_swin(1), _small_swin(2)
    sd = src.net.state_dict()
    assert not any(k.endswith(("relative_position_index", "attn_mask"))
                   for k in sd)
    blk = src.net.layers[0].blocks[1]
    assert blk.attn_mask is not None and blk.attn_mask.shape == (4, 16, 16)
    timm_sd = dict(sd)
    for name, buf in src.net.named_buffers():
        timm_sd[name] = buf.clone()
    assert any(k.endswith("attn_mask") for k in timm_sd)
    model.load_timm_state_dict(timm_sd)
    for k, v in sd.items():
        torch.testing.assert_close(model.net.state_dict()[k], v, rtol=0,
                                   atol=0)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        model.load_timm_state_dict({**timm_sd,
                                    "layers.0.extra": sd["norm.weight"]})


def test_swin_softmax_runs_in_float32_under_bf16_autocast(monkeypatch):
    """Autocast gives the projections bf16; the attention softmax still
    takes float32 scores (JAX's ``astype(jnp.float32)``)."""
    model, seen = _small_swin(0), []
    softmax = torch.softmax

    def spy(x, *args, **kwargs):
        seen.append(x.dtype)
        return softmax(x, *args, **kwargs)

    monkeypatch.setattr(torch, "softmax", spy)
    qkv = []
    model.net.layers[0].blocks[0].attn.qkv.register_forward_hook(
        lambda mod, inp, out: qkv.append(out.dtype))
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        emb = model.embed(torch.rand((2, 32, 32, 3)))
    assert qkv == [torch.bfloat16]
    assert len(seen) == sum(SWIN["depths"]) and set(seen) == {torch.float32}
    assert torch.isfinite(emb).all()


def test_swin_refuses_another_input_size():
    """At 40 px the last stage's 3 x 3 grid needs a window of 3, but the
    Swin built at 32 px has that stage's bias table for 2 (its 2 x 2
    grid): refused, as JAX refuses a parameter of another shape."""
    with pytest.raises(ValueError, match="bias table is for 2"):
        _small_swin(0).embed(torch.zeros((1, 40, 40, 3)))


# windows (4, 4, 2) clamp to the same widths at 32, 36 and 40 px, so one
# set of bias tables serves all three: at 32 px 8 x 8 tokens (shifted
# windows of 4), then 4 x 4 and 2 x 2 (clamped, no shift); at 40 px 10 x
# 10 padded to 12 x 12, then 5 x 5 shifted and padded to 8 x 8, then the
# odd grid merged into 3 x 3 (windows of 2, shifted, padded to 4 x 4); at
# 36 px 9 x 9 (not a window multiple, padded to 12 x 12, odd before the
# first merge) and then as at 40 px
SWIN_ANY = dict(embed_dim=32, depths=(2, 2, 2), num_heads=(2, 4, 8),
                window_sizes=(4, 4, 2))


@pytest.mark.parametrize("size", [40, 36])
def test_swin_built_at_32_px_runs_at_other_sizes_like_jax(size):
    name, kw = "swin_tiny_patch4_window7_224", dict(img_size=32, **SWIN_ANY)
    bb, variables, port = _pair(name, kw, 32)
    x = _images(size)
    ref = np.asarray(jax.jit(bb.embed)(variables, jnp.asarray(x)))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        emb = port.embed(xt).numpy()
        # the mask of this size is built once and reused
        assert torch.equal(port.embed(xt), torch.from_numpy(emb))
        at_32 = port.embed(torch.from_numpy(_images(32))).numpy()
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(emb, ref, rtol=1e-4, atol=1e-4)
    assert at_32.shape == emb.shape and np.isfinite(at_32).all()


@pytest.mark.parametrize("cid", [c[0] for c in CASES if c[0] != "swin40"])
def test_load_checkpoint_lightning_file_every_family(tmp_path, cid):
    """A Lightning file of each family ({"state_dict": {"model.<timm
    key>": ...}}, Swin's with timm's buffers) loads into a fresh model."""
    _, name, kw, size, stem = next(c for c in CASES if c[0] == cid)

    def model(seed):
        return create_model(name, num_classes=N_CLS, conv_input=stem,
                            device="cpu", seed=seed, **kw)

    src, dst = model(1), model(2)
    sd = dict(src.net.state_dict())
    if cid.startswith("swin"):
        sd.update(dict(src.net.named_buffers()))
    sd = ({"0.0.weight": src.stem.conv.weight.detach(),
           **{f"1.{k}": v for k, v in sd.items()}} if stem else sd)
    path = tmp_path / "ckpt.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()}},
               path)
    load_checkpoint(str(path), dst)
    for (k, a), b in zip(src.state_dict().items(),
                         dst.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)


def test_rexnet_150_depthwise_shapes():
    """The 16 depthwise layers of the full-size model at 224 px."""
    model = create_model("rexnet_150", device="meta", seed=None)
    shapes, hooks = [], []
    for m in model.modules():
        if isinstance(m, DepthwiseConv2d):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp: shapes.append(
                    (mod.in_channels, inp[0].shape[2], inp[0].shape[3],
                     mod.kernel_size[0], mod.stride[0]))))
    model.embed(torch.zeros((1, 224, 224, 3), device="meta"))
    assert shapes == REXNET_150_DW
    assert sum(c % 8 != 0 for c, *_ in shapes) == 10


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", REXNET_150_DW,
                         ids=[f"C{s[0]}_H{s[1]}_s{s[4]}"
                              for s in REXNET_150_DW])
def test_band_plans_at_rexnet_150_layers(shape, itemsize):
    """Each kernel's plan at a T1 step's batch (N = 96): within
    ``BAND_SMEM``, blocks of a multiple of 8 channels that cover C (a short
    last block runs phantom channels), bands covering the output rows,
    and a one-wave split that takes every (image, band) item once."""
    c, h, w, k, s = shape
    for kind in ("forward", "grad_x", "grad_w"):
        th, cb = DW.band_plan(kind, h, w, c, k, s, itemsize)
        assert DW.band_smem(kind, th, cb, h, w, k, s, itemsize)[0] \
            <= DW.BAND_SMEM, kind
        assert cb % 8 == 0 and 8 <= cb <= 512, (kind, cb)
        c_blocks = math.ceil(c / cb)
        assert c_blocks * cb >= c > (c_blocks - 1) * cb, (kind, cb)
        out_h = h if kind == "grad_x" else DW.out_len(h, k, s)
        bands = math.ceil(out_h / th)
        assert bands * th >= out_h > (bands - 1) * th, (kind, th)
        blocks = DW.BAND_BLOCKS_PER_SM * H100_SMS
        nsplit, per = DW.band_splits(T1_N, bands, c_blocks, blocks)
        assert nsplit * per >= T1_N * bands > (nsplit - 1) * per, kind
        assert nsplit * c_blocks <= max(blocks, c_blocks), kind


@pytest.mark.parametrize("s", [1, 2])
def test_plain_versions_match_jax_at_a_width_not_a_multiple_of_8(s):
    """C = 246 (RexNet-150's third depthwise layer, 246 % 8 = 6): the
    forward and the input and tap gradients' plain versions against JAX's
    ``depthwise_conv2d`` (its Pallas kernel in interpret mode) and its
    vjp."""
    n, h, w, c, k = 2, 9, 9, 246, 3
    rng = np.random.default_rng(3)
    ho, wo = DW.out_len(h, k, s), DW.out_len(w, k, s)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    wt = rng.normal(size=(k, k, 1, c)).astype(np.float32)
    cot = rng.normal(size=(n, ho, wo, c)).astype(np.float32)
    out, vjp = jax.vjp(
        lambda a, b: depthwise_conv2d(a, b, stride=s, interpret=True),
        jnp.asarray(x), jnp.asarray(wt))
    dx, dw = vjp(jnp.asarray(cot))
    taps = torch.from_numpy(wt[:, :, 0])
    got = DW.depthwise_forward_reference(torch.from_numpy(x), taps, s)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=1e-5,
                               atol=1e-5)
    got_dx = DW.depthwise_grad_x_reference(torch.from_numpy(cot), taps, s,
                                           h, w)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(dx), rtol=1e-4,
                               atol=1e-4)
    got_dw = DW.depthwise_grad_w_reference(torch.from_numpy(x),
                                           torch.from_numpy(cot), k, s)
    np.testing.assert_allclose(got_dw.numpy(), np.asarray(dw)[:, :, 0],
                               rtol=1e-4, atol=1e-4)
