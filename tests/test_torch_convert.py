"""The port's checkpoint converter against the JAX package's, on the CPU.

``models.convert.export_timm_state_dict`` against JAX's
``export_torch_state_dict`` on the same variables (carried into the port
by ``params_from_jax``), key for key and bit for bit, for every family at
tests/test_torch_backbones.py's shrunken sizes, the ``conv_input``
Sequential layout, Lightning's ``model.`` prefix, and a template (Swin's
recomputed buffers). Then ``cli.convert`` both ways: a Lightning file in
the reference's layout goes ``--to native`` (the port's checkpoint
directory) and back ``--to torch --lightning_out``, which JAX's
``load_checkpoint(strict=True)`` reads; a port ``Trainer`` run directory
goes ``--to torch`` and loads strictly into JAX too. JAX's forward on
what it loaded matches the port's within 1e-4 (rtol and atol,
tests/test_torch_checkpoint_loader.py's tolerance). ``--lenient`` and the
refusals of ``--lightning_out`` without ``--to torch`` and of ``--to
orbax``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu.models import create_model as jax_create
from imageretrievalresearch_tpu.models.backbone import (
    Backbone as JaxBackbone,
)
from imageretrievalresearch_tpu.models.convert import (
    export_torch_state_dict,
    load_checkpoint as jax_load_checkpoint,
)
from imageretrievalresearch_tpu_torch.cli import convert as CLI
from imageretrievalresearch_tpu_torch.config import TrainConfig
from imageretrievalresearch_tpu_torch.models import create_model
from imageretrievalresearch_tpu_torch.models.convert import (
    export_timm_state_dict,
    load_checkpoint,
    params_from_jax,
)
from imageretrievalresearch_tpu_torch.train import Trainer
from imageretrievalresearch_tpu_torch.utils.checkpoint import (
    saved_checkpoint,
)

N_CLS = 7
SWIN = dict(embed_dim=32, depths=(2, 2, 2), num_heads=(2, 4, 8),
            window_sizes=(4, 4, 4), img_size=32)
# (id, registry name, architecture overrides, conv_input)
FAMILIES = [
    ("efficientnet", "efficientnet_b0", dict(width_mult=0.25,
                                             depth_mult=0.1), False),
    ("efficientnet_conv_input", "efficientnet_b0",
     dict(width_mult=0.25, depth_mult=0.1), True),
    ("rexnet", "rexnet_100", dict(width_mult=0.5, depth_mult=0.5), False),
    ("resnet", "resnet50", dict(layers=(1, 1, 1, 1)), False),
    ("resnext", "resnext50_32x4d",
     dict(layers=(1, 1, 1, 1), groups=4, base_width=16), False),
    ("darknet", "darknet53", dict(depths=(1, 1, 1), width_mult=0.25), True),
    ("swin", "swin_tiny_patch4_window7_224", SWIN, False),
]
SIZE = 32
# the CLI's model: tests/test_torch_checkpoint_loader.py's small b0
SMALL = ["--model_name", "efficientnet_b0", "--num_classes", "5"]
SMALL_KW = dict(num_classes=5, width_mult=0.25, depth_mult=0.1)
TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_variables(bb, conv_input=False, seed=0):
    """JAX variables in the init's shapes, every leaf drawn from numpy."""
    shapes = jax.eval_shape(bb.init, jax.random.key(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        key = path[-1].key
        if key == "kernel":
            fan_in = int(np.prod(x.shape[:-1]))
            return rng.normal(0, np.sqrt(2.0 / fan_in), x.shape)
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape)
        return rng.normal(0, 0.1, x.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(leaf(p, x), np.float32), shapes)


def _pair(name, kw, conv_input):
    bb = jax_create(name, num_classes=N_CLS, conv_input=conv_input, **kw)
    variables = _jax_variables(bb, conv_input)
    port = create_model(name, num_classes=N_CLS, conv_input=conv_input,
                        device="cpu", seed=None, **kw)
    port.load_timm_state_dict(params_from_jax(variables, port))
    return bb, variables, port


def _template(port) -> dict:
    """What timm's own module would save: the state dict with the
    buffers the port rebuilds (Swin's index and masks) beside it, in the
    conv_input Sequential layout where the model has the stem."""
    net = {**dict(port.net.named_buffers()), **port.net.state_dict()}
    if port.stem is None:
        return net
    return {"0.0.weight": port.stem.conv.weight.detach(),
            **{f"1.{k}": v for k, v in net.items()}}


def _assert_same(ours: dict, theirs: dict):
    assert set(ours) == set(theirs), (sorted(set(ours) ^ set(theirs))[:8])
    for k, v in theirs.items():
        want = np.asarray(v)
        got = ours[k]
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert got.is_contiguous(), k
        assert got.dtype == (torch.float32 if want.dtype == np.float32
                             else torch.int64), k
        np.testing.assert_array_equal(got.numpy(), want, err_msg=k)


@pytest.mark.parametrize("fid,name,kw,conv_input", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
@pytest.mark.parametrize("lightning", [False, True])
def test_export_matches_jax_exporter(fid, name, kw, conv_input, lightning):
    """Without a template, and (Swin, the conv_input layouts) with one:
    the same keys, dtypes and values, bitwise."""
    bb, variables, port = _pair(name, kw, conv_input)
    _assert_same(export_timm_state_dict(port, lightning=lightning),
                 export_torch_state_dict(bb, variables, lightning=lightning))
    if fid == "swin" or conv_input:
        tpl = _template(port)
        ours = export_timm_state_dict(port, lightning=lightning,
                                      template=tpl)
        _assert_same(ours, export_torch_state_dict(
            bb, variables, lightning=lightning, template=tpl))
        prefix = "model." if lightning else ""
        assert any(k.startswith(prefix) and k.endswith(
            "relative_position_index") for k in ours) == (fid == "swin")


def test_export_with_a_template_is_strict():
    """A key the template lacks raises, as JAX's; lenient drops it."""
    _, _, port = _pair(*FAMILIES[0][1:])
    tpl = _template(port)
    del tpl["classifier.weight"]
    with pytest.raises(KeyError, match="classifier.weight"):
        export_timm_state_dict(port, template=tpl)
    sd = export_timm_state_dict(port, template=tpl, strict=False)
    assert "classifier.weight" not in sd and "classifier.bias" in sd


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _jitted_init(init):
    """JAX's loader runs ``Backbone.init`` eagerly (most of a minute for
    b0 on a CPU) before its strict conversion replaces every value; the
    same init under jit, compiled once per model name, gives it the same
    variables in a fraction of the time."""
    compiled = {}

    def wrapper(self, rng, sample):
        if self.name not in compiled:
            compiled[self.name] = jax.jit(functools.partial(init, self))
        return compiled[self.name](rng, sample)

    return wrapper


@pytest.fixture(scope="module")
def jax_small():
    """JAX's loader and embed on the CLI's small b0 (one jit each)."""
    bb = jax_create("efficientnet_b0", **SMALL_KW)
    embed = jax.jit(lambda v, x: bb.embed(v, x, train=False))
    init = _jitted_init(JaxBackbone.init)

    def load_and_embed(path, x, lightning=True):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JaxBackbone, "init", init)
            variables = jax_load_checkpoint(
                path, bb, sample_shape=(1, SIZE, SIZE, 3),
                from_pytorch_lightning=lightning, strict=True)
        return np.asarray(embed(variables, jnp.asarray(x)))

    return load_and_embed


def _spread(model, seed):
    """Seeded BatchNorm statistics and affines (identity BatchNorms over
    He-normal convs shrink the embeddings to ~1e-5)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t, lo in ((m.weight, 0.5), (m.running_var, 0.5)):
                    t.copy_(lo + torch.rand(t.shape, generator=gen))
                for t in (m.bias, m.running_mean):
                    t.copy_(0.1 * torch.randn(t.shape, generator=gen))
    return model


def _images(seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (4, SIZE, SIZE, 3)
                                               ).astype(np.float32)


def _embed(model, x):
    with torch.inference_mode():
        return model.eval().embed(torch.from_numpy(x)).numpy()


@pytest.fixture(autouse=True)
def small_cli_model(monkeypatch):
    """The CLI builds its model at the shrunken width and depth (it has
    no flags for them)."""
    monkeypatch.setattr(CLI, "create_model", functools.partial(
        create_model, width_mult=SMALL_KW["width_mult"],
        depth_mult=SMALL_KW["depth_mult"]))


def _convert(*argv):
    CLI.main([*argv, *SMALL, "--device", "cpu"])


def test_cli_round_trip_loads_strictly_into_jax(tmp_path, jax_small,
                                                capsys):
    """A Lightning file of the reference's layout -> --to native -> --to
    torch --lightning_out: the port reads each step bit for bit, and JAX's
    strict loader reads the last, embedding as the port does."""
    src = _spread(create_model("efficientnet_b0", **SMALL_KW, device="cpu",
                               seed=5), 5)
    ckpt = tmp_path / "published.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in
                               src.net.state_dict().items()}, "epoch": 3},
               ckpt)
    native = tmp_path / "native"
    _convert("--checkpoint", str(ckpt), "--out", str(native))
    assert capsys.readouterr().out.strip() == (
        f"Converted {ckpt} -> {native}")
    assert saved_checkpoint(str(native)).endswith("best/0/state.pt")
    back = load_checkpoint(str(native), create_model(
        "efficientnet_b0", **SMALL_KW, device="cpu", seed=6))
    for k, v in src.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    out = tmp_path / "exported.ckpt"
    _convert("--checkpoint", str(native), "--out", str(out), "--to",
             "torch", "--lightning_out")
    payload = torch.load(out, weights_only=False)
    assert set(payload) == {"state_dict"}
    assert all(k.startswith("model.") for k in payload["state_dict"])
    again = load_checkpoint(str(out), create_model(
        "efficientnet_b0", **SMALL_KW, device="cpu", seed=7))
    for k, v in src.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    x = _images()
    ref = jax_small(str(out), x)
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(_embed(src, x), ref, **TOL)


class _Loader:
    def __init__(self, b=4):
        rng = np.random.default_rng(0)
        self.batches = [{
            "qry": rng.random((b, SIZE, SIZE, 3)).astype(np.float32),
            "pos": [rng.random((b, SIZE, SIZE, 3)).astype(np.float32)],
            "neg": [rng.random((b, SIZE, SIZE, 3)).astype(np.float32)],
            "cat_idx": rng.integers(0, 5, b), "prod_idx": rng.integers(0, 5,
                                                                        b)}]

    def __len__(self):
        return 1

    def __iter__(self):
        return iter(self.batches)

    def set_epoch(self, epoch):
        pass


def _as_tensors(batch, generator=None, rows=None):
    """The loader yields float batches already."""
    return {k: ([torch.from_numpy(x) for x in v] if isinstance(v, list)
                else torch.from_numpy(v)) for k, v in batch.items()}


def test_trainer_run_directory_exports_to_jax(tmp_path, jax_small):
    """A port Trainer's run directory (one step) goes --to torch as a
    plain state dict, which JAX's strict loader reads: the trained
    weights, BatchNorm statistics included, embed there as here."""
    run = tmp_path / "run"
    model = create_model("efficientnet_b0", **SMALL_KW, device="cpu",
                         seed=1)
    trainer = Trainer(TrainConfig(model_name="efficientnet_b0",
                                  image_size=SIZE, compute_dtype="float32",
                                  device="cpu", batch_size=4,
                                  checkpoint_dir=str(run)),
                      model, _Loader(), transform=_as_tensors)
    state, _ = trainer.fit(max_epochs=1)
    assert state.step == 1
    out = tmp_path / "run.pth"
    _convert("--checkpoint", str(run), "--out", str(out), "--to", "torch")
    sd = torch.load(out, weights_only=True)
    assert not any(k.startswith("model.") for k in sd)
    assert int(sd["bn1.num_batches_tracked"]) == 1
    x = _images(1)
    np.testing.assert_allclose(_embed(model, x),
                               jax_small(str(out), x, lightning=False),
                               **TOL)


def test_lenient_keeps_the_init_for_missing_keys(tmp_path, capsys):
    """A file without the classifier: refused by default; with --lenient
    the head keeps the seeded init, the rest is the file's, and stderr
    names the missing keys and an unused one."""
    src = create_model("efficientnet_b0", **SMALL_KW, device="cpu", seed=2)
    sd = {k: v for k, v in src.net.state_dict().items()
          if not k.startswith("classifier.")}
    sd["extra.weight"] = torch.zeros(1)
    path = tmp_path / "partial.pth"
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="classifier"):
        _convert("--checkpoint", str(path), "--out", str(tmp_path / "a"),
                 "--not_lightning")
    _convert("--checkpoint", str(path), "--out", str(tmp_path / "b"),
             "--not_lightning", "--lenient")
    err = capsys.readouterr().err
    assert "classifier.weight" in err and "extra.weight" in err
    got = load_checkpoint(str(tmp_path / "b"), create_model(
        "efficientnet_b0", **SMALL_KW, device="cpu", seed=8))
    init = create_model("efficientnet_b0", **SMALL_KW, device="cpu")
    for k, v in got.net.state_dict().items():
        want = (init if k.startswith("classifier.") else src).net
        assert torch.equal(v, want.state_dict()[k]), k


@pytest.mark.parametrize("argv,message", [
    (["--lightning_out"], "--lightning_out requires --to torch"),
    (["--to", "native", "--lightning_out"],
     "--lightning_out requires --to torch"),
    (["--to", "orbax"], "python -m imageretrievalresearch_tpu.cli.convert"),
])
def test_cli_refusals(argv, message, capsys, tmp_path):
    with pytest.raises(SystemExit) as e:
        _convert("--checkpoint", "x.ckpt", "--out", str(tmp_path / "o"),
                 *argv)
    assert e.value.code == 2
    assert message in capsys.readouterr().err
    assert not (tmp_path / "o").exists()
