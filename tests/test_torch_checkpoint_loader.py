"""The port's checkpoint loader (``models/convert.py::load_checkpoint``) in
each of the JAX loader's cases: an empty path keeps the seeded init, a
``CheckpointManager`` directory (``best/``, then ``last/``), a
Lightning-style ``{"state_dict": {"model.…": …}}`` file, a ``conv_input``
file, and an orbax-like directory, which is refused. The Lightning file
is also read by the JAX loader, and both embed the same images alike."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu.models import create_model as jax_create
from imageretrievalresearch_tpu.models.convert import (
    convert_torch_state_dict,
)
from imageretrievalresearch_tpu.models.convert import (
    strip_model_prefix as jax_strip_model_prefix,
)
from imageretrievalresearch_tpu_torch.models import create_model
from imageretrievalresearch_tpu_torch.models.convert import (
    load_checkpoint,
    strip_model_prefix,
)
from imageretrievalresearch_tpu_torch.utils import CheckpointManager

SMALL = dict(num_classes=5, width_mult=0.25, depth_mult=0.1, device="cpu")


def small(seed, **kw):
    return create_model("efficientnet_b0", seed=seed, **{**SMALL, **kw})


def assert_same_weights(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for key in sa:
        torch.testing.assert_close(sa[key], sb[key], rtol=0, atol=0,
                                   msg=key)


def spread(model, seed):
    """Seeded BatchNorm statistics and affines, so that the embeddings are
    well above zero (identity BatchNorm over He-normal convs shrinks them
    to ~1e-5)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t, lo in ((m.weight, 0.5), (m.running_var, 0.5)):
                    t.copy_(lo + torch.rand(t.shape, generator=gen))
                for t in (m.bias, m.running_mean):
                    t.copy_(0.1 * torch.randn(t.shape, generator=gen))
    return model


def differs(a, b) -> bool:
    return any(not torch.equal(x, y) for x, y in
               zip(a.state_dict().values(), b.state_dict().values()))


def test_empty_path_keeps_the_seeded_init(capsys):
    model = small(1)
    assert load_checkpoint("", model) is model
    assert_same_weights(model, small(1))
    out = capsys.readouterr()
    assert out.out == "" and "randomly initialized" in out.err


def _train_state(model, step):
    return {"model": model.state_dict(), "optimizer": {}, "step": step}


@pytest.mark.parametrize("save_top_k,monitor,mode", [
    (1, "cos_sims", "max"), (2, "cos_sims", "max"), (2, "train_loss", "min")])
def test_checkpoint_manager_directory_best_then_last(tmp_path, capsys,
                                                     save_top_k, monitor,
                                                     mode):
    """best/ holds the better step (the older one), last/ the newest; the
    loader takes the step ``CheckpointManager.restore()`` takes, also when
    best/ keeps both steps, and last/ once best/ is empty."""
    ck = tmp_path / "ck"
    mgr = CheckpointManager(str(ck), monitor=monitor, mode=mode,
                            save_top_k=save_top_k)
    better, newer = small(2), small(3)
    good, bad = (0.9, 0.4) if mode == "max" else (0.4, 0.9)
    mgr.save(1, _train_state(better, 1), {monitor: good})
    mgr.save(2, _train_state(newer, 2), {monitor: bad})
    assert mgr.best_step() == 1 and mgr.latest_step() == 2
    kept = sorted(int(d.name) for d in (ck / "best").iterdir())
    assert kept == [1, 2][:save_top_k]
    model = small(4)
    assert differs(model, better)
    load_checkpoint(str(ck), model)
    assert_same_weights(model, better)
    for step in kept:
        for name in ("state.pt", "metrics.json"):
            (ck / "best" / str(step) / name).unlink()
        (ck / "best" / str(step)).rmdir()
    load_checkpoint(str(ck), model)
    assert_same_weights(model, newer)
    out = capsys.readouterr()
    assert out.out == "" and "trainer checkpoint" in out.err


def test_lightning_file_matches_the_jax_loader(tmp_path):
    """{"state_dict": {"model.<timm key>": …}}: the port loads it into a
    fresh model; the JAX loader's steps convert the same file (onto zeros
    of the init's shapes: its eager init takes ~30 s here), and the two
    embed the same seeded images within 1e-4."""
    src = spread(small(5), 5)
    path = tmp_path / "lightning.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in
                               src.net.state_dict().items()},
                "epoch": 3}, path)
    model = small(6)
    load_checkpoint(str(path), model)
    assert_same_weights(model, src)

    bb = jax_create("efficientnet_b0", num_classes=5, width_mult=0.25,
                    depth_mult=0.1)
    init = jax.tree_util.tree_map(
        lambda t: jnp.zeros(t.shape, t.dtype),
        jax.eval_shape(bb.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3))))
    payload = torch.load(path, map_location="cpu", weights_only=False)
    variables = convert_torch_state_dict(
        jax_strip_model_prefix(payload["state_dict"]), bb, init, strict=True)
    x = np.random.default_rng(0).uniform(0, 1, (4, 32, 32, 3)).astype(
        np.float32)
    ref = np.asarray(jax.jit(lambda v, x: bb.embed(v, x, train=False))(
        variables, jnp.asarray(x)))
    with torch.inference_mode():
        ours = model.embed(torch.from_numpy(x)).numpy()
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


def test_conv_input_file(tmp_path):
    """The reference's Sequential layout: the stem conv at ``0.0.weight``
    and the timm keys under ``1.``, Lightning's prefix in front."""
    src = small(7, conv_input=True)
    sd = {"0.0.weight": src.stem.conv.weight.detach(),
          **{f"1.{k}": v for k, v in src.net.state_dict().items()}}
    path = tmp_path / "conv_input.pth"
    torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()}},
               path)
    model = small(8, conv_input=True)
    assert differs(model, src)
    load_checkpoint(str(path), model)
    assert_same_weights(model, src)
    # a plain (prefix-free) state dict loads the same way
    torch.save(sd, tmp_path / "plain.pth")
    model = small(9, conv_input=True)
    load_checkpoint(str(tmp_path / "plain.pth"), model)
    assert_same_weights(model, src)


def test_orbax_directory_is_refused(tmp_path):
    step = tmp_path / "orbax" / "best" / "3"
    (step / "default").mkdir(parents=True)
    (step / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="torch checkpoints only"):
        load_checkpoint(str(tmp_path / "orbax"), small(1))
    with pytest.raises(ValueError, match="torch checkpoints only"):
        load_checkpoint(str(tmp_path / "orbax" / "best"), small(1))


def test_strip_model_prefix_matches_jax():
    sd = {"model.conv_stem.weight": 1, "model.model.x": 2, "bn1.bias": 3,
          "head.model.y": 4}
    assert strip_model_prefix(sd) == jax_strip_model_prefix(sd)
    assert strip_model_prefix(sd) == {"conv_stem.weight": 1, "model.x": 2,
                                      "bn1.bias": 3, "head.model.y": 4}

