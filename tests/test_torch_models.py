"""The port's EfficientNet held against the JAX forward on the CPU, with
the JAX weights carried across by ``params_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu.models import create_model as jax_create
from imageretrievalresearch_tpu.models.convert import export_torch_state_dict
from imageretrievalresearch_tpu_torch.models import create_model
from imageretrievalresearch_tpu_torch.models.convert import params_from_jax

# (JAX model name, width_mult, depth_mult, image size): a shrunken B0, and
# b3a at full width with one block per stage (its stage-0 separable block
# and stride-2 inverted-residual blocks at the published channel counts)
CASES = [("efficientnet_b0", 0.5, 0.1, 32),
         ("efficientnet_b3a", 1.2, 0.1, 48)]


def _jax_variables(name, w, d, size, seed=0):
    """JAX model + variables with every leaf randomized from numpy: He-scale
    kernels (so activations stay O(1) through the depth) and non-trivial
    BatchNorm statistics."""
    bb = jax_create(name, num_classes=7, width_mult=w, depth_mult=d)
    # shapes only: the values all come from numpy below
    variables = jax.eval_shape(bb.init, jax.random.key(0),
                               jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        key = path[-1].key
        shape = x.shape
        if key == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, np.sqrt(2.0 / fan_in), shape)
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape)
        return rng.normal(0, 0.1, shape)           # bias, mean

    variables = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(leaf(p, x), jnp.float32), variables)
    return bb, variables


@pytest.mark.parametrize("name,w,d,size", CASES)
def test_embed_and_features_match_jax(name, w, d, size):
    bb, variables = _jax_variables(name, w, d, size)
    x = np.random.default_rng(1).normal(size=(2, size, size, 3)).astype(
        np.float32)

    @jax.jit
    def forward(v, xx):     # one compiled program: eager apply is slow
        fm = bb.forward_features(v, xx)
        return fm, bb.embed(v, xx), bb.head(v, fm)

    ref_fm, ref_emb, ref_logits = map(np.asarray,
                                      forward(variables, jnp.asarray(x)))

    port = create_model(name, num_classes=7, width_mult=w, depth_mult=d,
                        device="cpu")
    port.load_timm_state_dict(params_from_jax(variables, port))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        fm = port.forward_features(xt).numpy()
        emb = port.embed(xt).numpy()
        logits = port(xt).numpy()
    assert fm.shape == ref_fm.shape        # NHWC at the public surface
    assert np.abs(ref_emb).max() > 1e-2    # activations are not vanishing
    # f32 convolutions accumulate in another order than XLA's
    np.testing.assert_allclose(fm, ref_fm, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(emb, ref_emb, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits, ref_logits, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,w,d,size", CASES)
def test_state_dict_equals_jax_export(name, w, d, size):
    bb, variables = _jax_variables(name, w, d, size)
    exported = export_torch_state_dict(bb, variables)
    port = create_model(name, num_classes=7, width_mult=w, depth_mult=d,
                        device="cpu")
    port.load_timm_state_dict(params_from_jax(variables, port))
    ours = port.net.state_dict()
    assert sorted(ours) == sorted(exported)
    for key, val in exported.items():
        np.testing.assert_array_equal(ours[key].numpy(), val.numpy(),
                                      err_msg=key)


def test_b3a_full_width_shapes():
    port = create_model("efficientnet_b3a", device="cpu")
    assert port.num_features == 1536
    blocks = [len(s) for s in port.net.blocks]
    assert blocks == [2, 3, 3, 5, 5, 6, 2]     # timm b3: 26 blocks
    se = port.net.blocks[1][0].se.conv_reduce
    assert se.out_channels == int(24 * 0.25)   # SE from the INPUT channels


def test_unported_family_raises():
    """Every family of the JAX registry is ported (tests/
    test_torch_backbones.py builds each name); a name in neither registry
    raises, as JAX's create_model does."""
    for name in ("vit_base_patch16_224", "cspdarknet53"):
        with pytest.raises(ValueError, match="Unknown model name"):
            create_model(name, device="cpu")
        with pytest.raises(ValueError, match="Unknown model name"):
            jax_create(name)
