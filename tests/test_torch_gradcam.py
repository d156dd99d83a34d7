"""The port's Grad-CAM (``retrieval/gradcam.py``) held against the JAX
package's on the CPU.

Two shrunken backbones with the same numpy-drawn weights in both packages
(``params_from_jax``): a CNN (RexNet, width and depth 0.5, at 96 px: a 3 x 3
map) and the Swin of ``tests/test_retrieval_engine.py``'s CAM test
(``swin_s3_tiny_224`` at 64 px, depths (1, 1): 64 tokens folded to 8 x 8).
Both packages compute the map in f32 from the same weights; they differ
by f32 sums in other orders (up to 6e-6 of the map's range after the
min-max normalization in these cases), and the maps must agree within
1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu.retrieval import gradcam as J
from imageretrievalresearch_tpu_torch.retrieval import gradcam as T
from test_torch_backbones import _images, _pair

CAM_ATOL = 1e-4
SWIN_S3 = dict(img_size=64, depths=(1, 1), num_heads=(3, 6),
               window_sizes=(8, 8), drop_path_rate=0.0)
# (id, registry name, architecture overrides, image size, map side)
CASES = [("cnn", "rexnet_100", dict(width_mult=0.5, depth_mult=0.5), 96, 3),
         ("swin", "swin_s3_tiny_224", SWIN_S3, 64, 8)]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    """Both packages' maps for one backbone: the pair CAM against seeded
    reference embeddings, the class CAM for one class per image and for
    one class shared by all."""
    cid, name, kw, size, side = request.param
    bb, variables, port = _pair(name, kw, size)
    x = _images(size, n=3)
    ref = np.random.default_rng(5).normal(
        size=(3, port.num_features)).astype(np.float32)
    cls = np.array([0, 3, 6])

    @jax.jit
    def jax_cams(v, xx, rr, cc):
        return (J.grad_cam_pair(bb, v, xx, rr),
                J.grad_cam_class(bb, v, xx, cc),
                J.grad_cam_class(bb, v, xx, cc[0]))

    want = [np.asarray(a) for a in jax_cams(variables, jnp.asarray(x),
                                            jnp.asarray(ref),
                                            jnp.asarray(cls))]
    got = [T.grad_cam_pair(port, x, ref),
           T.grad_cam_class(port, x, torch.from_numpy(cls)),
           T.grad_cam_class(port, x, int(cls[0]))]
    return side, want, [g.numpy() for g in got], port


def test_cams_match_jax(case):
    side, want, got, _ = case
    for w, g in zip(want, got):
        assert g.shape == w.shape == (3, side, side)
        assert g.dtype == np.float32
        # real maps: the CAM of at least 2 of the 3 images spans [0, 1]
        # after the normalization (relu may leave one image all zero)
        assert (np.abs(w.max(axis=(1, 2)) - 1) < 1e-6).sum() >= 2
        assert w.min() == 0 and w.max() <= 1
        np.testing.assert_allclose(g, w, rtol=0, atol=CAM_ATOL)


def test_grad_cam_leaves_the_model_as_it_was(case):
    _, _, _, port = case
    params = {k: v.clone() for k, v in port.state_dict().items()}
    port.train()
    size = getattr(port.net, "img_size", 96)
    T.grad_cam_pair(port, _images(size, n=2),
                    np.ones((2, port.num_features), np.float32))
    assert port.training
    assert all(p.grad is None for p in port.parameters())
    for k, v in port.state_dict().items():
        torch.testing.assert_close(v, params[k], rtol=0, atol=0)
    port.eval()


def test_spatialize_and_normalization_floor():
    fm = torch.arange(2 * 9 * 4, dtype=torch.float32).reshape(2, 9, 4)
    assert T._spatialize(fm).shape == (2, 3, 3, 4)
    np.testing.assert_array_equal(
        T._spatialize(fm).numpy(), np.asarray(J._spatialize(jnp.asarray(
            fm.numpy()))))
    with pytest.raises(ValueError, match="not a square grid"):
        T._spatialize(torch.zeros(1, 8, 4))
    with pytest.raises(ValueError, match="feature map"):
        T._spatialize(torch.zeros(2, 4))
    # a flat map: max - min = 0, the 1e-8 floor keeps it finite (zeros)
    flat = torch.ones(2, 3, 3, 4)
    cam = T._cam_from_fm(flat, torch.ones_like(flat))
    ref = np.asarray(J._cam_from_fm(jnp.ones((2, 3, 3, 4)),
                                    jnp.ones((2, 3, 3, 4))))
    np.testing.assert_array_equal(cam.numpy(), ref)
    assert (cam == 0).all()
