"""The port's preprocessing held against the JAX package on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu.cli.inference import (
    build_eval_transform as jax_eval_transform,
)
from imageretrievalresearch_tpu.ops import preprocess as J
from imageretrievalresearch_tpu_torch.ops import preprocess as T


@pytest.mark.parametrize("shape", [(2, 30, 41, 3), (1, 17, 9, 3),
                                   (2, 12, 12, 1)])
def test_square_pad_bitwise(rng, shape):
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    ref = np.asarray(J.square_pad(jnp.asarray(x)))
    ours = T.square_pad(torch.from_numpy(x)).numpy()
    assert ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("src,dst", [((37, 53), (16, 16)),     # down
                                     ((12, 9), (32, 40)),      # up
                                     ((40, 20), (24, 30))])    # mixed
@pytest.mark.parametrize("antialias", [True, False])
def test_resize_bilinear_matches_jax(rng, src, dst, antialias):
    # images in [0, 1]: atol 1e-5 is ~100 f32 ulps there; the two matmuls
    # accumulate in another order than XLA's einsum
    x = rng.random((2, *src, 3), dtype=np.float32)
    ref = np.asarray(J.resize_bilinear(jnp.asarray(x), dst,
                                       antialias=antialias))
    ours = T.resize_bilinear(torch.from_numpy(x), dst,
                             antialias=antialias).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["squarepad", "plain"])
def test_eval_transforms_match_jax(rng, kind):
    x = rng.integers(0, 256, (2, 45, 30, 3), dtype=np.uint8)
    ref = np.asarray(jax_eval_transform(kind, 24)(jnp.asarray(x)))
    ours = T.build_eval_transform(kind, 24, device="cpu")(
        torch.from_numpy(x)).numpy()
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)

