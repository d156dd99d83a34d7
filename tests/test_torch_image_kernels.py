"""The plain versions of the port's AutoAugment kernels (the CPU side of
``ops/image_kernels.py``) held against the JAX package's Pallas kernels
in interpret mode, as ``tests/test_pallas_image.py`` runs them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu.ops import autoaugment as JA
from imageretrievalresearch_tpu.ops.pallas_image import (
    pallas_histogram,
    pallas_lut_apply,
    pallas_row_shift,
    pallas_row_shift_cubic,
)
from imageretrievalresearch_tpu_torch.ops import autoaugment as TA
from imageretrievalresearch_tpu_torch.ops import image_kernels as T

# 13 planes: not a multiple of the TPU kernels' 8 planes per program
_PLANES = {"random": lambda rng: rng.integers(0, 256, (13, 20, 24),
                                              dtype=np.uint8),
           # constant planes (one bin) and planes that use all 256 values
           "edge": lambda rng: np.stack(
               [np.full((16, 16), v, np.uint8) for v in (0, 7, 255)]
               + [np.arange(256, dtype=np.uint8).reshape(16, 16)] * 2)}


@pytest.mark.parametrize("kind", sorted(_PLANES))
def test_histogram_matches_pallas(rng, kind):
    img = _PLANES[kind](rng)
    ref = np.asarray(pallas_histogram(jnp.asarray(img), interpret=True))
    ours = T.plane_histogram(torch.from_numpy(img))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("kind", sorted(_PLANES))
def test_lut_apply_matches_pallas(rng, kind):
    img = _PLANES[kind](rng)
    lut = rng.integers(0, 256, (img.shape[0], 256)).astype(np.int32)
    ref = np.asarray(pallas_lut_apply(jnp.asarray(img), jnp.asarray(lut),
                                      interpret=True))
    ours = T.lut_apply(torch.from_numpy(img), torch.from_numpy(lut))
    assert ours.dtype == torch.uint8
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_row_shift_matches_pallas_and_jax_rotate_pass(rng):
    # 2 x 3 planes of 13 rows (N = 78), width 41; shifts span ±smax
    b, c, h, w, smax = 2, 3, 13, 41, 15
    planes = rng.integers(0, 256, (b, c, h, w), dtype=np.uint8)
    shifts = rng.integers(-smax, smax + 1, b * c * h).astype(np.int32)
    shifts[:2] = (-smax, smax)
    rows = planes.reshape(-1, w)
    ours = T.row_shift(torch.from_numpy(rows), torch.from_numpy(shifts))
    ref = np.asarray(pallas_row_shift(jnp.asarray(rows), jnp.asarray(shifts),
                                      smax=smax, interpret=True))
    np.testing.assert_array_equal(ours.numpy(), ref)
    # one pass of the 3-shear rotate on it, against JAX's CPU roll-select
    # form, at per-image slopes
    v = np.array([0.31, -0.27], np.float32)
    ref = np.asarray(JA._nearest_row_shift(jnp.asarray(planes),
                                           jnp.asarray(v), smax))
    ours = TA._nearest_row_shift(torch.from_numpy(planes), torch.from_numpy(v))
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_column_shift_matches_pallas_on_transposed_planes_and_jax_pass(rng):
    # 2 x 3 planes of 13 x 41; shifts span ±smax, past the 13 rows
    b, c, h, w, smax = 2, 3, 13, 41, 15
    planes = rng.integers(0, 256, (b, c, h, w), dtype=np.uint8)
    shifts = rng.integers(-smax, smax + 1, (b * c, w)).astype(np.int32)
    shifts[0, :2] = (-smax, smax)
    flat = planes.reshape(b * c, h, w)
    ours = T.column_shift(torch.from_numpy(flat), torch.from_numpy(shifts))
    assert ours.dtype == torch.uint8 and ours.is_contiguous()
    ref = np.asarray(pallas_row_shift(
        jnp.asarray(flat.transpose(0, 2, 1).reshape(-1, h)),
        jnp.asarray(shifts.reshape(-1)), smax=smax, interpret=True))
    np.testing.assert_array_equal(
        ours.numpy(), ref.reshape(b * c, w, h).transpose(0, 2, 1))
    # the rotate's Sy pass on columns, against JAX's CPU roll-select form
    # on the transposed planes (as JAX's batched_rotate runs it)
    v = np.array([0.31, -0.27], np.float32)
    ref = np.asarray(JA._nearest_row_shift(
        jnp.asarray(planes.transpose(0, 1, 3, 2)), jnp.asarray(v), smax))
    ours = TA._nearest_column_shift(torch.from_numpy(planes),
                                    torch.from_numpy(v))
    np.testing.assert_array_equal(ours.numpy(), ref.transpose(0, 1, 3, 2))


def test_cubic_weight_matches_jax_op_for_op():
    # eager JAX runs _cubic_kernel op by op, as the port's kernel does
    t = np.linspace(-2.5, 2.5, 20001, dtype=np.float32)
    ref = np.asarray(JA._cubic_kernel(jnp.asarray(t)))
    np.testing.assert_array_equal(T.cubic_weight(torch.from_numpy(t)).numpy(),
                                  ref)


def test_row_shift_cubic_matches_pallas(rng):
    # Exact equality does not hold: XLA compiles the weight polynomial
    # with fused multiply-adds, the port (plain version and CUDA kernel
    # alike) rounds each product as the source reads. The bound that holds
    # is ±1 on rounding ties, on under 1e-3 of the pixels.
    n, w, smax = 700, 56, 17
    rows = rng.integers(0, 256, (n, w), dtype=np.uint8)
    src0 = rng.uniform(-smax + 1e-3, smax, n).astype(np.float32)
    src0[:3] = (-smax, 0.0, smax - 0.5)
    ref = np.asarray(pallas_row_shift_cubic(
        jnp.asarray(rows), jnp.asarray(src0), smax=smax, interpret=True))
    ours = T.row_shift_cubic(torch.from_numpy(rows), torch.from_numpy(src0))
    assert ours.dtype == torch.uint8
    diff = np.abs(ours.numpy().astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (
        diff.max(), (diff > 0).mean())


def test_wrappers_refuse_other_devices():
    rows = torch.zeros((2, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        T.row_shift(rows, torch.zeros(2, dtype=torch.int32, device="meta"))
