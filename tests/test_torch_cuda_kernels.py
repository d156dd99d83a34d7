"""The port's CUDA kernels against their plain versions, on the card.

Skipped without a CUDA device. Imports no JAX (the machine with the card
has none); run there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu_torch.ops import image_kernels as K
from imageretrievalresearch_tpu_torch.ops import retrieval as T
from imageretrievalresearch_tpu_torch.tools import profile_fused_kernel as P


@pytest.fixture
def cuda_device():
    # decided here, never at import: every xdist worker collects the same
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pm1_rows(rng, n, d):
    """16 entries of ±1 per row (norm exactly 4): exact scores, many ties."""
    out = np.zeros((n, d), np.float32)
    pos = rng.random((n, d)).argsort(axis=1)[:, :16]
    np.put_along_axis(out, pos, rng.choice([-1.0, 1.0], (n, 16)), axis=1)
    return out


def _launch_and_compare(q, g, k, device, mode="float32"):
    """One launch of the mode's kernel against its plain version on the
    card, on the same (prepared) gallery: vals/inds/ok bitwise."""
    qh = T.l2_normalize(torch.from_numpy(q)).to(device)
    gd, gs = torch.from_numpy(g).to(device), None
    if mode != "float32":
        gd, gs = T._prepare_gallery(gd, mode)
    splits = T.fused_splits(qh.shape[0], gd.shape[0], k, device)
    counter = T._VARIANTS[gd.dtype][2]
    before = T.KERNEL_LAUNCHES[counter]
    kv, ki, kok = T.fused_cosine_topk(qh, gd, k, gallery_scale=gs)
    assert T.KERNEL_LAUNCHES[counter] == before + 1
    rv, ri, rok = T.fused_cosine_topk_reference(
        qh, gd, k, matmul_dtype=mode, gallery_scale=gs, splits=splits)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(kv.cpu().numpy(), rv.cpu().numpy())
    np.testing.assert_array_equal(ki.cpu().numpy(), ri.cpu().numpy())
    np.testing.assert_array_equal(kok.cpu().numpy(), rok.cpu().numpy())
    return kok.cpu().numpy()


# G and k set the wrapper's split count (fused_splits): one split below one
# tile; one split per tile (33, 79); capped by the merge kernel's shared
# memory at k=384 (53) or by the SM count at k=150 (132 on an H100 SXM),
# both with a ragged last round of tiles.
@pytest.mark.cuda
@pytest.mark.parametrize("q,g,d,k", [(40, 60, 32, 20), (33, 2100, 40, 20),
                                     (70, 5000, 96, 150),
                                     (64, 40000, 32, 384),
                                     (64, 30000, 32, 150)])
def test_fused_kernel_matches_plain_version(cuda_device, q, g, d, k):
    rng = np.random.default_rng(0)
    qa, ga = _pm1_rows(rng, q, d), _pm1_rows(rng, g, d)
    ga[min(64, g - 1)] = ga[3]           # exact duplicates: tied scores
    _launch_and_compare(qa, ga, k, cuda_device)


@pytest.mark.cuda
def test_fused_kernel_certificate_fails_on_bin_overflow(cuda_device):
    rng = np.random.default_rng(1)
    q, g = _pm1_rows(rng, 40, 32), _pm1_rows(rng, 70000, 32)
    # tiles are dealt round-robin to the splits: rows S*BINS apart share
    # bin 0 of split 0
    stride = T.fused_splits(40, 70000, 50, cuda_device) * T.FUSED_BINS
    assert (T.FUSED_T_DEPTH + 1) * stride < 70000
    for j in range(T.FUSED_T_DEPTH + 2):
        g[j * stride] = q[0]
    ok = _launch_and_compare(q, g, 50, cuda_device)
    assert ok[0] == 0 and ok[1:].any()
    vals, inds = T.cosine_topk(torch.from_numpy(q).to(cuda_device),
                               torch.from_numpy(g).to(cuda_device), 50)
    dv, di = T.cosine_topk(torch.from_numpy(q).to(cuda_device),
                           torch.from_numpy(g).to(cuda_device), 50,
                           method="dense")
    np.testing.assert_array_equal(inds.cpu().numpy(), di.cpu().numpy())
    np.testing.assert_array_equal(vals.cpu().numpy(), dv.cpu().numpy())


# the f32 cases' shapes and split counts, for the bf16 and int8 kernels;
# int8 also at widths that are not a multiple of 4 (codes zero-padded)
_F32_SHAPES = [(40, 60, 32, 20), (33, 2100, 40, 20), (70, 5000, 96, 150),
               (64, 40000, 32, 384), (64, 30000, 32, 150)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,q,g,d,k", [
    (mode, *shape) for mode in ("bfloat16", "int8") for shape in _F32_SHAPES
] + [("int8", 40, 3000, 37, 20), ("int8", 64, 5000, 30, 150)])
def test_quantized_kernels_match_plain_version(cuda_device, mode, q, g, d,
                                               k):
    rng = np.random.default_rng(0)
    qa, ga = _pm1_rows(rng, q, d), _pm1_rows(rng, g, d)
    ga[min(64, g - 1)] = ga[3]
    _launch_and_compare(qa, ga, k, cuda_device, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 37])
def test_int8_kernel_bitwise_on_float_data(cuda_device, d):
    # the int8 scores are exact, so float data compares bitwise too
    rng = np.random.default_rng(2)
    qa = rng.normal(size=(64, d)).astype(np.float32)
    ga = rng.normal(size=(20000, d)).astype(np.float32)
    ok = _launch_and_compare(qa, ga, 150, cuda_device, "int8")
    assert ok.any()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bfloat16", "int8"])
def test_quantized_certificate_fails_on_bin_overflow(cuda_device, mode):
    rng = np.random.default_rng(1)
    q, g = _pm1_rows(rng, 40, 32), _pm1_rows(rng, 70000, 32)
    stride = T.fused_splits(40, 70000, 50, cuda_device) * T.FUSED_BINS
    for j in range(T.FUSED_T_DEPTH + 2):
        g[j * stride] = q[0]
    ok = _launch_and_compare(q, g, 50, cuda_device, mode)
    assert ok[0] == 0 and ok[1:].any()
    qd, gd = (torch.from_numpy(a).to(cuda_device) for a in (q, g))
    vals, inds = T.cosine_topk(qd, gd, 50, matmul_dtype=mode)
    dv, di = T.cosine_topk(qd, gd, 50, matmul_dtype=mode, method="dense")
    np.testing.assert_array_equal(inds.cpu().numpy(), di.cpu().numpy())
    np.testing.assert_array_equal(vals.cpu().numpy(), dv.cpu().numpy())


# ---------------------------------------------------------------------------
# The scores kernel (kernel 4), the ladder of the split kernel and the
# stream probe (csrc/fused_topk.cu, csrc/stream_probe.cu) against their
# plain versions. Shapes ragged on every axis: Q, G not multiples of the
# 64-row tiles, D not a multiple of the 32-word staging step.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("q,g,d", [(37, 1001, 1000), (64, 2100, 96),
                                   (130, 70, 17), (1, 1, 16)])
def test_scores_kernel_matches_plain_version(cuda_device, q, g, d):
    rng = np.random.default_rng(3)
    # ±1 rows: every norm and partial sum exact, so bitwise
    qh = T.l2_normalize(torch.from_numpy(_pm1_rows(rng, q, d))).to(
        cuda_device)
    gd = torch.from_numpy(_pm1_rows(rng, g, d)).to(cuda_device)
    before = T.KERNEL_LAUNCHES["fused_cosine_scores"]
    got = T.fused_cosine_scores(qh, gd)
    assert T.KERNEL_LAUNCHES["fused_cosine_scores"] == before + 1
    want = T.cosine_scores_reference(qh, gd)
    torch.cuda.synchronize()
    assert got.shape == (q, g)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    # float rows: the norms summed in another order, within 1e-5
    qh = T.l2_normalize(torch.randn((q, d), device=cuda_device))
    gd = torch.randn((g, d), device=cuda_device) * 3
    torch.testing.assert_close(T.fused_cosine_scores(qh, gd),
                               T.cosine_scores_reference(qh, gd),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        T.fused_cosine_scores(qh, gd.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
@pytest.mark.parametrize("q,g,d,k", [(40, 60, 32, 20), (70, 5000, 96, 150),
                                     (64, 30000, 37, 384)])
def test_ladder_rungs_match_plain_versions(cuda_device, mode, q, g, d, k):
    rng = np.random.default_rng(4)
    qa, ga = _pm1_rows(rng, q, d), _pm1_rows(rng, g, d)
    ga[min(64, g - 1)] = ga[3]           # tied scores
    qh = T.l2_normalize(torch.from_numpy(qa)).to(cuda_device)
    gd = torch.from_numpy(ga).to(cuda_device)
    if mode == "bfloat16":
        gd = T._prepare_gallery(gd, mode)[0]
    splits = T.fused_splits(q, g, k, cuda_device)
    P.reset_launch_counts()
    for name, rung in P.build_variants().items():
        got = rung.kernel(qh, gd, k)
        want = rung.plain(qh, gd, k, splits=splits)
        torch.cuda.synchronize()
        # ±1 data: every word, sum and score exact, so bitwise
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    launched = {n: c for n, c in P.KERNEL_LAUNCHES.items() if c}
    tag = "f32" if mode == "float32" else "bf16"
    assert launched == {f"fused_topk_{tag}_{r}": 1 for r in P.RUNGS}


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,rows", [(2048, 1536, 256), (1024, 37, 512),
                                      (4096, 100, 2048), (7, 5, 7)])
def test_stream_probe_matches_plain_version(cuda_device, n, d, rows):
    rng = np.random.default_rng(5)
    ints = torch.from_numpy(rng.integers(-3, 4, (n, d)).astype(np.float32)
                            ).to(cuda_device)
    got = P.stream_probe(ints, rows)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  P.stream_probe_reference(ints, rows)
                                  .cpu().numpy())
    x = torch.randn((n, d), device=cuda_device)
    err = (P.stream_probe(x, rows) - P.stream_probe_reference(x, rows)).abs()
    scale = P.stream_probe_reference(x.abs(), rows)
    assert (err <= P.stream_probe_rtol(n, d, rows) * scale).all()
    # repeatable bit for bit: fixed summation order, no atomics
    assert torch.equal(P.stream_probe(x, rows), P.stream_probe(x, rows))


# ---------------------------------------------------------------------------
# AutoAugment kernels (csrc/image_ops.cu) against their plain versions:
# bitwise. Shapes that are not multiples of the kernels' blocks (8,192
# pixels of a plane; 8,192 bytes of rows), a single pixel, and rows wider
# than one staged block.
# ---------------------------------------------------------------------------

_PLANE_SHAPES = [(13, 37, 41), (7, 300, 301), (1, 1, 1), (192, 64, 64)]
_ROW_SHAPES = [(77, 41), (1, 1), (4097, 224), (3, 9000)]


def _edge_planes(rng, shape):
    """Random planes, with a constant plane first (equalize's step == 0)
    and, where it fits, one that uses all 256 values."""
    planes = rng.integers(0, 256, shape, dtype=np.uint8)
    planes[0] = 9
    if shape[0] > 1 and shape[1] * shape[2] >= 256:
        planes[1].reshape(-1)[:256] = np.arange(256)
    return planes


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _PLANE_SHAPES)
def test_histogram_and_lut_kernels_match_plain_version(cuda_device, shape):
    rng = np.random.default_rng(3)
    planes = torch.from_numpy(_edge_planes(rng, shape)).to(cuda_device)
    lut = torch.from_numpy(rng.integers(0, 256, (shape[0], 256)).astype(
        np.int32)).to(cuda_device)
    before = dict(K.KERNEL_LAUNCHES)
    hist = K.plane_histogram(planes)
    out = K.lut_apply(planes, lut)
    assert K.KERNEL_LAUNCHES["plane_histogram"] == before[
        "plane_histogram"] + 1
    assert K.KERNEL_LAUNCHES["lut_apply"] == before["lut_apply"] + 1
    torch.cuda.synchronize()
    assert torch.equal(hist, K.plane_histogram_reference(planes))
    assert int(hist.sum()) == planes.numel()
    assert torch.equal(out, K.lut_apply_reference(planes, lut))


@pytest.mark.cuda
@pytest.mark.parametrize("n,w", _ROW_SHAPES)
def test_row_shift_kernels_match_plain_version(cuda_device, n, w):
    rng = np.random.default_rng(4)
    rows = torch.from_numpy(rng.integers(0, 256, (n, w), dtype=np.uint8)
                            ).to(cuda_device)
    smax = max(1, w // 3)
    shifts = rng.integers(-smax, smax + 1, n).astype(np.int32)
    src0 = rng.uniform(-smax, smax, n).astype(np.float32)
    # the ends of the range, whole numbers, shifts past the row
    for i, (s, f) in enumerate([(-smax, -smax), (smax, smax - 0.5),
                                (w + 3, 0.0), (-w - 3, 2.0 - 2 ** -20)]):
        if i < n:
            shifts[i], src0[i] = s, f
    shifts, src0 = (torch.from_numpy(a).to(cuda_device)
                    for a in (shifts, src0))
    before = dict(K.KERNEL_LAUNCHES)
    out = K.row_shift(rows, shifts)
    cubic = K.row_shift_cubic(rows, src0)
    assert K.KERNEL_LAUNCHES["row_shift"] == before["row_shift"] + 1
    assert K.KERNEL_LAUNCHES["row_shift_cubic"] == before[
        "row_shift_cubic"] + 1
    torch.cuda.synchronize()
    assert torch.equal(out, K.row_shift_reference(rows, shifts))
    assert torch.equal(cubic, K.row_shift_cubic_reference(rows, src0))


@pytest.mark.cuda
def test_policy_on_the_card_matches_the_cpu_table(cuda_device):
    """The same draws through the card's table (kernels, 3-shear rotate)
    and the CPU table (plain versions, gather rotate): equal on every image
    that no rotate touched."""
    from imageretrievalresearch_tpu_torch.ops import autoaugment as A

    rng = np.random.default_rng(5)
    imgs = torch.from_numpy(rng.integers(0, 256, (32, 48, 40, 3),
                                         dtype=np.uint8))
    draws = A.draw_policy(32, torch.Generator().manual_seed(0))
    K.reset_launch_counts()
    card = A.apply_policy(imgs.to(cuda_device),
                          *(d.to(cuda_device) for d in draws)).cpu()
    assert K.KERNEL_LAUNCHES == {"plane_histogram": 2, "lut_apply": 3,
                                 "row_shift_cubic": 1, "row_shift": 6}
    assert not any(K.PLAIN_ON_CARD.values())
    cpu = A.apply_policy(imgs, *draws)
    ops, _, do, _ = draws
    rotated = ((ops == A.ROTATE) & do).any(dim=1)
    assert torch.equal(card[~rotated], cpu[~rotated])


# ---------------------------------------------------------------------------
# Depthwise conv kernels (csrc/depthwise_conv.cu) against their plain
# versions. The forward (and so dx) is bitwise: the kernel rounds each
# product and sum as the plain version does, in its order. The tap
# gradients sum in another order: each tap within 1e-6 of the sum of the
# absolute products (|x| against |g|); f32 reordering moves a sum by a few
# 1e-8 of it, a dropped pixel by 1/(N Ho Wo) of it. Repeated runs are
# bitwise equal. Shapes: C not a multiple of 32 or of the 64-channel block,
# odd H with stride 2, K = 1 and 7, planes smaller than one tile and wider
# than one; the last two give the tap-gradient kernel several (image, tile)
# items per block (grad_w_splits), the first of them with a shorter last
# split, as every b3a layer has at a train step's N = 192.
# ---------------------------------------------------------------------------

from imageretrievalresearch_tpu_torch.ops import depthwise as DW  # noqa: E402

_DW_SHAPES = [(2, 16, 16, 8, 3, 1), (4, 14, 14, 40, 3, 2),
              (2, 13, 9, 144, 5, 2), (3, 7, 7, 1392, 5, 1),
              (2, 9, 9, 8, 7, 1), (2, 15, 11, 72, 7, 2),
              (1, 57, 43, 24, 3, 2), (2, 28, 28, 200, 1, 1),
              (5, 112, 112, 40, 3, 1), (43, 112, 112, 40, 3, 1),
              (16, 56, 56, 300, 5, 2)]


def _dw_splits(shape):
    """The tap-gradient kernel's (nsplit, items_per_split) for ``shape``."""
    n, h, w, c, k, s = shape
    ho, wo = DW.out_len(h, k, s), DW.out_len(w, k, s)
    th, tw, cb = DW.tile_plan(ho, wo, c, k, s)
    return DW.grad_w_splits(n, -(-ho // th) * -(-wo // tw), -(-c // cb))


def test_depthwise_shapes_cover_multi_item_splits():
    """Runs without a card: the shapes above reach the kernel's loop over
    several items per block, with and without a shorter last split."""
    assert _dw_splits(_DW_SHAPES[-2]) == (1405, 3)   # 43 x 98 = 4214 items
    assert _dw_splits(_DW_SHAPES[-1]) == (128, 2)    # 10 channel blocks
    assert _dw_splits(_DW_SHAPES[0])[1] == 1


def _dw_inputs(rng, shape, dtype, device):
    n, h, w, c, k, s = shape
    ho, wo = DW.out_len(h, k, s), DW.out_len(w, k, s)
    x = torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n, ho, wo, c)).astype(np.float32))
    taps = torch.from_numpy(rng.normal(size=(k, k, c)).astype(np.float32))
    return (x.to(device, dtype), g.to(device, dtype),
            taps.to(dtype).float().to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _DW_SHAPES)
def test_depthwise_kernels_match_plain_version(cuda_device, shape, dtype):
    rng = np.random.default_rng(6)
    x, g, taps = _dw_inputs(rng, shape, dtype, cuda_device)
    k, s = shape[4], shape[5]
    DW.reset_launch_counts()
    y = DW.depthwise_forward(x, taps, s)
    dw = DW.depthwise_grad_w(x, g, k, s)
    dw_again = DW.depthwise_grad_w(x, g, k, s)
    assert DW.KERNEL_LAUNCHES == {"depthwise_conv_forward": 1,
                                  "depthwise_conv_grad_w": 2}
    torch.cuda.synchronize()
    assert y.dtype == dtype
    assert torch.equal(y, DW.depthwise_forward_reference(x, taps, s))
    want = DW.depthwise_grad_w_reference(x, g, k, s)
    scale = DW.depthwise_grad_w_reference(x.abs(), g.abs(), k, s)
    assert ((dw - want).abs() <= 1e-6 * scale).all()
    assert torch.equal(dw, dw_again)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 13, 9, 144, 5, 2),
                                   (4, 14, 14, 40, 3, 2),
                                   (2, 9, 9, 8, 7, 1)])
def test_depthwise_function_gradients_through_the_kernels(cuda_device,
                                                          shape):
    """The autograd Function on the card: forward, dx (flipped taps on the
    dilated cotangent) and dw, each against cuDNN's grouped conv in true
    f32 (TF32 off), within f32 rounding."""
    import torch.nn.functional as F

    torch.backends.cudnn.allow_tf32 = False
    n, h, w, c, k, s = shape
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(np.float32)
                         ).to(cuda_device).permute(0, 3, 1, 2)
    x.requires_grad_(True)
    wt = torch.from_numpy(rng.normal(size=(c, 1, k, k)).astype(np.float32)
                          ).to(cuda_device).requires_grad_(True)
    DW.reset_launch_counts()
    y = DW.depthwise_conv(x, wt, s)
    ref = F.conv2d(x, wt, stride=s, padding=k // 2, groups=c)
    # a channels-last cotangent, as the model's are: no layout copy
    cot = torch.randn(ref.shape, device=cuda_device).contiguous(
        memory_format=torch.channels_last)
    dx, dw = torch.autograd.grad((y * cot).sum(), (x, wt))
    ex, ew = torch.autograd.grad((ref * cot).sum(), (x, wt))
    assert DW.KERNEL_LAUNCHES == {"depthwise_conv_forward": 2,
                                  "depthwise_conv_grad_w": 1}
    assert not any(DW.PLAIN_ON_CARD.values())
    assert DW.LAYOUT_COPIES["nhwc"] == 0
    for got, want in ((y, ref), (dx, ex), (dw, ew)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_depthwise_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((1, 8, 8, 16), device=cuda_device)
    with pytest.raises(ValueError):
        DW.depthwise_forward(x, torch.zeros((4, 4, 16), device=cuda_device),
                             1)
    with pytest.raises(ValueError):
        DW.depthwise_forward(x, torch.zeros((3, 3, 16), device=cuda_device),
                             3)
    with pytest.raises(ValueError):
        DW.depthwise_forward(x.half(), torch.zeros((3, 3, 16),
                                                   device=cuda_device), 1)
