"""The port's depthwise conv (``ops/depthwise.py``) against the JAX
package's Pallas depthwise kernel in interpret mode (``_dw_op(...,
interpret=True)``), forward and both gradients, at JAX's tolerances on
JAX's own cases; the layer's opt-in and its state-dict layout; the
kernels' tile plan. On the CPU the port's Function runs the kernels' plain
versions through the same wiring (flip, dilation, high pad) as on the card.
"""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from imageretrievalresearch_tpu.ops.pallas_conv import _dw_op
from imageretrievalresearch_tpu_torch.models import create_model
from imageretrievalresearch_tpu_torch.models.layers import DepthwiseConv2d
from imageretrievalresearch_tpu_torch.ops import _cuda
from imageretrievalresearch_tpu_torch.ops import depthwise as DW

# tests/test_pallas_conv.py's cases: (N, H, W, C, K, stride)
CASES = [
    (2, 16, 16, 8, 3, 1),
    (4, 14, 14, 40, 3, 2),
    (1, 15, 15, 8, 5, 1),
    (2, 13, 9, 144, 5, 2),
    (8, 7, 7, 160, 3, 1),
    (2, 9, 9, 8, 7, 1),
]
GOLDEN = Path(__file__).resolve().parent / "golden"


@pytest.fixture(scope="module")
def jax_runs():
    """Each case through the Pallas kernel (interpret mode) once: seeded
    numpy x, w and cotangent -> the output and the vjp's dx, dw."""
    rng = np.random.default_rng(0)
    runs = {}
    for case in CASES:
        n, h, w, c, k, s = case
        ho, wo = DW.out_len(h, k, s), DW.out_len(w, k, s)
        x = rng.normal(size=(n, h, w, c)).astype(np.float32)
        wt = rng.normal(size=(k, k, 1, c)).astype(np.float32)
        cot = rng.normal(size=(n, ho, wo, c)).astype(np.float32)
        out, vjp = jax.vjp(lambda a, b, s=s: _dw_op(a, b, s, True),
                           jnp.asarray(x), jnp.asarray(wt))
        dx, dw = vjp(jnp.asarray(cot))
        runs[case] = {"x": x, "w": wt, "cot": cot, "out": np.asarray(out),
                      "dx": np.asarray(dx), "dw": np.asarray(dw)}
    return runs


def _port(run, s):
    x = torch.from_numpy(run["x"]).requires_grad_(True)
    w = torch.from_numpy(run["w"]).requires_grad_(True)
    out = DW.depthwise_conv2d(x, w, stride=s)
    dx, dw = torch.autograd.grad(out, (x, w),
                                 torch.from_numpy(run["cot"]))
    return out.detach().numpy(), dx.numpy(), dw.numpy()


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax_kernel(jax_runs, case):
    run = jax_runs[case]
    out, _, _ = _port(run, case[5])
    assert out.shape == run["out"].shape
    np.testing.assert_allclose(out, run["out"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_grads_match_jax_kernel(jax_runs, case):
    run = jax_runs[case]
    _, dx, dw = _port(run, case[5])
    assert dx.shape == run["x"].shape and dw.shape == run["w"].shape
    np.testing.assert_allclose(dx, run["dx"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dw, run["dw"], rtol=1e-4, atol=1e-4)


def test_conv_dw_key_and_shape_unchanged():
    """The b3a state dict keeps timm's keys and shapes: ``conv_dw.weight``
    is (C, 1, K, K), so timm dicts and params_from_jax load unchanged."""
    model = create_model("efficientnet_b3a", device="cpu", seed=None)
    got = {k: list(v.shape) for k, v in model.net.state_dict().items()}
    golden = json.loads((GOLDEN / "efficientnet_b3a.keys.json").read_text())
    assert got == {k: list(v) for k, v in golden.items()}
    dws = [m for m in model.modules() if isinstance(m, DepthwiseConv2d)]
    assert len(dws) == 26
    assert model.net.blocks[1][0].conv_dw.weight.shape == (144, 1, 3, 3)


def _tiny_model():
    return create_model("efficientnet_b3a", num_classes=5, width_mult=0.5,
                        depth_mult=0.1, drop_rate=0.0, device="cpu", seed=3)


def test_opt_in_runs_the_plain_versions_on_a_cpu_tensor(monkeypatch):
    """With IRT_FORCE_PALLAS_DW set, a CPU tensor goes through the
    Function's plain versions, never the grouped conv, and agrees with the
    grouped conv's forward and gradients (eval mode: BatchNorm over the
    tiny model's 1 x 1 maps of 4 images would amplify rounding)."""
    model = _tiny_model()
    x = torch.from_numpy(np.random.default_rng(1).random(
        (4, 32, 32, 3), dtype=np.float32))

    def run():
        model.zero_grad()
        out = model(x)
        out.square().sum().backward()
        return out.detach(), [p.grad.clone() for p in model.parameters()]

    monkeypatch.delenv("IRT_FORCE_PALLAS_DW", raising=False)
    want, want_g = run()
    monkeypatch.setenv("IRT_FORCE_PALLAS_DW", "1")

    def no_grouped_conv(*args):
        raise AssertionError("the grouped conv ran with the opt-in set")

    monkeypatch.setattr(DepthwiseConv2d, "_conv_forward", no_grouped_conv)
    with _cuda.ledger() as recorded:
        got, got_g = run()
    assert not recorded     # no launch, no nhwc_copy
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)


def test_opt_in_raises_on_a_device_it_does_not_take(monkeypatch):
    """Neither CPU nor CUDA: the wrappers raise, nothing falls back."""
    monkeypatch.setenv("IRT_FORCE_PALLAS_DW", "1")
    layer = DepthwiseConv2d(8, 3).to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        layer(torch.empty((1, 8, 6, 6), device="meta"))


@pytest.mark.parametrize("k,s", [(4, 1), (9, 1), (3, 3)])
def test_rejects_what_the_kernels_do_not_take(k, s):
    x = torch.zeros((1, 8, 8, 4))
    with pytest.raises(ValueError):
        DW.depthwise_forward(x, torch.zeros((k, k, 4)), s)
    with pytest.raises(ValueError):
        DW.depthwise_conv(x.permute(0, 3, 1, 2), torch.zeros((4, 1, k, k)),
                          s)


def test_autocast_gives_the_op_bf16_and_the_parameter_an_f32_gradient(
        monkeypatch):
    """Under autocast the op takes x and the weight in bf16, as a conv's
    inputs are cast; the f32 parameter gets an f32 gradient close to the
    grouped conv's under the same autocast."""
    rng = np.random.default_rng(2)
    layer = DepthwiseConv2d(24, 5, stride=2)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(
            rng.normal(size=(24, 1, 5, 5)).astype(np.float32)))
    x = torch.from_numpy(rng.normal(size=(2, 11, 13, 24)).astype(
        np.float32)).permute(0, 3, 1, 2)

    def run(opt_in):
        if opt_in:
            monkeypatch.setenv("IRT_FORCE_PALLAS_DW", "1")
        else:
            monkeypatch.delenv("IRT_FORCE_PALLAS_DW", raising=False)
        layer.zero_grad()
        with torch.autocast("cpu", dtype=torch.bfloat16):
            y = layer(x)
        y.float().square().sum().backward()
        return y, layer.weight.grad.clone()

    y, g = run(True)
    ry, rg = run(False)
    assert y.dtype == ry.dtype == torch.bfloat16
    assert g.dtype == torch.float32
    torch.testing.assert_close(y.float(), ry.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(g, rg, rtol=3e-2, atol=3e-2 * rg.abs().max())


# b3a's depthwise layers at 224 px, (C, H, K, stride), and ragged ones
_PLAN_SHAPES = [(40, 112, 3, 1), (24, 112, 3, 1), (144, 112, 3, 2),
                (192, 56, 3, 1), (192, 56, 5, 2), (288, 28, 5, 1),
                (288, 28, 3, 2), (576, 14, 3, 1), (576, 14, 5, 1),
                (816, 14, 5, 1), (816, 14, 5, 2), (1392, 7, 5, 1),
                (1392, 7, 3, 1), (2304, 7, 3, 1), (8, 9, 7, 1),
                (72, 15, 7, 2), (3, 1, 1, 1), (200, 2, 7, 2)]


@pytest.mark.parametrize("c,h,k,s", _PLAN_SHAPES)
def test_tile_plan_fits_and_covers(c, h, k, s):
    """The forward's and dx's band plans (bf16): channel blocks of a
    multiple of 8 covering C with one short block at most, a band height
    within the output (dx: the input's rows), two buffers within
    BAND_SMEM, bands of even height; the split puts every (image, band)
    item in exactly one split, none empty."""
    for kind in ("forward", "grad_x"):
        out_h = h if kind == "grad_x" else DW.out_len(h, k, s)
        th, cb = DW.band_plan(kind, h, h, c, k, s, 2)
        assert 1 <= th <= out_h and cb % 8 == 0 and 8 <= cb <= 512
        assert (-(-c // cb) - 1) * cb < c
        smem, buf = DW.band_smem(kind, th, cb, h, h, k, s, 2)
        assert smem == 2 * buf <= DW.BAND_SMEM
        bands = -(-out_h // th)
        assert bands * th - out_h < bands
        for n in (1, 8, 192):
            nsplit, per = DW.band_splits(n, bands, -(-c // cb),
                                         DW.BAND_BLOCKS_PER_SM * 132)
            # every (image, band) item in exactly one split, none empty
            assert nsplit * per >= n * bands > (nsplit - 1) * per


def test_dilate_restores_the_dropped_rows():
    """Stride 2 on an odd and an even size: the dilated cotangent has the
    input's size, g's rows at even positions, zeros elsewhere."""
    g = torch.arange(1, 1 + 2 * 3 * 4 * 5, dtype=torch.float32).reshape(
        2, 3, 4, 5)
    for h, w in ((5, 7), (6, 8)):
        assert DW.out_len(h, 3, 2) == 3 and DW.out_len(w, 3, 2) == 4
        d = DW.dilate(g, 2, h, w)
        assert d.shape == (2, h, w, 5)
        assert torch.equal(d[:, 0:5:2, 0:7:2], g)
        assert d.sum() == g.sum()
    assert DW.dilate(g, 1, 3, 4) is g


def test_plain_forward_matches_the_grouped_conv():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(3, 10, 7, 16)).astype(np.float32))
    taps = torch.from_numpy(rng.normal(size=(5, 5, 16)).astype(np.float32))
    got = DW.depthwise_forward_reference(x, taps, 2)
    want = F.conv2d(x.permute(0, 3, 1, 2), taps.permute(2, 0, 1)[:, None],
                    stride=2, padding=2, groups=16).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("c,h,k,s", _PLAN_SHAPES + [(36, 15, 3, 2)])
def test_grad_w_plan_fits_and_covers(c, h, k, s, itemsize):
    """The tap-gradient kernel's plan (bf16 and f32): channel blocks of a
    multiple of 8 covering C with one short block at most, a band height
    within the output, a block's shared memory within BAND_SMEM (two
    blocks per SM); the split puts every (image, band) item of a channel
    block in exactly one split, none empty, and the grid within the
    card's blocks (132 SMs of the H100 SXM, 114 of the PCIe part)."""
    ho = DW.out_len(h, k, s)
    th, cb = DW.band_plan("grad_w", h, h, c, k, s, itemsize)
    assert 1 <= th <= ho and cb % 8 == 0 and 8 <= cb <= 512
    c_blocks = -(-c // cb)
    assert (c_blocks - 1) * cb < c <= c_blocks * cb
    smem, buf = DW.band_smem("grad_w", th, cb, h, h, k, s, itemsize)
    assert smem <= DW.BAND_SMEM and smem >= 2 * buf
    bands = -(-ho // th)
    for n in (1, 8, 192):
        for sms in (132, 114):
            blocks = DW.BAND_BLOCKS_PER_SM * sms
            nsplit, per = DW.band_splits(n, bands, c_blocks, blocks)
            items = n * bands
            owner = [i // per for i in range(items)]
            assert sorted(set(owner)) == list(range(nsplit))
            assert nsplit * c_blocks <= max(blocks, c_blocks)


def test_grad_w_plan_takes_the_fewest_even_bands_of_wide_blocks():
    """At b3a's layer shapes in bf16 the plan keeps channel blocks of at
    least 64 channels (or all of C), each with the fewest bands that fit
    BAND_SMEM, of even height (no band shorter by a row or more). The
    forward's and dx's plans likewise, with blocks of whole 32-byte
    sectors (or all of C) first: narrower than 64 channels only where no
    such wide block fits, and then the widest that does."""
    for kind in ("grad_w", "forward", "grad_x"):
        for c, h, k, s in _PLAN_SHAPES[:14]:
            out_h = h if kind == "grad_x" else DW.out_len(h, k, s)
            th, cb = DW.band_plan(kind, h, h, c, k, s, 2)
            wide = min(-(-c // 8) * 8, 64)
            if kind == "grad_w":
                assert cb >= wide, (kind, c, h, k, s, cb)
            else:
                assert cb >= c or cb * 2 % 32 == 0, (kind, c, h, k, s, cb)
                if cb < wide:   # no wide aligned block fits one row
                    assert all(DW.band_smem(kind, 1, b, h, h, k, s, 2)[0]
                               > DW.BAND_SMEM
                               for b in range(wide, min(c, 512) + 1, 8)
                               if c % b == 0 and (b >= c or b % 16 == 0))
            bands = -(-out_h // th)
            assert bands * th - out_h < bands, (kind, c, h, k, s, th)
            fewer = -(-out_h // (bands - 1)) if bands > 1 else None
            assert fewer is None or DW.band_smem(
                kind, fewer, cb, h, h, k, s, 2)[0] > DW.BAND_SMEM, (
                kind, c, h, k, s, th, cb)


def test_grad_w_plan_constants_match_the_source():
    """The plans' restatement of the band kernels' layout reads the
    source's own constants: the run of output pixels per thread step and
    the threads per block; a block's budget stays under the launchers'
    cap, and two blocks fit an SM's 228 KB (1 KB of it reserved per
    block)."""
    src = _cuda.SOURCES["depthwise_conv"].read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert DW.BAND_RUN == const("RUN")
    assert DW.THREADS == const("THREADS")
    assert DW.BAND_SMEM <= const("GRAD_MAX_SMEM")
    assert DW.BAND_BLOCKS_PER_SM * (DW.BAND_SMEM + 1024) <= 228 * 1024


def _band_restatement(kind, src, taps, h, w, k, s, th):
    """A numpy restatement of ``dw_band_kernel``'s index arithmetic (f32,
    channels vectorized): each band of th output rows stages
    ``band_geometry``'s rows of the source from its first row (forward:
    r0 s - P; dx at stride 2: ceil((r0 - P) / 2); dx at stride 1: r0 - P)
    into a zeroed buffer at the geometry's column offset, then each run of
    BAND_RUN output pixels reads its window of each tap row and adds the
    terms in the kernel's order, skipping dx's zero terms at stride 2."""
    p, run = k // 2, DW.BAND_RUN
    n, sh, sw, c = src.shape
    oh, ow = (h, w) if kind == "grad_x" else (DW.out_len(h, k, s),
                                              DW.out_len(w, k, s))
    dil = kind == "grad_x" and s == 2
    ss = s if kind == "forward" else 1
    rows_in, xw, coff = DW.band_geometry(kind, th, h, w, k, s)
    wr = taps.reshape(k * k, c)[::-1] if kind == "grad_x" else \
        taps.reshape(k * k, c)
    out = np.full((n, oh, ow, c), np.nan, np.float32)
    for img in range(n):
        for r0 in range(0, oh, th):
            sr0 = (r0 - p + 1) >> 1 if dil else r0 * ss - p
            buf = np.zeros((rows_in, xw, c), np.float32)
            for row in range(rows_in):
                if 0 <= sr0 + row < sh:
                    buf[row, coff:coff + sw] = src[img, sr0 + row]
            for y in range(r0, min(r0 + th, oh)):
                for w0 in range(0, ow, run):
                    acc = np.zeros((run, c), np.float32)
                    for i in range(k):
                        if dil and (y - p + i) & 1:
                            continue
                        row = ((y - p + i) >> 1) - sr0 if dil else \
                            (y - r0) * ss + i
                        start = w0 // 2 if dil else w0 * ss
                        for u in range(run):
                            for j in range(k):
                                if dil and (u - p + j) & 1:
                                    continue
                                q = (u - p + j + 2 * ((p + 1) // 2)) // 2 \
                                    if dil else u * ss + j
                                acc[u] += buf[row, start + q] * wr[i * k + j]
                    for u in range(min(run, ow - w0)):
                        out[img, y, w0 + u] = acc[u]
    return out


@pytest.mark.parametrize("kind", ["forward", "grad_x"])
@pytest.mark.parametrize("n,h,w,c,k,s", [(1, 9, 7, 5, 3, 2),
                                         (2, 10, 11, 3, 5, 2),
                                         (1, 8, 9, 4, 3, 1),
                                         (1, 7, 9, 2, 7, 2),
                                         (1, 6, 5, 3, 1, 2)])
def test_band_geometry_restates_the_plain_versions(kind, n, h, w, c, k, s):
    """The band kernels' geometry (``band_geometry``, the plans' source of
    their shared memory) holds every row and window the kernel's index
    arithmetic reads, and that arithmetic, restated in numpy, is bitwise
    equal to the plain forward and the plain dx (the dilated forward with
    flipped taps), for one-row bands, the plan's bands and odd ones. Each
    product and sum is rounded to f32 on its own, as in the kernel."""
    rng = np.random.default_rng(11)
    ho, wo = DW.out_len(h, k, s), DW.out_len(w, k, s)
    taps = rng.normal(size=(k, k, c)).astype(np.float32)
    if kind == "forward":
        src = rng.normal(size=(n, h, w, c)).astype(np.float32)
        want = DW.depthwise_forward_reference(torch.from_numpy(src),
                                              torch.from_numpy(taps), s)
    else:
        src = rng.normal(size=(n, ho, wo, c)).astype(np.float32)
        want = DW.depthwise_grad_x_reference(torch.from_numpy(src),
                                             torch.from_numpy(taps), s, h, w)
    plan_th = DW.band_plan(kind, h, w, c, k, s, 4)[0]
    for th in sorted({1, 3, plan_th}):
        got = _band_restatement(kind, src, taps, h, w, k, s, th)
        np.testing.assert_array_equal(got, want.numpy())
