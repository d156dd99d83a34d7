"""Swin's MLP on the linear kernel (``ops/linear.py``,
``csrc/linear_tf32x3.cu``) and its dispatch in ``models/swin.py``.

On the CPU: the plain version (the kernel's 3xTF32 arithmetic) within
1e-6 (relative, Frobenius) of an f64 product at the eight shapes of a
Swin-S3-B request, rows cut to a few hundred; ``Mlp`` bitwise the eager
``fc2(gelu(fc1(x)))`` wherever the dispatch keeps it (the CPU, autocast,
autograd); the counters ``swin.mlp_fused``, ``swin.mlp_eager`` and
``swin.mlp_macs``; the weight split made once per weight version.

On the card (skipped without one; imports no JAX, run there with
``python -m pytest --noconftest -m cuda tests/test_torch_swin_mlp.py``):
the kernel against f64 at the eight shapes at full size beside cuBLAS's
f32 error, and Swin-S3-B's embedding of 8 images through it against the
eager f32 path.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from imageretrievalresearch_tpu_torch.models import create_model
from imageretrievalresearch_tpu_torch.models import swin as S
from imageretrievalresearch_tpu_torch.ops import _cuda
from imageretrievalresearch_tpu_torch.ops import linear as L
from imageretrievalresearch_tpu_torch.ops.retrieval import tf32_round
from imageretrievalresearch_tpu_torch.utils import profiling

# Swin-S3-B's MLP calls at 64 images of 224 px, (rows M, K, N, GELU): fc1
# then fc2 of stages 1-4 (tokens 3136, 784, 196, 49 an image; C 96, 192,
# 384, 768; hidden 4C)
SHAPES = [(200704, 96, 384, True), (50176, 192, 768, True),
          (12544, 384, 1536, True), (3136, 768, 3072, True),
          (200704, 384, 96, False), (50176, 768, 192, False),
          (12544, 1536, 384, False), (3136, 3072, 768, False)]
# f32's level: the 3xTF32 product keeps ~1e-7 of an f64 one; one TF32
# pass ~1e-3
F64_REL = 1e-6


@pytest.fixture
def cuda_device():
    # decided here, never at import: every xdist worker collects the same
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(m, k, n, seed, device="cpu"):
    """x like a LayerNorm's output, LeCun-normal weights, small biases."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = rng.standard_normal((n, k), dtype=np.float32) * np.float32(k ** -0.5)
    b = rng.standard_normal(n, dtype=np.float32) * np.float32(0.1)
    return tuple(torch.from_numpy(a).to(device) for a in (x, w, b))


def _f64(x, w, b, gelu):
    y = x.double() @ w.double().T + b.double()
    return F.gelu(y) if gelu else y


def _rel(got, want) -> float:
    return ((got.double() - want).norm() / want.norm()).item()


@pytest.mark.parametrize("m,k,n,gelu", SHAPES)
def test_plain_version_within_1e6_of_f64(m, k, n, gelu):
    x, w, b = _operands(min(m, 200), k, n, seed=k + n)
    got = L.linear(x, w, b, gelu)       # a CPU tensor: the plain version
    assert torch.equal(got, L.linear_reference(x, w, b, gelu))
    rel = _rel(got, _f64(x, w, b, gelu))
    assert rel <= F64_REL, rel
    # one TF32 pass would not pass: the split's small parts count
    single = tf32_round(x) @ tf32_round(w).T + b
    assert _rel(F.gelu(single) if gelu else single,
                _f64(x, w, b, gelu)) > 100 * F64_REL


def _mlp(dim=96, seed=0):
    torch.manual_seed(seed)
    return S.Mlp(dim, 4 * dim)


def _eager(mlp, x):
    """``Mlp.forward`` as it was before the kernel."""
    return mlp.fc2(mlp.act(mlp.fc1(x)))


def test_mlp_is_the_eager_arithmetic_bitwise_where_it_stays_eager():
    mlp = _mlp()
    x = torch.randn((2, 49, 96))
    with torch.no_grad():
        assert torch.equal(mlp(x), _eager(mlp, x))
    # autograd: a graph through nn.Linear, and its backward runs
    y = mlp(x)
    assert torch.equal(y, _eager(mlp, x))
    y.sum().backward()
    assert mlp.fc1.weight.grad is not None
    # autocast (bf16 on the CPU)
    with torch.autocast("cpu", dtype=torch.bfloat16), torch.no_grad():
        got, want = mlp(x), _eager(mlp, x)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def _call(device="cuda", dtype=torch.float32, k=96, n=384,
          requires_grad=False, weight_grad=False, bias=True):
    x = SimpleNamespace(is_cuda=device == "cuda", dtype=dtype,
                        device=torch.device(device),
                        requires_grad=requires_grad)
    w = SimpleNamespace(dtype=dtype, shape=(n, k), requires_grad=weight_grad)
    b = SimpleNamespace(dtype=dtype, requires_grad=weight_grad)
    return x, w, b if bias else None


@pytest.mark.parametrize("kw,grad,autocast,fused", [
    ({}, False, False, True),
    ({"k": 384, "n": 96}, False, False, True),      # fc2
    ({"bias": False}, False, False, True),
    ({}, True, False, True),                        # nothing requires grad
    ({"weight_grad": True}, False, False, True),    # a model under no_grad
    ({"weight_grad": True}, True, False, False),    # training
    ({"requires_grad": True}, True, False, False),  # a graph through x
    ({}, False, True, False),                       # autocast
    ({"device": "cpu"}, False, False, False),
    ({"dtype": torch.bfloat16}, False, False, False),
    ({"k": 94}, False, False, False),               # rows not 16-byte chunks
    ({"n": 98}, False, False, False),               # N % 4 != 0
])
def test_dispatch_follows_what_the_call_observes(monkeypatch, kw, grad,
                                                 autocast, fused):
    monkeypatch.setattr(L.torch, "is_autocast_enabled",
                        lambda device_type: autocast)
    with torch.set_grad_enabled(grad):
        assert L.takes_kernel(*_call(**kw)) is fused


def test_counters_name_the_path_and_count_the_macs(monkeypatch):
    monkeypatch.setattr(profiling, "_COUNTS", {})
    mlp = _mlp()
    x = torch.randn((2, 49, 96))
    with torch.no_grad():
        mlp(x)
        assert profiling.counts() == {}
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            mlp(x)
            mlp(x)
    macs = 2 * (2 * 49) * 96 * 384
    assert profiling.counts() == {"swin.mlp_eager": 2,
                                  "swin.mlp_macs": 2 * macs}
    # where the dispatch takes the kernel (here its plain version runs)
    monkeypatch.setattr(profiling, "_COUNTS", {})
    monkeypatch.setattr(L, "takes_kernel", lambda x, w, b: True)
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        y = mlp(x)
    assert profiling.counts() == {"swin.mlp_fused": 1, "swin.mlp_macs": macs}
    h = L.linear_reference(x, mlp.fc1.weight, mlp.fc1.bias, gelu=True)
    assert torch.equal(y, L.linear_reference(h, mlp.fc2.weight,
                                             mlp.fc2.bias))
    assert _rel(y, _eager(mlp.double(), x.double())) <= F64_REL


def test_weight_split_is_made_once_per_weight_version():
    lin = torch.nn.Linear(8, 4)
    hi, lo = L._split_weight(lin.weight)
    again = L._split_weight(lin.weight)
    assert again[0] is hi and again[1] is lo
    torch.testing.assert_close(hi + lo, lin.weight.detach(), rtol=0,
                               atol=1e-7)
    with torch.no_grad():
        lin.weight.mul_(2)                      # in place: a new version
    hi2, lo2 = L._split_weight(lin.weight)
    assert hi2 is not hi and torch.equal(hi2, 2 * hi)
    lin.load_state_dict({"weight": torch.ones(4, 8), "bias": torch.zeros(4)})
    assert torch.equal(L._split_weight(lin.weight)[0], torch.ones(4, 8))
    lin.weight.data = torch.zeros(4, 8)         # a new storage
    assert torch.equal(L._split_weight(lin.weight)[0], torch.zeros(4, 8))


def test_linear_refuses_a_device_that_is_neither_cpu_nor_cuda():
    x, w, b = _operands(4, 8, 6, seed=0)
    with pytest.raises(ValueError, match="unsupported device"):
        L.linear(x.to("meta"), w.to("meta"), b.to("meta"))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,gelu", SHAPES)
def test_kernel_within_1e6_of_f64(cuda_device, m, k, n, gelu):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, b = _operands(m, k, n, seed=k + n, device=cuda_device)
    with _cuda.ledger() as launched, torch.no_grad():
        got = L.linear(x, w, b, gelu)
    assert launched == {"linear_tf32x3_f32": 1}
    want = _f64(x, w, b, gelu)
    lib = F.linear(x, w, b)
    torch.cuda.synchronize()
    rel, lib_rel = _rel(got, want), _rel(F.gelu(lib) if gelu else lib, want)
    print(f"linear kernel ({m}, {k} -> {n}{', GELU' if gelu else ''}): "
          f"rel {rel:.3g} against f64; cuBLAS f32 {lib_rel:.3g}")
    assert rel <= F64_REL, rel
    # the rows past the last whole tile and every column were stored
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[-3:], want[-3:].float(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_kernel_without_bias_and_on_a_ragged_tile(cuda_device):
    x, w, _ = _operands(333, 100, 100, seed=1, device=cuda_device)
    with torch.no_grad():
        got = L.linear(x, w, None)
    assert _rel(got, x.double() @ w.double().T) <= F64_REL


@pytest.mark.cuda
def test_kernel_follows_an_in_place_weight_update(cuda_device):
    x, w, b = _operands(256, 96, 384, seed=2, device=cuda_device)
    with torch.no_grad():
        first = L.linear(x, w, b)
        w.mul_(-1)
        second = L.linear(x, w, b)
    assert _rel(first, _f64(x, -w, b, False)) <= F64_REL
    assert _rel(second, _f64(x, w, b, False)) <= F64_REL


@pytest.mark.cuda
def test_linear_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x, w, b = _operands(64, 96, 384, seed=3, device=cuda_device)
    with torch.no_grad():
        with pytest.raises(ValueError, match="bias"):
            L.linear(x, w, b[:-2])
        with pytest.raises(ValueError, match="K % 4"):
            L.linear(x[:, :94], w[:, :94].contiguous(), b)
    with pytest.raises(ValueError, match="backward"):
        L.linear(x, w.requires_grad_(), b)


@pytest.mark.cuda
def test_swin_s3_base_embedding_through_the_mlp_kernel(cuda_device,
                                                       monkeypatch):
    """swin_s3_base_224's f32 no_grad embedding of 8 images with its MLPs
    on the kernel (two launches a block, 72) within 1e-5 (relative, per
    row) of the eager f32 MLPs' on the card, the window attention kernel
    in both."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model = create_model("swin_s3_base_224", seed=0, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.rand((8, 224, 224, 3), generator=g, device=cuda_device)
    with _cuda.ledger() as launched, torch.no_grad():
        fused = model.embed(x)
    assert launched == {"window_attention_f32": 36, "linear_tf32x3_f32": 72}
    monkeypatch.setattr(L, "takes_kernel", lambda x, w, b: False)
    with _cuda.ledger() as launched, torch.no_grad():
        eager = model.embed(x)
    assert launched == {"window_attention_f32": 36}
    rel = ((fused - eager).norm(dim=1) / eager.norm(dim=1)).max().item()
    print(f"swin_s3_base_224 embedding, MLP kernel vs eager: emb_rel "
          f"{rel:.3g}")
    assert rel <= 1e-5, rel
