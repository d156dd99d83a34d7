"""The Swin window attention's plain version and its dispatch, on the CPU
(``ops/attention.py``, ``models/swin.py``).

The plain version is the eager arithmetic that ``WindowAttention.forward``
ran before the kernel existed, moved: it has to stay bitwise what that code
gave, with no mask, a shift mask and a padded grid's mask. The dispatch
sends only CUDA f32 inference with heads 32 wide and windows of at most
208 tokens to the kernel; the CPU, autograd, bf16 and other widths keep
the eager path, and the counters ``swin.attn_fused`` / ``swin.attn_eager``
record which, while a profiler records. The kernel computes the bias
index in closed form, ``relative_position_index``, held here to the JAX
package's index; the kernel itself is compared with the plain version on
the card (``tests/test_torch_cuda_kernels.py``)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu.models import swin as jax_swin

from imageretrievalresearch_tpu_torch.models import swin
from imageretrievalresearch_tpu_torch.ops import attention
from imageretrievalresearch_tpu_torch.utils import profiling


def _eager_before(mod: swin.WindowAttention, x, mask):
    """``WindowAttention.forward`` as it was before the kernel."""
    bn, n, c = x.shape
    hd = c // mod.num_heads
    qkv = mod.qkv(x).reshape(bn, n, 3, mod.num_heads, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
    bias = mod.relative_position_bias_table[mod.relative_position_index]
    attn = attn + bias.reshape(n, n, -1).permute(2, 0, 1)[None].to(
        attn.dtype)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.reshape(bn // nw, nw, mod.num_heads, n, n)
        attn = attn + mask[None, :, None].to(attn.dtype)
        attn = attn.reshape(bn, mod.num_heads, n, n)
    attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
    out = (attn @ v).transpose(1, 2).reshape(bn, n, c)
    return mod.proj(out)


def _module(heads: int, ws: int, seed: int) -> swin.WindowAttention:
    torch.manual_seed(seed)
    mod = swin.WindowAttention(heads * 32, heads, ws)
    with torch.no_grad():
        mod.relative_position_bias_table.normal_()
    return mod


# (heads, window, grid, shift): no mask; stage 1's shift mask (56², 7,
# shift 3); a padded grid's mask (10² padded to 14², no shift); 14-token
# windows, stage 2's shift mask (28², shift 7) and stage 3's none
MASK_CASES = [(3, 7, 7, 0), (3, 7, 56, 3), (6, 7, 10, 0), (6, 14, 28, 7),
              (12, 14, 14, 0)]


@torch.no_grad()
@pytest.mark.parametrize("heads,ws,grid,shift", MASK_CASES)
def test_plain_version_is_the_eager_arithmetic_bitwise(heads, ws, grid,
                                                       shift):
    mod = _module(heads, ws, seed=grid)
    hp, wp = swin._padded(grid, grid, ws)
    m = swin._shift_attn_mask(grid, grid, hp, wp, ws, shift)
    mask = None if m is None else torch.from_numpy(m)
    assert (mask is None) == (grid == ws)
    windows = 2 * (hp // ws) * (wp // ws)
    x = torch.randn((windows, ws * ws, heads * 32))
    assert torch.equal(mod(x, mask), _eager_before(mod, x, mask))
    qkv = mod.qkv(x).reshape(windows, ws * ws, 3, heads, 32)
    table = mod.relative_position_bias_table
    want = attention.window_attention_reference(
        qkv, table, mod.relative_position_index, mask, heads)
    # on a CPU tensor the wrapper runs the plain version, with the index
    # in closed form
    assert torch.equal(attention.window_attention(qkv, table, mask, heads),
                       want)


def _call(device="cuda", dtype=torch.float32, n=196, hd=32,
          requires_grad=False, table_grad=False):
    qkv = SimpleNamespace(is_cuda=device == "cuda", dtype=dtype,
                          shape=(4, n, 3, 12, hd),
                          requires_grad=requires_grad)
    return qkv, SimpleNamespace(dtype=torch.float32,
                                requires_grad=table_grad)


@pytest.mark.parametrize("kw,grad,fused", [
    ({}, False, True),
    ({"n": 49}, False, True),
    ({"n": 169}, False, True),
    ({}, True, True),                    # grad on, nothing requires it
    ({"requires_grad": True}, False, True),   # under no_grad
    ({"requires_grad": True}, True, False),   # autograd: training
    ({"table_grad": True}, True, False),      # Grad-CAM's graph
    ({"device": "cpu"}, False, False),
    ({"dtype": torch.bfloat16}, False, False),  # autocast
    ({"hd": 64}, False, False),
    ({"n": 225}, False, False),
])
def test_dispatch_follows_what_the_call_observes(kw, grad, fused):
    with torch.set_grad_enabled(grad):
        assert attention.takes_kernel(*_call(**kw)) is fused


def test_cpu_tensors_take_the_eager_path():
    qkv = torch.zeros((2, 49, 3, 3, 32))
    mod = _module(3, 7, seed=0)
    for t in (qkv, qkv.bfloat16(), qkv.requires_grad_()):
        assert not attention.takes_kernel(t, mod.relative_position_bias_table)


def test_counters_name_the_path_under_a_profiler(monkeypatch):
    monkeypatch.setattr(profiling, "_COUNTS", {})
    mod = _module(3, 7, seed=1)
    x = torch.randn((4, 49, 96))
    with torch.no_grad():
        mod(x)
        assert profiling.counts() == {}
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            mod(x)
            mod(x)
    assert profiling.counts() == {"swin.attn_eager": 2}


@pytest.mark.parametrize("ws", range(1, 17))
def test_closed_form_index_is_the_reference_index(ws):
    """The bias index the kernel computes, and the port's buffer, equal
    the JAX package's (timm's) for every window up to 16 x 16."""
    want = jax_swin._rel_pos_index(ws).reshape(-1)
    got = attention.relative_position_index(ws)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(swin.WindowAttention(32, 1, ws).relative_position_index,
                       got)


def test_window_attention_refuses_a_window_that_is_not_square():
    qkv = torch.zeros((2, 48, 3, 3, 32))
    with pytest.raises(ValueError, match="square"):
        attention.window_attention(qkv, torch.zeros((169, 3)), None, 3)
