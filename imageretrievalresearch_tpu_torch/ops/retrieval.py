"""Gallery retrieval on the card: cosine scores + exact top-k, f32 path.

Counterpart of ``imageretrievalresearch_tpu/ops/retrieval.py``. The fused
streaming top-k (``fused_cosine_topk``) launches the hand-written CUDA
kernel in ``csrc/fused_topk.cu`` for CUDA tensors and runs its plain
PyTorch version (``fused_cosine_topk_reference``) for CPU tensors only.

Precision: on the card every f32 score here is true float32 — TF32 is off
(``_device.set_float32_precision``), and the kernel runs f32 FMAs. That
holds for ``precision='highest'`` and, in this port, for ``'default'`` as
well, which is what JAX computes on the CPU. (On a TPU, JAX's 'default' is
one bf16-truncated MXU pass.) Mapping 'default' to TF32 tensor cores would
need a measured ranking agreement first.

Ties go to the lowest gallery index everywhere (``lax.top_k`` order).
``torch.topk`` does not promise that, so ranking uses stable sorts.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable

import torch

from imageretrievalresearch_tpu_torch.losses import COSINE_SIM_EPS

# Geometry of the CUDA kernel (compile-time constants of csrc/fused_topk.cu;
# the launcher rejects a mismatch). The TPU kernel used 512 bins of depth 6.
FUSED_BINS = 64
FUSED_T_DEPTH = 6
# per-row candidates the merge kernel stages in shared memory (bytes)
_MERGE_SMEM_BUDGET = 160 * 1024

# launches of each hand-written kernel, counted where the wrapper launches it
KERNEL_LAUNCHES = {"fused_cosine_topk": 0}


def reset_launch_counts() -> None:
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet")


def l2_normalize(x: torch.Tensor, *, eps: float = COSINE_SIM_EPS
                 ) -> torch.Tensor:
    """Row-normalize with torch CosineSimilarity's per-norm eps clamp."""
    x = x.float()
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=eps)


def _dot_precision(precision: str) -> str:
    """Validate the precision knob. Both settings are true f32 here (see
    the module docstring)."""
    if precision not in ("default", "highest"):
        raise ValueError(f"unknown precision {precision!r}; "
                         "expected 'default' or 'highest'")
    return precision


def _check_precision(precision: str, matmul_dtype: str) -> None:
    _dot_precision(precision)
    if precision != "default" and matmul_dtype != "float32":
        raise ValueError("precision='highest' applies to the float32 "
                         f"score path only, not matmul_dtype="
                         f"{matmul_dtype!r}")


def _check_matmul_dtype(matmul_dtype: str) -> None:
    if matmul_dtype in ("bfloat16", "int8"):
        raise _not_ported(f"matmul_dtype={matmul_dtype!r}")
    if matmul_dtype != "float32":
        raise ValueError(f"unknown matmul_dtype {matmul_dtype!r}")


def _stable_topk(sims: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lowest index."""
    vals, inds = torch.sort(sims, dim=-1, descending=True, stable=True)
    return vals[..., :k], inds[..., :k]


def chunked_topk(sims: torch.Tensor, k: int, *, chunk: int = 2048
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-stage top-k over the last axis of (B, G), ties to the lowest
    index: stable top-k within each ``chunk``-wide slice, then a stable
    merge of the candidates in chunk order. Indices are int32."""
    b, g = sims.shape
    if g <= chunk or g <= k:
        vals, inds = _stable_topk(sims, min(k, g))
        return vals, inds.to(torch.int32)
    n_chunks = -(-g // chunk)
    pad = n_chunks * chunk - g
    if pad:
        sims = torch.nn.functional.pad(sims, (0, pad), value=-math.inf)
    kk = min(k, chunk)
    vals, inds = _stable_topk(sims.reshape(b, n_chunks, chunk), kk)
    base = (torch.arange(n_chunks, device=sims.device) * chunk)[None, :, None]
    inds = (inds + base).reshape(b, n_chunks * kk)
    mvals, mpos = _stable_topk(vals.reshape(b, n_chunks * kk), k)
    return mvals, torch.gather(inds, 1, mpos).to(torch.int32)


def _normalized_gallery(gallery: torch.Tensor,
                        gallery_norms: torch.Tensor | None) -> torch.Tensor:
    """ĝ = g / max(|g|, eps): with build-time norms when given, else the
    same clamped arithmetic as :func:`l2_normalize`."""
    g = gallery.float()
    if gallery_norms is None:
        gallery_norms = torch.linalg.vector_norm(g, dim=1)
    return g / torch.clamp(gallery_norms.reshape(-1, 1).float(),
                           min=COSINE_SIM_EPS)


def _prepare_gallery(gallery, matmul_dtype: str = "float32",
                     gallery_scale=None):
    """The f32 serving form: the L2-normalized gallery."""
    _check_matmul_dtype(matmul_dtype)
    return l2_normalize(gallery), None


def _scores_prepared(q_hat, g_prep, g_scale, matmul_dtype: str = "float32",
                     precision: str = "default") -> torch.Tensor:
    _check_matmul_dtype(matmul_dtype)
    _dot_precision(precision)
    return torch.matmul(q_hat.float(), g_prep.t())


def dense_scores(q_hat, gallery, matmul_dtype: str = "float32",
                 gallery_scale=None, precision: str = "default"
                 ) -> torch.Tensor:
    """The one definition of the dense f32 score arithmetic: normalize the
    gallery, then q̂·ĝᵀ in true f32."""
    g_prep, gs = _prepare_gallery(gallery, matmul_dtype, gallery_scale)
    return _scores_prepared(q_hat, g_prep, gs, matmul_dtype, precision)


# ---------------------------------------------------------------------------
# Fused streaming exact top-k: plain version and kernel wrapper
# ---------------------------------------------------------------------------
#
# Contract (from the TPU kernel, imageretrievalresearch_tpu/ops/retrieval.py
# _fused_topk_kernel + _stream_topk_update):
# - each gallery row is divided by max(norm, eps) BEFORE the dot product;
# - scores fold into per-bin buffers of depth T, bin = global index mod
#   BINS; a new value sinks below stored values that are >= it, so ties
#   keep the lower index on top;
# - the exact top-k of the buffered candidates is extracted, ties to the
#   lowest index;
# - the gallery may be cut into splits, each with its own buffers: tiles
#   of BINS rows are dealt round-robin (tile t to split t mod S), so
#   consecutive near-duplicates spread over splits as well as bins; the
#   splits' candidates merge into the final top-k;
# - certificate: ok[q] = AND over splits of (deepest stored value of the
#   split < final k-th value). With one split this is the TPU kernel's
#   certificate. It is sound: an item missing from a split's buffers
#   scores at most that split's deepest stored value.


def _bin_buffers(s: torch.Tensor, bins: int, t_depth: int, splits: int):
    """(Q, G) scores -> per-split, per-bin depth-T buffers (Q, S, T, bins),
    the state the insertion chain leaves: each bin's top-T in descending
    order, ties in arrival (index) order, empty slots (-inf, 0)."""
    q, g = s.shape
    rounds = -(-g // (bins * splits))
    pad = rounds * splits * bins - g
    if pad:
        s = torch.nn.functional.pad(s, (0, pad), value=-math.inf)
    s = s.reshape(q, rounds, splits, bins)      # tile = round * S + split
    v, rnd = torch.sort(s, dim=1, descending=True, stable=True)
    v, rnd = v[:, :t_depth], rnd[:, :t_depth]
    split = torch.arange(splits, device=s.device)[:, None]
    idx = (rnd * splits + split) * bins + torch.arange(bins, device=s.device)
    # -inf never enters the chain (-inf > -inf is false): init slots stay
    idx = torch.where(v == -math.inf, torch.zeros_like(idx), idx)
    if v.shape[1] < t_depth:
        fill = t_depth - v.shape[1]
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, fill),
                                    value=-math.inf)
        idx = torch.nn.functional.pad(idx, (0, 0, 0, 0, 0, fill), value=0)
    return v.transpose(1, 2), idx.transpose(1, 2).to(torch.int32)


def _extract(bv: torch.Tensor, bi: torch.Tensor, k: int):
    """k max+mask passes, ties to the lowest index; removed entries become
    -inf and keep their index (the TPU kernel's epilogue, verbatim)."""
    int_max = torch.iinfo(bi.dtype).max
    bv = bv.clone()
    vals, inds = [], []
    for _ in range(k):
        m = bv.max(dim=1, keepdim=True).values
        is_m = bv == m
        mi = torch.where(is_m, bi, int_max).min(dim=1, keepdim=True).values
        vals.append(m)
        inds.append(mi)
        bv = torch.where(is_m & (bi == mi), -math.inf, bv)
    return torch.cat(vals, 1), torch.cat(inds, 1)


def fused_cosine_topk_reference(
        queries_hat: torch.Tensor, gallery: torch.Tensor, k: int,
        *, gallery_norms: torch.Tensor | None = None,
        bins: int = FUSED_BINS, t_depth: int = FUSED_T_DEPTH,
        splits: int = 1
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused kernel: bins, depth-T buffers,
    extraction, split merge and certificate, on any device. With
    ``bins=512, t_depth=6, splits=1`` it is the TPU kernel's geometry.
    Returns ``(vals (Q,k) f32, inds (Q,k) i32, ok (Q,) i32)``."""
    q = queries_hat.shape[0]
    g = gallery.shape[0]
    if k > t_depth * bins:
        raise ValueError(f"k={k} exceeds the buffers ({t_depth}x{bins})")
    n_split = _n_splits(g, splits, bins)
    g_hat = _normalized_gallery(gallery, gallery_norms)
    s = torch.matmul(queries_hat.float(), g_hat.t())          # (Q, G)
    bv, bi = _bin_buffers(s, bins, t_depth, n_split)          # (Q, S, T, B)
    tth = bv[:, :, -1, :].amax(dim=2)                         # (Q, S)
    cv, ci = _extract(bv.reshape(q * n_split, -1),
                      bi.reshape(q * n_split, -1), k)
    cv, ci = cv.reshape(q, n_split * k), ci.reshape(q, n_split * k)
    # merge: union sorted by (value desc, index asc)
    order = torch.sort(ci, dim=1, stable=True).indices
    cv, ci = torch.gather(cv, 1, order), torch.gather(ci, 1, order)
    vals, pos = _stable_topk(cv, k)
    inds = torch.gather(ci, 1, pos)
    ok = (tth < vals[:, k - 1:k]).all(dim=1)
    return vals, inds.to(torch.int32), ok.to(torch.int32)


def _n_splits(g: int, splits: int, bins: int) -> int:
    """Splits actually used: no more than the gallery has tiles."""
    return max(1, min(splits, -(-g // bins)))


def fused_splits(q: int, g: int, k: int, device: torch.device) -> int:
    """The gallery splits the kernel uses: one per SM, so one query tile
    (Q <= 64) fills the card, capped so one row's candidates fit the merge
    kernel's shared memory. The count does not shrink as Q grows: fewer
    splits would hold more rows per bin and fail the certificate far more
    often."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = min(sms, max(1, _MERGE_SMEM_BUDGET // (8 * k + 4)))
    return _n_splits(g, splits, FUSED_BINS)


def _fused_cosine_topk_cuda(queries_hat, gallery, k, gallery_norms):
    from imageretrievalresearch_tpu_torch.ops import _cuda

    dev = queries_hat.device
    for name, t in (("queries_hat", queries_hat), ("gallery", gallery)):
        if t.device != dev or t.dtype != torch.float32 or t.ndim != 2:
            raise ValueError(f"{name}: expected a 2-D float32 tensor on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    q, d = queries_hat.shape
    g = gallery.shape[0]
    if gallery.shape[1] != d:
        raise ValueError(f"gallery width {gallery.shape[1]} != {d}")
    if gallery_norms is None:
        gallery_norms = torch.linalg.vector_norm(gallery, dim=1)
    gallery_norms = gallery_norms.reshape(-1)
    if (gallery_norms.shape[0] != g or gallery_norms.device != dev
            or gallery_norms.dtype != torch.float32):
        raise ValueError("gallery_norms: expected (G,) float32 on the "
                         "gallery's device")
    gallery_norms = gallery_norms.contiguous()
    n_split = fused_splits(q, g, k, dev)
    cand_v = torch.empty((q, n_split, k), device=dev, dtype=torch.float32)
    cand_i = torch.empty((q, n_split, k), device=dev, dtype=torch.int32)
    tth = torch.empty((q, n_split), device=dev, dtype=torch.float32)
    vals = torch.empty((q, k), device=dev, dtype=torch.float32)
    inds = torch.empty((q, k), device=dev, dtype=torch.int32)
    ok = torch.empty((q,), device=dev, dtype=torch.int32)
    lib = _cuda.load_library()
    p = ctypes.c_void_p
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_topk_f32(
            p(queries_hat.data_ptr()), p(gallery.data_ptr()),
            p(gallery_norms.data_ptr()), q, g, d, k, n_split,
            FUSED_BINS, FUSED_T_DEPTH,
            p(cand_v.data_ptr()), p(cand_i.data_ptr()), p(tth.data_ptr()),
            p(vals.data_ptr()), p(inds.data_ptr()), p(ok.data_ptr()),
            p(stream))
    if err != 0:
        raise RuntimeError(f"fused_topk_f32 launch failed: CUDA error "
                           f"{err} ({_cuda.error_string(err)})")
    KERNEL_LAUNCHES["fused_cosine_topk"] += 1
    return vals, inds, ok


def fused_cosine_topk(
        queries_hat: torch.Tensor, gallery: torch.Tensor, k: int,
        *, gallery_norms: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Q, D) normalized queries x (G, D) raw f32 gallery -> exact top-k
    ``(vals, inds, ok)`` with the per-row certificate ``ok``; replaces
    ``fused_cosine_topk_pallas`` (f32 branch). Scores are true f32.

    CUDA tensors launch the kernel of ``csrc/fused_topk.cu`` (geometry
    ``FUSED_BINS`` x ``FUSED_T_DEPTH``, :func:`fused_splits` gallery
    splits) or raise. CPU tensors run :func:`fused_cosine_topk_reference`
    at the same geometry with one split. Rows with ``ok == 0`` must be
    re-ranked densely: :func:`cosine_topk` does that."""
    if gallery.dtype != torch.float32:
        raise _not_ported(f"a {gallery.dtype} gallery in the fused kernel")
    if not 1 <= k <= FUSED_T_DEPTH * FUSED_BINS:
        raise ValueError(f"k={k} outside [1, {FUSED_T_DEPTH * FUSED_BINS}]")
    if queries_hat.device.type == "cpu":
        return fused_cosine_topk_reference(queries_hat, gallery, k,
                                           gallery_norms=gallery_norms)
    if queries_hat.device.type != "cuda":
        raise ValueError(f"unsupported device {queries_hat.device}")
    return _fused_cosine_topk_cuda(queries_hat, gallery, k, gallery_norms)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _fused_eligible(q: int, g: int, d: int, k: int,
                    bins: int, t_depth: int) -> bool:
    """Fused-kernel guard, the JAX thresholds: enough queries and gallery
    to amortize, D bounded, k fits the candidate buffers."""
    return (q >= 32 and g >= 4 * bins and d <= 2048
            and k <= t_depth * bins and k <= 1024)


def certified_topk_repair(q_hat, gallery, k, vals, inds, ok, *,
                          full_fallback: Callable, gallery_norms=None,
                          precision: str = "default"):
    """Bounded certificate repair, an eager branch on the number of bad
    rows: none -> unchanged; at most RETRY = min(64, Q) -> re-rank those
    rows densely with the same score arithmetic; more -> the caller's full
    dense pass."""
    q = q_hat.shape[0]
    retry = min(64, q)
    bad = torch.nonzero(ok == 0).reshape(-1)
    n_bad = int(bad.numel())
    if n_bad == 0:
        return vals, inds
    if n_bad > retry:
        return full_fallback()
    g_hat = _normalized_gallery(gallery, gallery_norms)
    sims = _scores_prepared(q_hat[bad], g_hat, None, "float32", precision)
    rvals, rinds = chunked_topk(sims, k)
    vals, inds = vals.clone(), inds.clone()
    vals[bad] = rvals
    inds[bad] = rinds
    return vals, inds


def cosine_topk(queries: torch.Tensor, gallery: torch.Tensor, k: int,
                *, query_block: int = 512, method: str = "exact",
                matmul_dtype: str = "float32",
                gallery_norms: torch.Tensor | None = None,
                precision: str = "default", use_pallas: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k cosine retrieval: (Q, D) x (G, D) -> (vals, inds) each (Q, k).

    - ``method='exact'``: on a CUDA device, the fused kernel when
      :func:`_fused_eligible` holds (with the certificate repair), the
      dense path otherwise; on the CPU the dense path (as JAX off-TPU).
    - ``method='fused'`` forces the fused path (on the CPU: its plain
      version); ``method='dense'`` forces the blocked dense path.
    - ``gallery_norms``: build-time row norms of the f32 gallery.
    - ``precision``: 'default' and 'highest' are both true f32 here.

    ``method='approx'``, ``use_pallas`` and the bf16/int8 modes are not
    ported yet."""
    _check_matmul_dtype(matmul_dtype)
    _check_precision(precision, matmul_dtype)
    if use_pallas:
        raise _not_ported("use_pallas")
    if method == "approx":
        raise _not_ported("method='approx'")
    if method not in ("exact", "dense", "fused"):
        raise ValueError(f"unknown method {method!r}")
    if gallery_norms is not None and gallery.dtype != torch.float32:
        raise ValueError("gallery_norms applies to a float32 gallery only")
    q, d = queries.shape
    g = gallery.shape[0]
    k = min(k, g)
    q_hat = l2_normalize(queries)
    fused = method == "fused" or (
        method == "exact" and q_hat.device.type == "cuda"
        and _fused_eligible(q, g, d, k, FUSED_BINS, FUSED_T_DEPTH))

    def dense_rank():
        g_hat = _normalized_gallery(gallery, gallery_norms)
        out_v, out_i = [], []
        for lo in range(0, q, query_block):
            sims = _scores_prepared(q_hat[lo:lo + query_block], g_hat, None,
                                    matmul_dtype, precision)
            v, i = chunked_topk(sims, k)
            out_v.append(v)
            out_i.append(i)
        return torch.cat(out_v), torch.cat(out_i)

    if not fused:
        return dense_rank()
    vals, inds, ok = fused_cosine_topk(q_hat, gallery.float(), k,
                                       gallery_norms=gallery_norms)
    return certified_topk_repair(q_hat, gallery, k, vals, inds, ok,
                                 gallery_norms=gallery_norms,
                                 precision=precision,
                                 full_fallback=dense_rank)
