"""Gallery retrieval on the card: cosine scores + exact top-k in the f32,
bf16 and int8 serving modes, and the two-stage ``int8_rerank`` mode.

Counterpart of ``imageretrievalresearch_tpu/ops/retrieval.py``. The fused
streaming top-k (``fused_cosine_topk``) launches one of the hand-written
CUDA kernels in ``csrc/fused_topk.cu`` for CUDA tensors (the variant
follows the gallery's dtype) and runs its plain PyTorch version
(``fused_cosine_topk_reference``) for CPU tensors only. The dense f32
scores with the gallery normalized inside the kernel
(``fused_cosine_scores``, the ``use_pallas`` path) work the same way, with
``cosine_scores_reference`` as the plain version.

Score arithmetic per ``matmul_dtype`` (one definition, :func:`dense_scores`,
shared by the dense path, the certificate repair and the plain fused
version, and matched by the kernels):

- ``float32``: the dense path and the plain versions are true float32 on
  the card (cuBLAS with TF32 off, ``_device.set_float32_precision``), as
  JAX computes on the CPU. The kernels (the fused top-k and the scores
  kernel) run the f32-faithful 3xTF32 product on tensor cores: each
  operand split as big + small (:func:`split_3xtf32`), small·big +
  big·small + big·big accumulated in f32, ~21-22 significant bits per
  product: as close to the exact product as f32 arithmetic is. That holds for
  ``precision='highest'`` and ``'default'`` alike. (On a TPU, JAX's
  'highest' is a multi-pass MXU product too, and its 'default' one
  bf16-truncated pass.) Single-pass TF32 is used nowhere.
- ``bfloat16``: q̂ and the normalized gallery rounded to bf16, products
  accumulated in f32. A product of two bf16 values is exact in f32, so an
  f32 matmul of the upcast operands is JAX's ``preferred_element_type=f32``
  arithmetic apart from the order of accumulation.
- ``int8``: per-row symmetric int8 codes of q̂ and ĝ, an exact int32 dot,
  rescaled as ``s32 * (qs * gsᵀ)`` in JAX's order.

On the CPU the f32 and bf16 dense products accumulate each score in
order over D (:func:`_rowwise_dots`), so a score does not depend on the
tile or shard its row lies in.

Ties go to the lowest gallery index everywhere (``lax.top_k`` order).
``torch.topk`` does not promise that, so ranking uses stable sorts.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from imageretrievalresearch_tpu_torch.losses import COSINE_SIM_EPS
from imageretrievalresearch_tpu_torch.ops import _cuda
from imageretrievalresearch_tpu_torch.utils.profiling import count, span

# Geometry of the CUDA kernels (compile-time constants of csrc/fused_topk.cu;
# the launcher rejects a mismatch). The TPU kernels used 512 bins of depth 6.
FUSED_BINS = 64
FUSED_T_DEPTH = 6
# per-row candidates (nsplit * k) the selection merge holds in its
# registers (MERGE_MAX of csrc/fused_topk.cu: 512 threads x 40)
MERGE_MAX = 20480
# the tensor-core kernels keep each buffer entry's gallery tile as a
# 16-bit ordinal within its split (csrc/fused_topk.cu): tiles per split
# they take
MAX_TILE_ORDINALS = 1 << 16
MATMUL_DTYPES = ("float32", "bfloat16", "int8")
# columns per exact f32 partial product of int8 codes: 127² · 1024 < 2²⁴
_INT8_EXACT_CHUNK = 1024
# gallery rows per tile of the dense path: at D = 1536 one tile's f32
# operands are 100 MB, however large the compact gallery
_DENSE_GALLERY_TILE = 16384

def l2_normalize(x: torch.Tensor, *, eps: float = COSINE_SIM_EPS
                 ) -> torch.Tensor:
    """Row-normalize with torch CosineSimilarity's per-norm eps clamp."""
    x = x.float()
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=eps)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 explicit mantissa bits), ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds: the magnitude's low 13 bits
    rounded off, carrying into the exponent (up to inf past the largest
    TF32 value); inf and nan kept. The kernels' split restated; on the
    card's path it splits the linear kernel's weights (``ops/linear.py``)."""
    x = x.float()
    bits = x.contiguous().view(torch.int32)
    sign = bits & torch.iinfo(torch.int32).min
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    out = (mag | sign).view(torch.float32)
    return torch.where(torch.isnan(x), x, out)


def split_3xtf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(big, small)`` with ``big = tf32_round(x)`` and ``small =
    tf32_round(x - big)``: the operands of the kernels' 3xTF32 product,
    which accumulates small·big + big·small + big·big in f32."""
    big = tf32_round(x)
    return big, tf32_round(x.float() - big)


def _dot_precision(precision: str) -> str:
    """Validate the precision knob. Both settings compute the same f32
    arithmetic here: true f32 on the dense path, 3xTF32 in the kernels
    (see the module docstring)."""
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
    if matmul_dtype not in MATMUL_DTYPES:
        raise ValueError(f"unknown matmul_dtype {matmul_dtype!r}")


def _check_prepared(gallery, matmul_dtype: str, gallery_scale) -> None:
    """A bf16 gallery is pre-normalized, an int8 one pre-quantized (with
    its scales): each must be scored in its own mode."""
    if gallery.dtype == torch.bfloat16 and matmul_dtype != "bfloat16":
        raise ValueError("bfloat16 (pre-normalized) gallery requires "
                         "matmul_dtype='bfloat16'")
    if gallery.dtype == torch.int8:
        if matmul_dtype != "int8":
            raise ValueError("int8 (pre-quantized) gallery requires "
                             "matmul_dtype='int8'")
        if gallery_scale is None:
            raise ValueError("int8 gallery requires gallery_scale (G, 1)")


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


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------

def quantize_rows_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization: ``(codes, scales)`` with
    ``x ≈ codes * scales``, scales (N, 1) f32. Divides the clamped amax by
    127 and x by the scale (IEEE divisions, not reciprocal products) and
    rounds half to even on every device: torch divides a CUDA tensor by a
    Python number as a product with its f32 reciprocal, so 127 is a tensor
    here.

    Of the reference's two int8 arithmetics this is the written one: the
    source text of JAX's ``quantize_rows_int8``, its eager call, and the
    index's host twin ``_np_quantize_rows_int8``, which builds the served
    gallery scales; bit for bit. JAX's jitted query path is the other:
    XLA compiles the division by 127 as a product with the f32
    reciprocal, so its scales may differ by an ulp and a code by one."""
    x = x.float()
    amax = torch.clamp(x.abs().amax(dim=1, keepdim=True), min=1e-12)
    scale = amax / torch.full_like(amax, 127.0)
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale


def quantize_queries_int8(x: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_rows_int8` of (N, D) f32 rows as one kernel launch
    (``quantize_rows_int8_f32`` of ``csrc/fused_topk.cu``, the step that
    the int8 fused top-k runs first) for a CUDA tensor, bitwise equal to
    it; the plain function itself for a CPU tensor."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"expected float32 (N, D), got {x.dtype} "
                         f"{tuple(x.shape)}")
    if _cuda.on_cpu(x):
        return quantize_rows_int8(x)
    n, d = x.shape
    _cuda.check_operand("x", x, torch.float32, (n, d), x.device)
    codes = torch.empty((n, d), dtype=torch.int8, device=x.device)
    scales = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    _cuda.launch("fused_topk", "quantize_rows_int8_f32", x.device, x, n, d,
                 codes, scales)
    return codes, scales


def quantize_rows_int8_residual(x: torch.Tensor):
    """Two-level int8 codes for ``int8_rerank``: the primary codes of
    :func:`quantize_rows_int8` plus int8 codes of the residual. Returns
    ``(codes, scales, res_codes, res_scales, max_primary_norm,
    max_residual_norm)``; the two bounds are 0-d f32 tensors."""
    x = x.float()
    q1, s1 = quantize_rows_int8(x)
    deq1 = q1.float() * s1
    resid = x - deq1
    q2, s2 = quantize_rows_int8(resid)
    g1max = torch.linalg.vector_norm(deq1, dim=1).amax()
    rmax = torch.linalg.vector_norm(resid, dim=1).amax()
    return q1, s1, q2, s2, g1max, rmax


def pack_codes_int32(codes: torch.Tensor) -> torch.Tensor:
    """(G, D) int8 codes -> (G, D/4) int32 lanes of the same bytes, the
    resident form of the ``int8_rerank`` residual codes. D must be a
    multiple of 4."""
    g, d = codes.shape
    if d % 4:
        raise ValueError(f"D={d} not a multiple of 4")
    return codes.contiguous().view(torch.int32)


def _unpack_codes_int32(rows: torch.Tensor) -> torch.Tensor:
    """(…, D/4) int32 packed rows -> (…, D) int8, the exact inverse of
    :func:`pack_codes_int32`."""
    return rows.contiguous().view(torch.int8)


# ---------------------------------------------------------------------------
# Score arithmetic, one definition per matmul_dtype
# ---------------------------------------------------------------------------

def _int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, D) x (N, D) int8 codes -> (M, N) int32, exact: f32 products
    over column chunks of at most 1024, each exact (every partial sum is
    an integer below 127² · 1024 < 2²⁴), summed in int32."""
    out = None
    for lo in range(0, a.shape[1], _INT8_EXACT_CHUNK):
        hi = lo + _INT8_EXACT_CHUNK
        part = torch.matmul(a[:, lo:hi].float(), b[:, lo:hi].float().t())
        part = part.to(torch.int32)
        out = part if out is None else out + part
    return out


def _int8_scores(qq, qs, gq, gs) -> torch.Tensor:
    """int8 score arithmetic (the kernel's): exact int32 dot, then
    ``s32 * (qs * gsᵀ)`` with the product of the scales first."""
    return _int8_dot(qq, gq).float() * (qs * gs.reshape(1, -1))


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
                     gallery_scale=None, gallery_norms=None):
    """The form the score arithmetic consumes, ``(prepared, scale)``:
    f32 -> ĝ; bf16 -> ĝ as bf16; int8 -> codes and (G, 1) scales of ĝ.
    Prepared (bf16 / int8) galleries pass through. Row by row, so a tile
    of rows prepares to the same bits as the whole gallery."""
    if matmul_dtype == "int8":
        if gallery.dtype == torch.int8:
            return gallery, gallery_scale
        return quantize_rows_int8(l2_normalize(gallery))
    if matmul_dtype == "bfloat16":
        if gallery.dtype == torch.bfloat16:
            return gallery, None
        return l2_normalize(gallery).to(torch.bfloat16), None
    return _normalized_gallery(gallery, gallery_norms), None


def _prepare_queries(q_hat, matmul_dtype: str = "float32"):
    """The query side, ``(prepared, scale)``: q̂; q̂ rounded to bf16 and
    widened (exact); int8 codes and (Q, 1) scales of q̂."""
    if matmul_dtype == "int8":
        return quantize_rows_int8(q_hat)
    if matmul_dtype == "bfloat16":
        return q_hat.to(torch.bfloat16).float(), None
    return q_hat.float(), None


def _scores_prepared(q_prep, q_scale, g_prep, g_scale,
                     matmul_dtype: str = "float32") -> torch.Tensor:
    if matmul_dtype == "int8":
        return _int8_scores(q_prep, q_scale, g_prep, g_scale)
    if q_prep.device.type == "cpu":
        return _rowwise_dots(q_prep, g_prep.float())
    return torch.matmul(q_prep, g_prep.float().t())


# elements of the (Q, rows) accumulator per step of _rowwise_dots: at
# ATen's parallel grain (32,768) each pass stays on one thread, so D short
# passes pay no thread hand-offs
_ROWWISE_ELEMENTS = 1 << 15


def _rowwise_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` in f32 on the CPU, each score accumulated over D in
    order by one fused multiply-add per term (``addcmul``): the order of
    the CPU's sgemm on short rows (D <= 64) and of JAX's CPU dot there.
    A score then never depends on the other rows of either operand, which
    sgemm does not promise (it sums a few queries or a gallery tile or
    shard of a few rows in other orders): a row scores the same in any
    tile or shard. Rows of ``b`` are taken in steps that bound the
    accumulator."""
    q, d = a.shape
    # contiguous (D, rows) operands: each term is one broadcast FMA pass
    at, bt = a.t().contiguous(), b.t().contiguous()
    step = max(1, _ROWWISE_ELEMENTS // max(1, q))
    out = torch.empty((q, b.shape[0]), dtype=torch.float32)
    for lo in range(0, b.shape[0], step):
        acc = torch.zeros((q, min(step, b.shape[0] - lo)))
        for k in range(d):
            acc.addcmul_(at[k, :, None], bt[k, None, lo:lo + step])
        out[:, lo:lo + step] = acc
    return out


def _dense_scores(q_hat, gallery, matmul_dtype, gallery_scale=None,
                  gallery_norms=None) -> torch.Tensor:
    return _scores_prepared(
        *_prepare_queries(q_hat, matmul_dtype),
        *_prepare_gallery(gallery, matmul_dtype, gallery_scale,
                          gallery_norms), matmul_dtype)


def dense_scores(q_hat, gallery, matmul_dtype: str = "float32",
                 gallery_scale=None, precision: str = "default",
                 gallery_norms=None) -> torch.Tensor:
    """The one definition of the dense score arithmetic per
    ``matmul_dtype`` (module docstring), on a raw f32 gallery or a
    prepared one (bf16 normalized / int8 codes + scales)."""
    _check_matmul_dtype(matmul_dtype)
    _dot_precision(precision)
    return _dense_scores(q_hat, gallery, matmul_dtype, gallery_scale,
                         gallery_norms)


# ---------------------------------------------------------------------------
# Fused streaming exact top-k: plain version and kernel wrapper
# ---------------------------------------------------------------------------
#
# Contract (from the TPU kernels, imageretrievalresearch_tpu/ops/
# retrieval.py _fused_topk_kernel{,_bf16,_int8} + _stream_topk_update):
# - scores are the mode's dense arithmetic (f32: each gallery row divided
#   by max(norm, eps) BEFORE the dot product);
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
    the state the kernels' insertion chain leaves, run as they run it:
    each split takes its tiles in index order, and each score sinks below
    the stored values that are >= it, swapping with the first one it
    beats; the score it displaces goes on down the same way. So each bin
    holds its top-T in descending order with ties in arrival (index)
    order, except that a displaced score sinks past a stored score equal
    to it (and falls out first when the bin is full). Empty slots are
    (-inf, 0); -inf never enters (-inf > -inf is false)."""
    q, g = s.shape
    rounds = -(-g // (bins * splits))
    pad = rounds * splits * bins - g
    if pad:
        s = torch.nn.functional.pad(s, (0, pad), value=-math.inf)
    s = s.reshape(q, rounds, splits, bins)      # tile = round * S + split
    idx = ((torch.arange(rounds, device=s.device)[:, None, None] * splits
            + torch.arange(splits, device=s.device)[:, None]) * bins
           + torch.arange(bins, device=s.device)).to(torch.int32)
    bv = torch.full((t_depth, q, splits, bins), -math.inf, device=s.device)
    bi = torch.zeros((t_depth, q, splits, bins), dtype=torch.int32,
                     device=s.device)
    for r in range(rounds):
        v, vi = s[:, r], idx[r].expand(q, splits, bins)
        for t in range(t_depth):
            take = v > bv[t]
            bv[t], v = torch.where(take, v, bv[t]), torch.where(take, bv[t], v)
            bi[t], vi = (torch.where(take, vi, bi[t]),
                         torch.where(take, bi[t], vi))
    return bv.permute(1, 2, 0, 3), bi.permute(1, 2, 0, 3)


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
        *, matmul_dtype: str = "float32",
        gallery_scale: torch.Tensor | None = None,
        gallery_norms: torch.Tensor | None = None,
        bins: int = FUSED_BINS, t_depth: int = FUSED_T_DEPTH,
        splits: int = 1
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused kernels: the mode's dense scores
    (:func:`dense_scores`), bins, depth-T buffers, extraction, split merge
    and certificate, on any device. With ``bins=512, t_depth=6, splits=1``
    it is the TPU kernels' geometry. Returns ``(vals (Q,k) f32, inds (Q,k)
    i32, ok (Q,) i32)``."""
    _check_matmul_dtype(matmul_dtype)
    _check_prepared(gallery, matmul_dtype, gallery_scale)
    if k > t_depth * bins:
        raise ValueError(f"k={k} exceeds the buffers ({t_depth}x{bins})")
    return _plain_fused(queries_hat, gallery, k, matmul_dtype, gallery_scale,
                        gallery_norms, bins, t_depth, splits)


def _plain_fused(queries_hat, gallery, k, matmul_dtype, gallery_scale,
                 gallery_norms, bins, t_depth, splits):
    q = queries_hat.shape[0]
    g = gallery.shape[0]
    n_split = _n_splits(g, splits, bins)
    s = _dense_scores(queries_hat, gallery, matmul_dtype, gallery_scale,
                      gallery_norms)                          # (Q, G)
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
    (Q <= 64) fills the card, capped so one row's nsplit * k candidates
    fit the selection merge's registers (``MERGE_MAX``): 132 on an H100
    SXM at k = 150, 80 at k = 256, 53 at k = 384. The count does not
    shrink as Q grows: fewer splits would hold more rows per bin and fail
    the certificate far more often. The card's SM count is read once per
    device."""
    splits = min(_cuda.sm_count(device), max(1, MERGE_MAX // k))
    return _n_splits(g, splits, FUSED_BINS)


def check_tile_ordinals(g: int, n_split: int) -> None:
    """Raise unless each of ``n_split`` splits of a G-row gallery holds at
    most ``MAX_TILE_ORDINALS`` tiles of ``FUSED_BINS`` rows, the
    tensor-core kernels' 16-bit tile ordinals (4,194,304 rows per split)."""
    tiles = -(-g // FUSED_BINS)
    if -(-tiles // n_split) > MAX_TILE_ORDINALS:
        raise ValueError(
            f"G={g} over {n_split} splits needs {-(-tiles // n_split)} "
            f"tiles per split; the tensor-core kernels take at most "
            f"{MAX_TILE_ORDINALS} (16-bit tile ordinals)")


def _work_words(q: int, d: int, k: int, n_split: int, int8: bool) -> int:
    """4-byte words of a fused top-k call's one workspace (``Work`` in
    ``csrc/fused_topk.cu``, which refuses any other size): vals, inds (Q, k)
    and ok (Q) first; then, each from a 64-word boundary, the candidates
    (Q, S, k) twice and the deepest values (Q, S); for int8 also the query
    scales (Q) and codes (Q, D)."""
    def up(n):
        return -(-n // 64) * 64
    cand = q * n_split * k
    end = up(up(up(2 * q * k + q) + cand) + cand) + q * n_split
    end = up(end)
    if int8:
        end = up(up(end + q) + -(-q * d // 4))
    return end


# kernel variant per gallery dtype: (mode, C entry point)
_VARIANTS = {torch.float32: ("float32", "fused_topk_f32"),
             torch.bfloat16: ("bfloat16", "fused_topk_bf16"),
             torch.int8: ("int8", "fused_topk_int8")}


def _fused_cosine_topk_cuda(queries_hat, gallery, k, gallery_norms,
                            gallery_scale):
    """One call of the mode's C entry point, which launches all of its
    kernels (int8: the query quantization first) into one workspace; the
    outputs are views of its first words."""
    dev = queries_hat.device
    _, entry = _VARIANTS[gallery.dtype]
    q, d = queries_hat.shape
    g = gallery.shape[0]
    _cuda.check_operand("queries_hat", queries_hat, torch.float32, (q, d),
                        dev)
    _cuda.check_operand("gallery", gallery, gallery.dtype, (g, d), dev)
    n_split = fused_splits(q, g, k, dev)
    check_tile_ordinals(g, n_split)
    q_in, aux = queries_hat, None
    if gallery.dtype == torch.float32:
        if gallery_norms is None:
            gallery_norms = torch.linalg.vector_norm(gallery, dim=1)
        aux = _cuda.check_operand("gallery_norms", gallery_norms.reshape(-1),
                                  torch.float32, (g,), dev)
    elif gallery.dtype == torch.bfloat16:
        q_in = queries_hat.to(torch.bfloat16)
    else:
        aux = _cuda.check_operand("gallery_scale", gallery_scale.reshape(-1),
                                  torch.float32, (g,), dev)
    words = _work_words(q, d, k, n_split, gallery.dtype == torch.int8)
    work = torch.empty(words, device=dev, dtype=torch.int32)
    _cuda.launch("fused_topk", entry, dev, q_in, gallery, aux, q, g, d, k,
                 n_split, FUSED_BINS, FUSED_T_DEPTH, work, words)
    out = work[:2 * q * k].view(2, q, k)
    return out[0].view(torch.float32), out[1], work[2 * q * k:2 * q * k + q]


def fused_cosine_topk(
        queries_hat: torch.Tensor, gallery: torch.Tensor, k: int,
        *, gallery_norms: torch.Tensor | None = None,
        gallery_scale: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Q, D) normalized queries x (G, D) gallery -> exact top-k
    ``(vals, inds, ok)`` with the per-row certificate ``ok``; replaces
    ``fused_cosine_topk_pallas``. The gallery's dtype picks the variant:

    - float32: the raw gallery (optionally its ``gallery_norms``), f32
      scores (3xTF32 on the card, module docstring);
    - bfloat16: the pre-normalized gallery; q̂ is cast to bf16 here;
    - int8: codes of the normalized gallery with ``gallery_scale`` (G, 1);
      q̂ is quantized by :func:`quantize_rows_int8`'s arithmetic (on the
      card by the kernel's own first launch, bitwise the same).

    CUDA tensors launch the matching kernels of ``csrc/fused_topk.cu``
    (geometry ``FUSED_BINS`` x ``FUSED_T_DEPTH``, :func:`fused_splits`
    gallery splits) in one call of their C entry point, into one
    workspace, or raise. Each is one score stage of one tensor-core
    kernel and streams the gallery once per 64 queries, so at Q <= 64 it
    is bound by the gallery's bytes: it keeps 40 KB of gallery in flight
    per SM (TMA into a ring; f32: each gallery element divided by its
    row's norm once per block, then 3xTF32 products; the insertion of a
    tile spread over the next tile's copies), then selects each split's
    top-k and merges the splits. CPU tensors run
    :func:`fused_cosine_topk_reference` at the same geometry with one
    split. Rows with ``ok == 0`` must be re-ranked densely:
    :func:`cosine_topk` does that."""
    if gallery.dtype not in _VARIANTS:
        raise ValueError(f"unsupported gallery dtype {gallery.dtype}")
    if gallery_norms is not None and gallery.dtype != torch.float32:
        raise ValueError("gallery_norms applies to a float32 gallery only")
    _check_prepared(gallery, _VARIANTS[gallery.dtype][0], gallery_scale)
    _check_fused_k(k)
    return _fused(queries_hat, gallery, k, gallery_norms, gallery_scale)


def _check_fused_k(k: int) -> None:
    if not 1 <= k <= FUSED_T_DEPTH * FUSED_BINS:
        raise ValueError(f"k={k} outside [1, {FUSED_T_DEPTH * FUSED_BINS}]")


def _fused(queries_hat, gallery, k, gallery_norms, gallery_scale):
    """:func:`fused_cosine_topk` on checked arguments."""
    if queries_hat.device.type == "cpu":
        return _plain_fused(queries_hat, gallery, k,
                            _VARIANTS[gallery.dtype][0], gallery_scale,
                            gallery_norms, FUSED_BINS, FUSED_T_DEPTH, 1)
    if queries_hat.device.type != "cuda":
        raise ValueError(f"unsupported device {queries_hat.device}")
    return _fused_cosine_topk_cuda(queries_hat, gallery, k, gallery_norms,
                                   gallery_scale)


# ---------------------------------------------------------------------------
# Dense f32 scores with the gallery normalized in the kernel (use_pallas)
# ---------------------------------------------------------------------------

def cosine_scores_reference(queries_hat: torch.Tensor,
                            gallery: torch.Tensor) -> torch.Tensor:
    """Plain version of the scores kernel: ``q̂ @ (g / max(|g|, eps))ᵀ`` in
    true f32, the eps clamp of :func:`l2_normalize` (TF32 is off on the
    card, ``_device.set_float32_precision``); the kernel computes the same
    function in 3xTF32."""
    _cuda.plain_on_card("cosine_scores_f32", queries_hat)
    return torch.matmul(queries_hat.float(),
                        _normalized_gallery(gallery, None).t())


def fused_cosine_scores(queries_hat: torch.Tensor, gallery: torch.Tensor,
                        *, precision: str = "default") -> torch.Tensor:
    """(Q, D) normalized f32 queries x (G, D) raw f32 gallery -> (Q, G) f32
    cosine scores, the gallery rows normalized inside the kernel; replaces
    ``pallas_cosine_scores``. CUDA tensors launch ``cosine_scores_f32`` of
    ``csrc/fused_topk.cu`` or raise; CPU tensors run
    :func:`cosine_scores_reference`. Both ``precision`` settings run the
    kernel's 3xTF32 product (module docstring); it sums each row's squares
    and the products in its own order, so its scores differ from the plain
    version's by a few 1e-7 on float data (they are equal where every
    operand is exact in TF32 and every partial sum exact)."""
    _dot_precision(precision)
    q, d = queries_hat.shape
    g = gallery.shape[0]
    for name, t in (("queries_hat", queries_hat), ("gallery", gallery)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != d:
            raise ValueError(f"{name}: expected float32 (N, {d}), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if _cuda.on_cpu(queries_hat):
        return cosine_scores_reference(queries_hat, gallery)
    dev = queries_hat.device
    _cuda.check_operand("queries_hat", queries_hat, torch.float32, (q, d),
                        dev)
    _cuda.check_operand("gallery", gallery, torch.float32, (g, d), dev)
    out = torch.empty((q, g), device=dev, dtype=torch.float32)
    _cuda.launch("fused_topk", "cosine_scores_f32", dev, queries_hat,
                 gallery, q, g, d, out)
    return out


def cosine_scores(queries: torch.Tensor, gallery: torch.Tensor, *,
                  use_pallas: bool = False, precision: str = "default"
                  ) -> torch.Tensor:
    """Full (Q, G) cosine matrix of raw queries and gallery (for small
    galleries / in-batch metrics). ``use_pallas`` scores through
    :func:`fused_cosine_scores` (the scores kernel on the card); otherwise
    one f32 matmul of the normalized rows (true f32). Both ``precision``
    settings compute the same arithmetic here (module docstring)."""
    q_hat = l2_normalize(queries)
    if use_pallas:
        return fused_cosine_scores(q_hat, gallery.float(),
                                   precision=precision)
    _dot_precision(precision)
    return torch.matmul(q_hat, l2_normalize(gallery).t())


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
                          full_fallback: Callable,
                          matmul_dtype: str = "float32",
                          gallery_scale=None, gallery_norms=None):
    """Bounded certificate repair, an eager branch on the number of bad
    rows: none -> unchanged; at most RETRY = min(64, Q) -> re-rank those
    rows densely with the same score arithmetic (:func:`_dense_topk`);
    more -> the caller's full dense pass. Counts ``topk.rows`` (Q),
    ``topk.repaired_rows`` and ``topk.fallback_rows`` (Q of a full pass)
    while spans are on."""
    q = q_hat.shape[0]
    retry = min(64, q)
    with span("topk.certificate"):
        count("topk.rows", q)
        bad = torch.nonzero(ok == 0).reshape(-1)
        n_bad = int(bad.numel())
        if n_bad == 0:
            return vals, inds
        if n_bad > retry:
            count("topk.fallback_rows", q)
            return full_fallback()
        count("topk.repaired_rows", n_bad)
        rvals, rinds = _dense_topk(q_hat[bad], gallery, k, matmul_dtype,
                                   gallery_scale=gallery_scale,
                                   gallery_norms=gallery_norms)
        vals, inds = vals.clone(), inds.clone()
        vals[bad] = rvals
        inds[bad] = rinds
        return vals, inds


def _rows(t: torch.Tensor | None, lo: int, hi: int):
    return None if t is None else t[lo:hi]


def _dense_topk(q_hat, gallery, k, matmul_dtype, *, gallery_scale=None,
                gallery_norms=None, query_block: int = 512):
    """Blocked dense ranking: for each query block, the (block, G) scores
    are filled one gallery tile of ``_DENSE_GALLERY_TILE`` rows at a time
    (each tile prepared and scored by the mode's arithmetic, row by row,
    so tiling changes no score), then ranked by :func:`chunked_topk`.
    Only one tile's f32 operands are ever live, never an f32 copy of a
    compact gallery."""
    g = gallery.shape[0]
    out_v, out_i = [], []
    for qlo in range(0, q_hat.shape[0], query_block):
        q_prep, q_scale = _prepare_queries(q_hat[qlo:qlo + query_block],
                                           matmul_dtype)
        sims = torch.empty((q_prep.shape[0], g), dtype=torch.float32,
                           device=q_hat.device)
        for lo in range(0, g, _DENSE_GALLERY_TILE):
            hi = lo + _DENSE_GALLERY_TILE
            sims[:, lo:hi] = _scores_prepared(
                q_prep, q_scale, *_prepare_gallery(
                    gallery[lo:hi], matmul_dtype,
                    _rows(gallery_scale, lo, hi),
                    _rows(gallery_norms, lo, hi)), matmul_dtype)
        v, i = chunked_topk(sims, k)
        out_v.append(v)
        out_i.append(i)
    return torch.cat(out_v), torch.cat(out_i)


def _scores_kernel_topk(q_hat, gallery, k, query_block: int = 512):
    """The ``use_pallas`` dense path: for each block of ``query_block``
    queries, one scores-kernel launch writes the (block, G) f32 scores
    over the raw gallery, ranked by :func:`chunked_topk`."""
    out_v, out_i = [], []
    for lo in range(0, q_hat.shape[0], query_block):
        v, i = chunked_topk(
            fused_cosine_scores(q_hat[lo:lo + query_block], gallery), k)
        out_v.append(v)
        out_i.append(i)
    return torch.cat(out_v), torch.cat(out_i)


def cosine_topk(queries: torch.Tensor, gallery: torch.Tensor, k: int,
                *, query_block: int = 512, method: str = "exact",
                recall_target: float = 0.95, matmul_dtype: str = "float32",
                gallery_scale: torch.Tensor | None = None,
                gallery_norms: torch.Tensor | None = None,
                precision: str = "default", use_pallas: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k cosine retrieval: (Q, D) x (G, D) -> (vals, inds) each (Q, k).

    - ``method='exact'``: on a CUDA device, the fused kernel when
      :func:`_fused_eligible` holds (with the certificate repair), the
      dense path otherwise; on the CPU the dense path (as JAX off-TPU).
    - ``method='fused'`` forces the fused path (on the CPU: its plain
      version); ``method='dense'`` forces the blocked dense path.
    - ``method='approx'``: JAX ranks each dense query block with
      ``lax.approx_max_k(recall_target=...)``, a partial reduce on a TPU
      and the exact top-k on every other backend. The port runs the dense
      path with its exact top-k, which is what JAX computes off the TPU:
      approx equals exact here (recall 1.0), never fused.
      ``recall_target`` must lie in (0, 1], as XLA requires.
    - ``matmul_dtype``: 'float32', 'bfloat16' or 'int8' (module
      docstring); the top-k is exact for the scores of that mode. The
      gallery is raw f32, or prepared: bf16 pre-normalized, or int8 codes
      with ``gallery_scale`` (G, 1).
    - ``gallery_norms``: build-time row norms of a float32 gallery in
      float32 mode.
    - ``precision``: 'default' and 'highest' compute the same f32
      arithmetic here (true f32 on the dense path, 3xTF32 in the
      kernels); 'highest' is refused for bf16/int8.
    - ``use_pallas``: the dense path scores each query block with the
      scores kernel (:func:`fused_cosine_scores`), which normalizes the
      raw f32 gallery itself; the fused top-k is then never taken by
      ``method='exact'``. It needs a raw f32 gallery in float32 mode and
      takes no ``gallery_norms`` (JAX ignores them there; the port raises).
    """
    _check_matmul_dtype(matmul_dtype)
    if gallery_norms is not None and (gallery.dtype != torch.float32
                                      or matmul_dtype != "float32"):
        raise ValueError("gallery_norms applies to a float32 gallery in "
                         "float32 mode only")
    _check_prepared(gallery, matmul_dtype, gallery_scale)
    _check_precision(precision, matmul_dtype)
    if use_pallas and gallery.dtype != torch.float32:
        raise ValueError("use_pallas scores need a raw f32 gallery")
    if use_pallas and matmul_dtype != "float32":
        raise ValueError("use_pallas scores are f32-only; drop use_pallas "
                         f"or matmul_dtype={matmul_dtype!r}")
    if use_pallas and gallery_norms is not None:
        raise ValueError("use_pallas scores normalize the gallery in the "
                         "kernel; gallery_norms would be ignored")
    if method == "approx" and not 0 < recall_target <= 1:
        raise ValueError(f"recall_target={recall_target} out of range "
                         "(0, 1]")
    if method not in ("exact", "dense", "fused", "approx"):
        raise ValueError(f"unknown method {method!r}")
    q, d = queries.shape
    g = gallery.shape[0]
    k = min(k, g)
    q_hat = l2_normalize(queries)
    if method == "fused":
        _check_fused_k(k)
    fused = method == "fused" or (
        method == "exact" and q_hat.device.type == "cuda" and not use_pallas
        and _fused_eligible(q, g, d, k, FUSED_BINS, FUSED_T_DEPTH))
    if matmul_dtype == "float32":
        # the f32 kernel normalizes the raw rows itself
        g_in, g_scale = gallery.float(), None
    else:
        g_in, g_scale = _prepare_gallery(gallery, matmul_dtype,
                                         gallery_scale)

    def dense_rank():
        if use_pallas:
            return _scores_kernel_topk(q_hat, g_in, k, query_block)
        return _dense_topk(q_hat, g_in, k, matmul_dtype,
                           gallery_scale=g_scale, gallery_norms=gallery_norms,
                           query_block=query_block)

    return rank_normalized(q_hat, g_in, k, fused=fused,
                           matmul_dtype=matmul_dtype, gallery_scale=g_scale,
                           gallery_norms=gallery_norms, dense_rank=dense_rank)


def rank_normalized(q_hat: torch.Tensor, gallery: torch.Tensor, k: int, *,
                    fused: bool, matmul_dtype: str = "float32",
                    gallery_scale: torch.Tensor | None = None,
                    gallery_norms: torch.Tensor | None = None,
                    dense_rank: Callable | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of normalized queries ``q_hat`` over one gallery in the
    form the kernels take (raw f32 with optional ``gallery_norms`` in
    float32 mode; bf16 normalized, or int8 codes with ``gallery_scale``):
    the fused kernel and the certificate repair when ``fused``, else
    ``dense_rank`` (by default the blocked dense path). The body of
    :func:`cosine_topk` after q̂, and each shard's ranking in
    ``parallel.gallery.sharded_cosine_topk``."""
    if dense_rank is None:
        def dense_rank():
            return _dense_topk(q_hat, gallery, k, matmul_dtype,
                               gallery_scale=gallery_scale,
                               gallery_norms=gallery_norms)
    if not fused:
        return dense_rank()
    with span("topk.kernel"):
        vals, inds, ok = _fused(q_hat, gallery, k, gallery_norms,
                                gallery_scale)
    return certified_topk_repair(q_hat, gallery, k, vals, inds, ok,
                                 matmul_dtype=matmul_dtype,
                                 gallery_scale=gallery_scale,
                                 gallery_norms=gallery_norms,
                                 full_fallback=dense_rank)


def int8_rerank_topk(queries: torch.Tensor, codes: torch.Tensor,
                     scales: torch.Tensor, res_codes: torch.Tensor,
                     res_scales: torch.Tensor, k: int, *,
                     shortlist: int = 256, rerank_block: int = 128,
                     gallery_norm_bound: torch.Tensor | None = None,
                     residual_norm_bound: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-stage int8 serving: the exact int8 top-``c`` shortlist, then a
    true-f32 re-rank of its two-level codes. Returns ``(vals (Q, k),
    inds (Q, k), margin (Q,))``.

    1. Stage 1, ``c = min(max(shortlist, k), G)``: on a CUDA device the
       int8 fused kernel with the certificate repair, when
       :func:`_fused_eligible` holds; the blocked dense int8 path
       otherwise (and always on the CPU). The kernel keeps its compile-
       time geometry (64 bins x depth 6, :func:`fused_splits` splits)
       where JAX deepens its TPU buffers to t = 8 / 10 for c > 150 / 384:
       the split certificate stays sound at any depth, so c <= 384 stays
       fused, and a shortlist above 384 takes the dense stage 1.
    2. Stage 2, in ``rerank_block`` query blocks: gather the shortlist's
       primary codes and residual codes (``res_codes`` (G, D) int8 or its
       :func:`pack_codes_int32` form) and re-score them in true f32
       against the unquantized q̂. Ties keep stage-1 order (stable sort).

    ``margin = vals[:, k-1] - v1[:, c-1]``; with both norm bounds given it
    becomes the signed certificate ``margin - (|q̂ - deq(q̂)|·g1max +
    |q̂|·rmax)``: > 0 proves the row equals the full-gallery refined
    top-k."""
    q, d = queries.shape
    g = codes.shape[0]
    k = min(k, g)
    c = min(max(shortlist, k), g)
    q_hat = l2_normalize(queries)

    def dense_stage1():
        return _dense_topk(q_hat, codes, c, "int8", gallery_scale=scales)

    if (q_hat.device.type == "cuda"
            and _fused_eligible(q, g, d, c, FUSED_BINS, FUSED_T_DEPTH)):
        v1, i1, ok = _fused(q_hat, codes, c, None, scales)
        v1, i1 = certified_topk_repair(q_hat, codes, c, v1, i1, ok,
                                       matmul_dtype="int8",
                                       gallery_scale=scales,
                                       full_fallback=dense_stage1)
    else:
        v1, i1 = dense_stage1()
    c = v1.shape[1]

    out_v, out_i = [], []
    for lo in range(0, q, rerank_block):
        qblk = q_hat[lo:lo + rerank_block]
        iblk = i1[lo:lo + rerank_block].long()               # (B, c)
        c1 = codes[iblk].float()                             # (B, c, D)
        c2 = res_codes[iblk]
        if c2.dtype == torch.int32:
            c2 = _unpack_codes_int32(c2)
        c2 = c2.float()
        s1 = scales.reshape(-1)[iblk]                        # (B, c)
        s2 = res_scales.reshape(-1)[iblk]
        dots1 = torch.einsum("bd,bcd->bc", qblk, c1)
        dots2 = torch.einsum("bd,bcd->bc", qblk, c2)
        rv, rp = _stable_topk(dots1 * s1 + dots2 * s2, k)
        out_v.append(rv)
        out_i.append(torch.gather(i1[lo:lo + rerank_block], 1, rp))
    vals, inds = torch.cat(out_v), torch.cat(out_i)
    margin = vals[:, k - 1] - v1[:, c - 1]
    if gallery_norm_bound is not None and residual_norm_bound is not None:
        qq, qs = quantize_rows_int8(q_hat)
        q_err = torch.linalg.vector_norm(q_hat - qq.float() * qs, dim=1)
        q_norm = torch.linalg.vector_norm(q_hat, dim=1)
        margin = margin - (q_err * gallery_norm_bound
                           + q_norm * residual_norm_bound)
    return vals, inds, margin
