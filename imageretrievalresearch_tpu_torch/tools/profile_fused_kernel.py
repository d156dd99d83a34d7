"""Per-phase attribution of the fused top-k kernel, and a read ceiling of
device memory, on one CUDA card:

    python -m imageretrievalresearch_tpu_torch.tools.profile_fused_kernel \
        [--trace DIR] [--skip-ceilings]

Counterpart of the JAX package's ``tools/profile_fused_kernel.py``, at its
shapes (G = 100,000, D = 1536, Q = 2048, k = 150). Times are CUDA events
around back-to-back launches with one synchronise (``pipelined_ms``).

1. The ablation ladder of the tensor-core split kernel
   (``csrc/fused_topk.cu``, the phase flag of ``fused_topk_tc_kernel``,
   in its f32, bf16 and int8 score stages), each rung at the production
   kernel's geometry and shared memory:

   - ``stream_only``: the production kernel's TMA copies into the ring
     (or its producer warp's masked loads), every loaded word (and, f32,
     every norm) folded into per-row sums;
   - ``matmul_only``: + the division by the norms (f32) or the rescale
     (int8) and the tensor-core product (f32: 3xTF32); each split's max
     score per query row;
   - ``insert_only``: + the insertion chain; the first k buffer lanes,
     with no extraction and no merge;
   - ``full``: the production kernel (split + merge,
     ``ops.retrieval.fused_cosine_topk``).

   Differences of the rung times attribute the full kernel's time to its
   phases. Phases overlap, so each difference is the cost the other
   phases do not hide. The JAX tool has f32 and bf16 ladders; the int8
   one is the port's own.
2. The row-block stream probe (``csrc/stream_probe.cu``) at block heights
   256-2048 over a (100,352, 1536) f32 array: the read rate a plain
   streaming kernel reaches.
3. A torch elementwise read+write pass over the same array, the library's
   rate.

``--trace DIR`` wraps one burst of the full kernel in
``utils.profiling.trace``. The wrappers here (``build_variants``,
``stream_probe``) launch their kernels for CUDA tensors and run their
plain versions for CPU tensors, as every kernel of the port does.
"""

from __future__ import annotations

import argparse
import functools
import math
import subprocess
import time
from typing import Callable, NamedTuple

import torch

from imageretrievalresearch_tpu_torch._device import resolve_device
from imageretrievalresearch_tpu_torch.ops import _cuda
from imageretrievalresearch_tpu_torch.ops import retrieval as R
from imageretrievalresearch_tpu_torch.utils.profiling import trace

GALLERY = 100_000
DIM = 1536
QUERIES = 2048
K = 150
PROBE_ROWS = (256, 512, 1024, 2048)
# GALLERY rounded up to a multiple of every probe height (JAX: of its
# 512-row tile; the same 100,352)
G_PAD = -(-GALLERY // max(PROBE_ROWS)) * max(PROBE_ROWS)
RUNGS = ("stream_only", "matmul_only", "insert_only")
# gallery dtype -> (its score mode, its name in the C entry points)
_MODES = {torch.float32: ("float32", "f32"),
          torch.bfloat16: ("bfloat16", "bf16"), torch.int8: ("int8", "int8")}


def log(msg: str, _t0: list = []) -> None:
    if not _t0:
        _t0.append(time.time())
    print(f"[{time.time() - _t0[0]:7.1f}s] {msg}", flush=True)


# ---------------------------------------------------------------------------
# The ladder: plain versions
# ---------------------------------------------------------------------------
#
# Every rung works on the split kernel's words: f32 -> q̂ and the raw
# gallery with its norms; bf16 -> q̂ rounded to bf16 and the pre-normalized
# bf16 gallery, both widened to f32 (no norms); int8 -> the codes of q̂ and
# of the normalized gallery (with their scales for the scores). Gallery
# tiles of BINS rows are dealt round-robin to the splits (tile t to split t
# mod S), as in ops.retrieval.


def _mode(gallery: torch.Tensor) -> str:
    if gallery.dtype not in _MODES:
        raise ValueError("the ladder takes a float32 (raw), an int8 (codes) "
                         "or bfloat16 (pre-normalized) gallery, not "
                         f"{gallery.dtype}")
    return _MODES[gallery.dtype][0]


def _norms(gallery, gallery_norms):
    """The f32 norms the kernels divide by (the wrapper's, when none are
    given); None for bf16."""
    if gallery.dtype != torch.float32:
        if gallery_norms is not None:
            raise ValueError("gallery_norms applies to a float32 gallery")
        return None
    if gallery_norms is None:
        return torch.linalg.vector_norm(gallery, dim=1)
    return gallery_norms.reshape(-1).float()


def _n_split(q_hat, gallery, k, splits):
    """The splits a rung uses: ``splits`` (the plain versions) or, on the
    card, the production kernel's own count."""
    if splits is None:
        splits = R.fused_splits(q_hat.shape[0], gallery.shape[0], k,
                                q_hat.device)
    return R._n_splits(gallery.shape[0], splits, R.FUSED_BINS)


def stream_only_reference(q_hat, gallery, k, gallery_norms=None,
                          splits=1, gallery_scale=None) -> torch.Tensor:
    """(Q, S) f32: for query row q and split s, the sum over the split's
    tiles t of (the words of q) + (the words of gallery row
    t·BINS + q mod BINS) + (its norm, f32 only), rows past G counting 0.
    That is every word the rung loads, each added once per tile, in f64
    here (the kernel adds in f32 in its own order: exact on small-integer
    data, else within ``stream_only_rtol`` of the same sum of absolute
    values; int8 codes it sums exactly in int32, so within int32 the
    results are equal). The scales are not words of the stream."""
    mode = _mode(gallery)
    q, g = q_hat.shape[0], gallery.shape[0]
    qw = R._prepare_queries(q_hat, mode)[0].double()
    rows = gallery.double().sum(dim=1)
    norms = _norms(gallery, gallery_norms)
    if norms is not None:
        rows = rows + norms.double()
    n_split = _n_split(q_hat, gallery, k, splits)
    tiles = -(-g // R.FUSED_BINS)
    rows = torch.nn.functional.pad(rows, (0, tiles * R.FUSED_BINS - g))
    owner = torch.arange(tiles, device=gallery.device) % n_split
    per_split = torch.zeros((n_split, R.FUSED_BINS), dtype=torch.float64,
                            device=gallery.device).index_add_(
        0, owner, rows.reshape(tiles, R.FUSED_BINS))
    count = torch.bincount(owner, minlength=n_split).double()
    tile_row = torch.arange(q, device=gallery.device) % R.FUSED_BINS
    out = count[None, :] * qw.sum(dim=1, keepdim=True) + per_split.t()[tile_row]
    return out.float()


def stream_only_rtol(g: int, d: int, splits: int,
                     dtype: torch.dtype = torch.float32) -> float:
    """Bound on |kernel - exact| of ``stream_only`` as a share of the same
    sum of absolute values: the kernel's longest chain of f32 additions
    times 2⁻²⁴. f32: a converter thread owns half of a tile row's 16-byte
    chunks (4 of 8 per 32-word stage); per stage it adds the tree sum of
    its chunks (each chunk's tree sum of q̂ plus that of the gallery: 5
    levels) to its running sum, and once per tile the row's norm; the two
    halves' sums are added at the end. bf16: a thread adds, per ring stage of 64 words,
    the tree sums of its 8-word chunks of q and of the gallery row (4
    levels) to its row's sum; an 8-lane butterfly. int8: 0, the sums are
    exact integers (rounded once to f32, as the reference rounds)."""
    if dtype == torch.int8:
        return 0.0
    tiles = -(-g // R.FUSED_BINS)
    per_split = -(-tiles // splits)
    if dtype == torch.bfloat16:
        return (-(-d // 64) * per_split + 7) * 2.0 ** -24
    return ((-(-d // 32) + 1) * per_split + 6) * 2.0 ** -24


def _scores(q_hat, gallery, gallery_norms, gallery_scale):
    """The mode's dense scores (``ops.retrieval.dense_scores``), (Q, G)."""
    return R._dense_scores(q_hat, gallery, _mode(gallery), gallery_scale,
                           _norms(gallery, gallery_norms))


def matmul_only_reference(q_hat, gallery, k, gallery_norms=None,
                          splits=1, gallery_scale=None) -> torch.Tensor:
    """(Q, S) f32: the max of the mode's dense scores over each split's
    gallery rows."""
    n_split = _n_split(q_hat, gallery, k, splits)
    s = _scores(q_hat, gallery, gallery_norms, gallery_scale)
    q, g = s.shape
    rounds = -(-g // (R.FUSED_BINS * n_split))
    s = torch.nn.functional.pad(s, (0, rounds * n_split * R.FUSED_BINS - g),
                                value=-math.inf)
    return s.reshape(q, rounds, n_split, R.FUSED_BINS).amax(dim=(1, 3))


def insert_only_reference(q_hat, gallery, k, gallery_norms=None, splits=1,
                          gallery_scale=None):
    """((Q, S, k) f32, (Q, S, k) int32): the first k lanes of each split's
    buffers after the insertion chain (``ops.retrieval._bin_buffers``;
    lane t·BINS + b is depth slot t of bin b)."""
    n_split = _n_split(q_hat, gallery, k, splits)
    bv, bi = R._bin_buffers(_scores(q_hat, gallery, gallery_norms,
                                    gallery_scale),
                            R.FUSED_BINS, R.FUSED_T_DEPTH, n_split)
    q = bv.shape[0]
    return (bv.reshape(q, n_split, -1)[..., :k].contiguous(),
            bi.reshape(q, n_split, -1)[..., :k].contiguous())


def _full_reference(q_hat, gallery, k, gallery_norms=None, splits=1,
                    gallery_scale=None):
    return R.fused_cosine_topk_reference(
        q_hat, gallery, k, matmul_dtype=_mode(gallery),
        gallery_norms=gallery_norms, gallery_scale=gallery_scale,
        splits=splits)


_PLAIN = {"stream_only": stream_only_reference,
          "matmul_only": matmul_only_reference,
          "insert_only": insert_only_reference}


# ---------------------------------------------------------------------------
# The ladder: kernel wrappers
# ---------------------------------------------------------------------------

def _rung(name: str, q_hat: torch.Tensor, gallery: torch.Tensor, k: int,
          gallery_norms: torch.Tensor | None = None,
          gallery_scale: torch.Tensor | None = None):
    """Rung ``name`` of the ladder: launches its kernel for CUDA tensors
    (at :func:`ops.retrieval.fused_splits` splits) or raises; runs its
    plain version for CPU tensors (one split). An int8 gallery takes its
    ``gallery_scale`` (G, 1); q̂ is quantized by
    :func:`ops.retrieval.quantize_queries_int8`, as the fused kernel's
    entry point quantizes it."""
    mode = _mode(gallery)
    norms = _norms(gallery, gallery_norms)
    R._check_fused_k(k)
    R._check_prepared(gallery, mode, gallery_scale)
    if _cuda.on_cpu(q_hat):
        return _PLAIN[name](q_hat, gallery, k, gallery_norms, splits=1,
                            gallery_scale=gallery_scale)
    dev = q_hat.device
    q, d = q_hat.shape
    g = gallery.shape[0]
    _cuda.check_operand("queries_hat", q_hat, torch.float32, (q, d), dev)
    _cuda.check_operand("gallery", gallery, gallery.dtype, (g, d), dev)
    if norms is not None:
        _cuda.check_operand("gallery_norms", norms, torch.float32, (g,), dev)
    n_split = _n_split(q_hat, gallery, k, None)
    if mode == "float32":
        operands = (q_hat, gallery, norms)
    elif mode == "bfloat16":
        operands = (q_hat.to(torch.bfloat16), gallery, None)
    else:
        qq, qs = R.quantize_queries_int8(q_hat)
        gs = _cuda.check_operand("gallery_scale", gallery_scale.reshape(-1),
                                 torch.float32, (g,), dev)
        operands = (qq, gallery, qs, gs)
    R.check_tile_ordinals(g, n_split)
    if name == "insert_only":
        out = (torch.empty((q, n_split, k), device=dev, dtype=torch.float32),
               torch.empty((q, n_split, k), device=dev, dtype=torch.int32))
    else:
        out = (torch.empty((q, n_split), device=dev, dtype=torch.float32),
               None)
    entry = f"fused_topk_{_MODES[gallery.dtype][1]}_{name}"
    _cuda.launch("fused_topk", entry, dev, *operands, q, g, d, k, n_split,
                 *out)
    return out if name == "insert_only" else out[0]


def _full(q_hat, gallery, k, gallery_norms=None, gallery_scale=None):
    return R.fused_cosine_topk(q_hat, gallery, k, gallery_norms=gallery_norms,
                               gallery_scale=gallery_scale)


class Rung(NamedTuple):
    """A rung's wrapper ``kernel(q_hat, gallery, k, gallery_norms=None,
    gallery_scale=None)`` and its plain version ``plain(..., splits=1,
    gallery_scale=None)``."""
    kernel: Callable
    plain: Callable


def build_variants() -> dict[str, Rung]:
    """The ladder, in order: ``stream_only``, ``matmul_only``,
    ``insert_only`` and ``full`` (the production kernel), each with its
    plain version. The gallery's dtype picks f32, bf16 or int8."""
    rungs = {name: Rung(functools.partial(_rung, name), _PLAIN[name])
             for name in RUNGS}
    return {**rungs, "full": Rung(_full, _full_reference)}


# ---------------------------------------------------------------------------
# The row-block stream probe
# ---------------------------------------------------------------------------

def stream_probe_reference(x: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows,) f32: out[r] = sum over i and d of x[i·rows + r, d]."""
    return x.reshape(-1, rows, x.shape[1]).sum(dim=(0, 2))


def stream_probe_rtol(n: int, d: int, rows: int) -> float:
    """Bound on |kernel - plain| as a share of the same sum of |x|: twice
    the kernel's longest chain of f32 additions (one lane's words, its
    butterfly, the fold over n / rows blocks) times 2⁻²⁴."""
    return 2 * (-(-d // 32) + 7 + n // rows) * 2.0 ** -24


def stream_probe(x: torch.Tensor, rows: int) -> torch.Tensor:
    """The probe: (N, D) f32 with N a multiple of ``rows`` -> (rows,) f32
    (:func:`stream_probe_reference`). CUDA tensors launch
    ``stream_probe_f32`` of ``csrc/stream_probe.cu`` or raise; CPU tensors
    run the plain version."""
    if (x.dtype != torch.float32 or x.dim() != 2 or rows < 1
            or x.shape[0] % rows):
        raise ValueError(f"expected float32 (N, D) with N a multiple of "
                         f"rows={rows}, got {x.dtype} {tuple(x.shape)}")
    if _cuda.on_cpu(x):
        return stream_probe_reference(x, rows)
    n, d = x.shape
    _cuda.check_operand("x", x, torch.float32, (n, d), x.device)
    rowsum = torch.empty((n,), device=x.device, dtype=torch.float32)
    out = torch.empty((rows,), device=x.device, dtype=torch.float32)
    _cuda.launch("stream_probe", "stream_probe_f32", x.device, x, n, d, rows,
                 rowsum, out)
    return out


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def pipelined_ms(call: Callable, n_iter: int = 20, repeats: int = 5) -> float:
    """ms per call: two warm-up calls, then ``repeats`` bursts of
    ``n_iter`` back-to-back calls between two CUDA events with one
    synchronise each; the fastest burst."""
    call()
    call()
    best = math.inf
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n_iter):
            call()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / n_iter)
    return best


def run_ladder(q_hat, gallery, k, gallery_norms=None, gallery_scale=None,
               **timing) -> dict[str, float]:
    """ms of each rung and of the full kernel on these operands."""
    return {name: pipelined_ms(lambda v=rung: v.kernel(
                q_hat, gallery, k, gallery_norms=gallery_norms,
                gallery_scale=gallery_scale), **timing)
            for name, rung in build_variants().items()}


def attribution(times: dict[str, float]) -> dict[str, float]:
    """The full kernel's time by phase, from differences of rung times."""
    return {"stream (loads + staging)": times["stream_only"],
            "+ normalize + product": times["matmul_only"]
            - times["stream_only"],
            "+ insertion chain": times["insert_only"] - times["matmul_only"],
            "+ extraction + merge": times["full"] - times["insert_only"],
            "= full kernel": times["full"]}


def run_probes(x, heights=PROBE_ROWS, **timing) -> dict[int, float]:
    """ms of the probe at each block height over ``x``."""
    return {rows: pipelined_ms(lambda r=rows: stream_probe(x, r), **timing)
            for rows in heights}


def torch_stream_ms(x, **timing) -> float:
    """ms of one torch elementwise read+write pass over ``x``."""
    y = torch.empty_like(x)
    return pipelined_ms(lambda: torch.mul(x, 1.0000001, out=y), **timing)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trace", default=None,
                   help="directory for a torch.profiler trace of one burst "
                        "of the full kernel")
    p.add_argument("--skip-ceilings", action="store_true",
                   help="time the ladder only")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this tool measures the card")
    dev = resolve_device("cuda")
    log(f"card: {card()}")

    gen = torch.Generator(device=dev).manual_seed(0)
    padded = torch.randn((G_PAD, DIM), generator=gen, device=dev)
    gallery = padded[:GALLERY]
    q_hat = R.l2_normalize(torch.randn((QUERIES, DIM), generator=gen,
                                       device=dev))
    codes, scales = R.quantize_rows_int8(R.l2_normalize(gallery))
    forms = {"float32": (gallery, {"gallery_norms": torch.linalg.vector_norm(
                 gallery, dim=1)}),
             "bfloat16": (R.l2_normalize(gallery).to(torch.bfloat16), {}),
             "int8": (codes, {"gallery_scale": scales})}
    n_qtiles = -(-QUERIES // 64)
    for mode, (gal, aux) in forms.items():
        g_bytes = gal.numel() * gal.element_size()
        log(f"{mode}: Q={QUERIES} G={GALLERY} D={DIM} k={K}; gallery "
            f"{g_bytes / 1e6:.1f} MB, {n_qtiles} query tiles => "
            f"{n_qtiles * g_bytes / 1e9:.2f} GB of gallery reads per call")
        times = run_ladder(q_hat, gal, K, **aux)
        for name, ms in times.items():
            log(f"{mode} {name:12s}: {ms:8.3f} ms (gallery stream "
                f"{n_qtiles * g_bytes / ms / 1e6:7.1f} GB/s)")
        for phase, ms in attribution(times).items():
            log(f"{mode} {phase:26s}: {ms:8.3f} ms")

    if args.trace:
        gal, aux = forms["float32"]
        with trace(args.trace) as prof:
            for _ in range(5):
                R.fused_cosine_topk(q_hat, gal, K, **aux)
        log(f"trace of 5 full f32 kernels written under {args.trace}; "
            f"{len(prof.key_averages())} event kinds")

    if args.skip_ceilings:
        return
    x_bytes = padded.numel() * 4
    for rows, ms in run_probes(padded).items():
        log(f"stream probe, blocks of ({rows:4d}, {DIM}) over "
            f"{x_bytes / 1e6:.1f} MB: {ms:.4f} ms = "
            f"{x_bytes / ms / 1e6:7.1f} GB/s read")
    ms = torch_stream_ms(padded)
    log(f"torch elementwise read+write pass: {ms:.4f} ms = "
        f"{2 * x_bytes / ms / 1e6:7.1f} GB/s (read + write)")


if __name__ == "__main__":
    main()
