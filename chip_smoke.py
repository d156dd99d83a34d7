"""Smoke run of the PyTorch/CUDA port on one GPU: build, serve, verify, time.

    python3 chip_smoke.py

Phases (any failure exits non-zero, with no result line):

1. Build the port's CUDA kernels (``csrc/fused_topk.cu``,
   ``csrc/image_ops.cu``, ``csrc/depthwise_conv.cu`` and
   ``csrc/stream_probe.cu``, one nvcc process each, started together) and
   print the card's name and power limit, and what the machine offers for
   image decoding (whether PIL, cv2 and torchvision.io import; whether a C
   program with jpeglib.h and png.h builds with -ljpeg -lpng): a report.
2. Main path: ``efficientnet_b3a`` at full width with seeded random weights
   embeds 512 seeded uint8 224x224 images through the squarepad eval
   transform into a ``GalleryIndex``, which then takes 99,488 seeded unit
   rows (G = 100,000 x 1536 on the device).
3. Requests, one path per serving mode, each driven with the kernels'
   launch counts set to 0 just before it and read just after:
   ``RetrievalEngine.embed_batch`` -> ``query_class_dedup(k=150,
   num_unique=3, matmul_dtype=...)``. float32: two batches of 64 (fused
   kernel) and one of 8 (dense path), a cold round then a warm one; then
   bfloat16, int8 and int8_rerank (shortlist 256): one batch of 64 and
   one of 8, cold then warm. Per-request latency, launches per path, the
   resident bytes of each mode; one warm Q=64 request per mode under
   torch.profiler.
4. Each kernel against its plain version on the card, at the main path's
   shapes: bitwise on ±1 data with a planted bin overflow that fails and
   is repaired exactly; on the float gallery (served queries, and seeded
   unit rows with wider top-k gaps) the near-tie rule for f32 and bf16,
   bitwise for int8 at k=150 and at int8_rerank's shortlist c=256; the
   bf16 certificate pass rate beside the plain version's; kernel 3's
   query quantization (its first launch) bitwise against
   ``quantize_rows_int8``; kernel 1's values (3xTF32) within 1e-6 of an
   f64 product on the unit-row queries, beside the plain version's (true
   f32). Fidelity of each mode against f32 exact on the unit-row queries.
   Kernel, plain and library times and each kernel's bound (kernel 1: the
   3xTF32 bound and the f32-FMA bound beside it), the f32 library at one
   TF32 pass logged as lower precision; the bf16 and int8 library calls
   timed from q̂ as well (the cast
   or the quantization inside the timed call), and the host's time in
   each step of the bf16 and int8 wrappers (host clock), beside the steps
   that the earlier wrapper ran in their place (an eager quantization, one
   allocation per buffer, the SM count read at each call, a device
   context).
5. AutoAugment training input: a seeded triplet batch (qry, one pos, one
   neg; 64 x 256 x 256 x 3 uint8 each) through
   ``build_triplet_transform`` with three ``train_autoaugment(224)``
   specs and a seeded generator, launch counts set to 0 just before and
   read just after (histogram 6, LUT 9, cubic row shift 3, row shift 18:
   12 on rows and 6 on columns, counted by C entry as well; worked out
   from ``_STAGE_OPS``; no plain version on the card), the
   augmented queries through the b3a embed. The transform equals its
   pieces, and the card's policy the CPU table's on every image no rotate
   touched; the 3-shear rotate's agreement with the exact gather rotate.
   Each image kernel against its plain version, bitwise, at the path's
   shapes and at ragged ones (the histogram also on planes of one value,
   its worst case for atomics; the integer shift in both forms: rows, and
   the columns of the rotate's Sy pass, a row of its own in the kernels
   line with its C entry's launches); kernel, plain and library times and
   bounds, each kernel's device time per launch (``device_ms``,
   torch.profiler; on operands the L2 keeps between calls) and again on
   operands read from HBM (``device_hbm_ms``, the time the byte bound
   describes; the histogram's also on the planes of one value), the
   host's µs per call of each wrapper with its steps (``host_us``;
   ``tools/image_kernel_times``); the transform's time, and
   its device time by kernel.
6. T3 training with the depthwise kernels (IRT_FORCE_PALLAS_DW=1).
   Kernels 9 (forward and dx) and 10 against their plain versions at the
   26 depthwise layer shapes of b3a at 224 px (N = 8) and at ragged ones,
   in f32 and bf16: the forward and dx bitwise, the tap gradients within
   1e-6 of the sum of absolute products (another summation order) and two
   launches of them bitwise equal; dx profiled at the stride-2 layers,
   where its own kernel is the only device kernel (no dilated copy, no
   flip); then their kernel, plain and library (cuDNN)
   times per pass at N = 192, summed over the 26 layers, beside the
   bound, each kernel held against its
   plain version there as well. Then ``Trainer.fit(max_epochs=1)``
   of ``make_config("train_efficient_cos_con_ce_loss", batch_size=64)``
   on ``efficientnet_b3a`` (125 classes, seeded weights) over in-memory
   loaders (3 train batches, 1 val batch of seeded 256 px uint8
   triplets), first with the opt-in, counts set to 0 just before and read
   just after (kernel 9: the forward 26 per train step and 26 per val
   batch, dx 26 per train step; kernel 10: 26 per train step; kernels
   5-8 at phase 5's counts per step; no plain version on the card, no
   layout copy), then from the same weights
   and seeds on cuDNN and with two planted wiring faults (``planted``):
   per-step losses agree within the bf16 tolerance, and each faulted run
   falls outside it; one f32 step (TF32 off) agrees in its loss and
   depthwise weight gradients, and with each of three planted faults
   falls outside those tolerances. Warm
   epoch times of both paths (wall and CUDA events), peak memory, and one
   profiled epoch each: top device ops and the idle share.
7. Inference evaluation on the scores kernel (kernel 4), and the
   profiling tool's kernels. ``RetrievalEngine(use_pallas=True)`` on the
   phase 2 b3a: ``embed_triplet_loader`` over 8 batches of 64 seeded
   256 px triplets, then ``evaluate_class_dedup`` (k=150, num_unique=3)
   and ``evaluate_index_match``, counts set to 0 just before and read just
   after (one scores launch per evaluation, no top-k kernel, no plain
   version on the card); the same evaluations with ``use_pallas=False``
   give equal top1 / top3. ``search`` over the 100,000 x 1536 gallery at
   Q = 64 and 8 agrees with the fused kernel 1 (near-tie rule); its warm
   time. Kernel 4 against its plain version (bitwise on ±1 rows, within
   1e-5 on float rows) at Q = 64 and 512 over that gallery and at a ragged
   shape, and within 1e-6 of f64 on seeded unit rows; its kernel, plain
   and library (cuBLAS + normalize) times and both bounds at Q = 64 and
   512 (the row's ``*_q512`` keys). The
   ladder's rungs (kernel 11: f32 and bf16, and the port's own int8
   ladder of kernel 3) against their plain versions, then
   ``tools.profile_fused_kernel.run_ladder`` at Q = 64 with the
   attribution by differences and one burst under ``utils.profiling.
   trace``; the stream probe (kernel 12) against its plain version and its
   read rate at four block heights, beside a torch read+write pass.
8. The gallery CLI (``cli/gallery.py``) in this process, through
   ``build_parser().parse_args([...])`` and ``run``: a seeded PNG tree
   (8 class folders of 64 images at 256 px, rows cycling through the five
   PNG filters; 64 query images, half 300 x 200) is decoded by
   ``data.decode`` (time per image), built with ``-mn efficientnet_b3a
   -is 224 -bs 64 --host_size 256`` (images/s) and described by ``info``;
   then ``query`` of the 64 images, k = 150, num_unique = 3, in each
   ``--matmul_dtype``, counts set to 0 just before and read just after:
   64 JSON lines, one launch of the mode's fused kernel (1, 2 or 3),
   ``PLAIN_ON_CARD`` unchanged, records equal to the library path's
   (``data.decode`` -> ``RetrievalEngine`` -> ``query_class_dedup`` on
   the artifact: indices and classes equal, scores within 1e-6); wall ms
   per mode. ``serve`` (``_make_server``, port 0, in a thread): healthz,
   then 16 parallel POST /search of query PNGs, four times (cold, warm,
   warm with serve's decode lock taken out, warm again with it): all
   200, fewer dispatches than requests, p50 / p95 per request, each record
   equal to query's (float32) except at near-ties (serve's micro-batches
   take the dense path, query's Q = 64 the kernel). Peak device memory.
   The kernels line's rows 1-3 carry these launches as ``cli_launches``.
9. One JSON line of kernels, the nvidia-smi line, and the result line.

Times are CUDA events. Each row of the kernels line has ``ms`` and
``library_ms`` measured as every earlier version of this script measured
them (``ms_by``): the median of single calls for kernels 1-10, back-to-back
launches (``pipelined_ms``) for the ladder's rungs and the stream probe
(whose ``library_ms`` is a single-call median); and for every row
``burst_ms`` and ``library_burst_ms``, back-to-back launches (the fastest
of 5 bursts of 20), where the host's dispatch overlaps the previous
call's device time.

Imports nothing of JAX. Needs one CUDA card.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device; nothing was run")

from imageretrievalresearch_tpu_torch.cli import gallery as CLI  # noqa: E402
from imageretrievalresearch_tpu_torch.data.decode import (  # noqa: E402
    decode_image,
    resize_bilinear_host,
    square_pad_host,
)
from imageretrievalresearch_tpu_torch.models import create_model  # noqa: E402
from imageretrievalresearch_tpu_torch.models.layers import (  # noqa: E402
    DepthwiseConv2d,
)
from imageretrievalresearch_tpu_torch.ops import _cuda  # noqa: E402
from imageretrievalresearch_tpu_torch.ops import autoaugment as A  # noqa: E402
from imageretrievalresearch_tpu_torch.ops import depthwise as DW  # noqa: E402
from imageretrievalresearch_tpu_torch.ops import image_kernels as IK  # noqa: E402
from imageretrievalresearch_tpu_torch.ops import retrieval as R  # noqa: E402
from imageretrievalresearch_tpu_torch.ops.preprocess import (  # noqa: E402
    TransformSpec,
    build_eval_transform,
    build_triplet_transform,
    resize_bilinear,
)
from imageretrievalresearch_tpu_torch.recipes import make_config  # noqa: E402
from imageretrievalresearch_tpu_torch.retrieval import (  # noqa: E402
    GalleryIndex,
    RetrievalEngine,
)
from imageretrievalresearch_tpu_torch.tools import (  # noqa: E402
    profile_fused_kernel as PF,
)
from imageretrievalresearch_tpu_torch.tools.image_kernel_times import (  # noqa
    AUG_BATCH,
    AUG_SRC,
    ENTRIES,
    SEED,
    SIZE,
    SMAX_ROTATE,
    SMAX_SHEAR,
    device_ms,
    event_ms,
    from_hbm,
    host_steps,
    host_us,
)
from imageretrievalresearch_tpu_torch.train import (  # noqa: E402
    Trainer,
    build_train_step,
)
from imageretrievalresearch_tpu_torch.utils.profiling import trace  # noqa: E402

G_TOTAL, N_IMAGES, DIM, K = 100_000, 512, 1536, 150
SHORTLIST = 256   # int8_rerank's stage-1 depth on the main path
DEV = torch.device("cuda")
# published dense peaks of the H100 (NVIDIA data sheets, sparsity left
# out), at full power: memory bytes/s, and operations/s per arithmetic
# (f32 FMA without tensor cores; TF32, bf16 and int8 on tensor cores)
PEAKS = {"sxm": {"bytes": 3.35e12, "float32": 67e12, "tf32": 494.7e12,
                 "bfloat16": 989e12, "int8": 1979e12},
         "pcie": {"bytes": 2.0e12, "float32": 51e12, "tf32": 378e12,
                  "bfloat16": 756e12, "int8": 1513e12}}
# kernels 1 and 4 run the f32 product as 3xTF32 (three TF32 tensor-core
# products per multiply-add); their bound reads that arithmetic, and the
# f32-FMA bound (the product on CUDA cores) stands beside it
TF32_PASSES = 3
# the TPU kernel each CUDA kernel replaces (imageretrievalresearch_tpu)
KERNELS = {"float32": ("fused_cosine_topk", "ops/retrieval.py:259"),
           "bfloat16": ("fused_cosine_topk_bf16", "ops/retrieval.py:288"),
           "int8": ("fused_cosine_topk_int8", "ops/retrieval.py:313")}
IMAGE_KERNELS = {"plane_histogram": "ops/pallas_image.py:28",
                 "lut_apply": "ops/pallas_image.py:233",
                 "row_shift_cubic": "ops/pallas_image.py:150",
                 "row_shift": "ops/pallas_image.py:76",
                 "column_shift": "ops/pallas_image.py:76"}
# the AutoAugment phase: a triplet batch of three roles, each AUG_BATCH
# seeded AUG_SRC px uint8 images, resized to SIZE (these, SEED and the
# shift bounds SMAX_* come from tools/image_kernel_times, which times the
# same transform)
AUG_ROLES = 3
# f32 operations per output pixel of the cubic row shift, which computes
# each row's weights once: 4 taps x (product, sum), the division, the
# clip's 2, the rounding's add, and ~1 for the bytes' conversion (19 bytes
# per 16 pixels); the weights' ~50 per row are under 0.25 a pixel at 224
CUBIC_OPS_PER_PIXEL = 13
# the training phase: T3 on b3a with Sketchy's 125 categories, batches of
# 64 seeded 256 px triplets; kernels 9 and 10 compared at N = 8 and timed
# at N = 192 (one train step's depthwise batch)
DW_KERNELS = {"depthwise_conv_forward": "ops/pallas_conv.py:181",
              "depthwise_conv_grad_w": "ops/pallas_conv.py:189"}
DW_SOURCE = "imageretrievalresearch_tpu_torch/csrc/depthwise_conv.cu"
N_CLASSES, TRAIN_BATCH, TRAIN_SRC, TRAIN_STEPS = 125, 64, 256, 3
DW_COMPARE_N, DW_TIME_N = 8, 3 * TRAIN_BATCH
# (C, H, W, K, stride) beyond b3a's layers: odd H and W at stride 2, C not
# a multiple of 32, K = 7, and C not a multiple of 8 (the tap-gradient
# kernel's masked loads)
DW_RAGGED = [(144, 13, 9, 5, 2), (40, 15, 15, 7, 2), (200, 9, 9, 7, 1),
             (24, 57, 43, 3, 2), (36, 15, 15, 3, 2)]
# The kernel path against cuDNN, relative, each limit between the card's
# sound reading and the nearest reading of a wiring fault planted into the
# opt-in path (``planted``; NVIDIA H100 80GB HBM3, 700 W). The bf16 epoch's
# train_loss per step: sound 0, 2.3e-3, 1.9e-2 (the same bits in every
# run); forward on transposed taps 2.9e-2, 4.4e-2, 4.6e-2; dx with
# unflipped taps 0, 1.2e-2, 2.7e-1. Both paths round every depthwise
# output to bf16 from f32 sums in other orders, and AdamW's first updates
# are sign-like (lr * g / (|g| + eps)), so a gradient element near zero
# whose sign differs moves its parameter by up to 2 lr and the later
# losses drift. Transposed tap gradients move the bf16 losses less than
# that drift does (0, 9.3e-4, 1.3e-2): the f32 step, whose depthwise
# weight gradients are compared directly, is the check that catches them.
BF16_LOSS_RTOL = (5e-3, 5e-3, 3e-2)
BF16_FAULTS = ("forward", "dx")
# one f32 step (TF32 off): f32 sums in other orders; its loss, and the
# depthwise weight gradients of three layers as a share of their largest
# element (sound 3.9e-7 and 1.1e-4)
F32_LOSS_RTOL, F32_GRAD_RTOL = 1e-4, 1e-3
DW_FAULTS = ("forward", "dx", "dw")
# the tap gradients' limit, as a share of the sum of |x| |g| over each
# tap's terms: f32 sums in another order move a tap by a few 1e-8 of it; a
# pixel dropped from every sum moves it by 1 / (N Ho Wo), 1e-5 at the
# (40, 112) layer and N = 8
DW_GRAD_W_RTOL = 1e-6
# the inference evaluation (phase 7): 8 batches of 64 seeded triplets, so
# 512 queries against a gallery of 512 positives; kernel 4's ragged shape
# (Q, G, D); the line of each ladder rung in the JAX tool
EVAL_BATCHES = 8
SCORES_RAGGED = (37, 1001, 1000)
LADDER = {"stream_only": 104, "matmul_only": 116, "insert_only": 131}
# the gallery CLI (phase 8): 8 class folders of 64 seeded 256 px PNGs
# (512 items: the fused path needs G >= 256), 64 query PNGs (32 at 256 x
# 256, 32 at 300 wide x 200 high), 16 parallel requests to serve; records
# of serve (dense path) and query (kernel) may differ only at near-ties:
# where an index differs, both records' scores there lie within
# SERVE_TIE_ATOL (1e-5, plus the records' 5-decimal rounding)
CLI_CLASSES, CLI_PER_CLASS, CLI_SRC, CLI_QUERIES, CLI_POSTS = 8, 64, 256, 64, 16
CLI_MODES = {"float32": "fused_cosine_topk",
             "bfloat16": "fused_cosine_topk_bf16",
             "int8": "fused_cosine_topk_int8",
             "int8_rerank": "fused_cosine_topk_int8"}
SERVE_TIE_ATOL = 2e-5
# a ten-line program against the native loader's libraries
# (native/Makefile: -ljpeg -lpng)
CODEC_PROBE = r"""
#include <stdio.h>
#include <jpeglib.h>
#include <png.h>
int main(void) {
    struct jpeg_decompress_struct cinfo;
    struct jpeg_error_mgr jerr;
    cinfo.err = jpeg_std_error(&jerr);
    jpeg_create_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    printf("libpng %s\n", png_get_libpng_ver(NULL));
    return 0;
}
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def images(gen: torch.Generator, n: int) -> torch.Tensor:
    return torch.randint(0, 256, (n, SIZE, SIZE, 3), generator=gen,
                         device=DEV, dtype=torch.uint8)


def pm1_rows(gen: torch.Generator, n: int, d: int, nnz: int = 256):
    """Rows with ``nnz`` entries of ±1 (norm exactly 16): normalized
    entries, products and partial sums are exact in f32, bf16 and int8
    codes (±127), so scores are bitwise-equal under any accumulation
    order."""
    pos = torch.rand((n, d), generator=gen, device=DEV).argsort(dim=1)
    sign = torch.randint(0, 2, (n, nnz), generator=gen, device=DEV) * 2 - 1
    out = torch.zeros((n, d), device=DEV)
    out.scatter_(1, pos[:, :nnz], sign.float())
    return out


def near_tie_rows(inds, ref_inds, scores, kth, where) -> int:
    """The number of rows whose top-k index sets differ from the
    reference's; every index in a difference must score within 1e-5 of
    the row's k-th value (a near-tie)."""
    n_diff = 0
    for r in range(inds.shape[0]):
        diff = set(inds[r].tolist()) ^ set(ref_inds[r].tolist())
        if diff:
            n_diff += 1
            d = torch.tensor(sorted(diff), device=DEV)
            assert (scores[r, d] - kth[r]).abs().max().item() <= 1e-5, (
                *where, r)
    return n_diff


def kernel_args(mode: str, form: tuple):
    """``(gallery, keyword arguments)`` of ``fused_cosine_topk`` from a
    mode's form: (gallery, norms) for f32, (bf16 rows,) or (rows, None)
    for bf16, (codes, scales, ...) for int8 and int8_rerank."""
    aux = form[1] if len(form) > 1 else None
    if aux is None:
        return form[0], {}
    return form[0], {"gallery_norms" if mode == "float32"
                     else "gallery_scale": aux}


def bound(nbytes: float, ops: float, peaks: dict,
          rate: str = "float32") -> tuple[float, str]:
    """The least time (ms) for the work: bytes over the memory rate or the
    operations over the rate of ``rate`` (``float32``: f32 FMA on CUDA
    cores), whichever is larger."""
    t_bytes = nbytes / peaks["bytes"] * 1e3
    t_ops = ops / peaks[rate] * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops > t_bytes
                                 else "bytes")


def f32_bounds(nbytes: float, ops: float, peaks: dict) -> dict:
    """Kernels 1 and 4 and the f32 rungs: ``bound_ms`` / ``bound_by`` for
    the 3xTF32 product the kernel runs (TF32_PASSES x ``ops`` on TF32
    tensor cores), and the f32-FMA bound beside it, named as such."""
    b, by = bound(nbytes, TF32_PASSES * ops, peaks, "tf32")
    fb, fby = bound(nbytes, ops, peaks)
    return {"bound_ms": b, "bound_by": by, "f32_fma_bound_ms": fb,
            "f32_fma_bound_by": fby}


def host_dispatch(mode: str, q_hat, g_in, kw) -> dict:
    """The host's time (µs per call) in each step of the fused top-k
    wrapper (``ops.retrieval._fused_cosine_topk_cuda``, over
    ``_cuda.launch``) for kernel 2 or 3 at the main path's shapes: the
    steps as this version runs them, the ones the earlier wrapper ran in
    their place (eager quantization, six ``torch.empty``, the SM count read
    each call, a ``torch.cuda.device`` context), and the whole call."""
    dev = q_hat.device
    q, d = q_hat.shape
    g = g_in.shape[0]
    gs = kw.get("gallery_scale")
    n_split = R.fused_splits(q, g, K, dev)
    int8 = mode == "int8"
    entry = R._VARIANTS[g_in.dtype][1]
    words = R._work_words(q, d, K, n_split, int8)
    work = torch.empty(words, device=dev, dtype=torch.int32)
    q_in = q_hat.to(torch.bfloat16) if mode == "bfloat16" else q_hat
    aux = gs.reshape(-1) if int8 else None
    fn = getattr(_cuda.load_library("fused_topk"), entry)
    args = [q_in.data_ptr(), g_in.data_ptr(),
            aux.data_ptr() if aux is not None else None, q, g, d, K,
            n_split, R.FUSED_BINS, R.FUSED_T_DEPTH, work.data_ptr(), words]

    def checks():
        _cuda.check_operand("queries_hat", q_hat, torch.float32, (q, d), dev)
        _cuda.check_operand("gallery", g_in, g_in.dtype, (g, d), dev)
        if int8:
            _cuda.check_operand("gallery_scale", gs.reshape(-1),
                                torch.float32, (g,), dev)
        R.check_tile_ordinals(g, n_split)

    def six_empties():
        for shape, dt in (((q, n_split, K), torch.float32),
                          ((q, n_split, K), torch.int32),
                          ((q, n_split), torch.float32),
                          ((q, K), torch.float32), ((q, K), torch.int32),
                          ((q,), torch.int32)):
            torch.empty(shape, device=dev, dtype=dt)

    def workspace():
        w = torch.empty(words, device=dev, dtype=torch.int32)
        out = w[:2 * q * K].view(2, q, K)
        return out[0].view(torch.float32), out[1], w[2 * q * K:2 * q * K + q]

    def device_guard():
        with torch.cuda.device(dev):
            pass

    steps = {"checks": host_us(checks)}
    if not int8:   # int8 quantizes q̂ inside the C entry, on the device
        steps["query cast"] = host_us(lambda: q_hat.to(torch.bfloat16))
    steps.update({
        "allocation: one workspace + views": host_us(workspace),
        "fused_splits (SM count cached)":
            host_us(lambda: R.fused_splits(q, g, K, dev)),
        "stream lookup (raw handle)":
            host_us(lambda: _cuda.stream_handle(_cuda.device_index(dev))),
        "ctypes call (the C entry: maps, launches)":
            host_us(lambda: fn(*args, _cuda.stream_handle(
                _cuda.device_index(dev)))),
        "whole call": host_us(lambda: R.fused_cosine_topk(q_hat, g_in, K,
                                                           **kw)),
    })
    tensors = [q_hat, g_in] + [work] * 8
    before = {
        "allocations: six torch.empty": host_us(six_empties),
        "fused_splits, SM count read each call": host_us(
            lambda: torch.cuda.get_device_properties(
                dev).multi_processor_count),
        "device guard (torch.cuda.device context)": host_us(device_guard),
        "stream lookup (torch.cuda.current_stream)": host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        "ctypes.c_void_p per tensor argument (10)": host_us(
            lambda: [ctypes.c_void_p(t.data_ptr()) for t in tensors]),
    }
    if int8:
        before["query quantization, eager"] = host_us(
            lambda: R.quantize_rows_int8(q_hat))
    return {"now": steps, "earlier_steps": before}


def launches_per_policy() -> dict:
    """Image kernel launches of one policy call on the card, from the ops
    each stage can select (every one is computed batch-wide): equalize a
    histogram and a LUT, autocontrast a LUT, shearX a cubic row shift,
    rotate three row shifts."""
    def stages(op):
        return sum(op in ops for ops in A._STAGE_OPS)
    return {"plane_histogram": stages(A.EQUALIZE),
            "lut_apply": stages(A.EQUALIZE) + stages(A.AUTOCONTRAST),
            "row_shift_cubic": stages(A.SHEAR_X),
            "row_shift": 3 * stages(A.ROTATE)}


def augment_phase(model, gen: torch.Generator, peaks: dict) -> list:
    """Phase 5: the AutoAugment training input on the card; returns the
    image kernels' entries of the ``kernels`` line."""
    def u8(n, h, w=None):
        return torch.randint(0, 256, (n, h, w or h, 3), generator=gen,
                             device=DEV, dtype=torch.uint8)

    batch = {"qry": u8(AUG_BATCH, AUG_SRC), "pos": [u8(AUG_BATCH, AUG_SRC)],
             "neg": [u8(AUG_BATCH, AUG_SRC)]}
    spec = TransformSpec.train_autoaugment(SIZE)
    transform = build_triplet_transform(spec, spec, spec)
    per_call = launches_per_policy()
    assert per_call == {"plane_histogram": 2, "lut_apply": 3,
                        "row_shift_cubic": 1, "row_shift": 6}, per_call

    IK.reset_launch_counts()
    out, ms = sync_time(lambda: transform(
        batch, torch.Generator(device=DEV).manual_seed(SEED)))
    launches = dict(IK.KERNEL_LAUNCHES)
    by_entry = dict(IK.ENTRY_LAUNCHES)
    plain = dict(IK.PLAIN_ON_CARD)
    log(f"AutoAugment triplet transform (3 x {AUG_BATCH} x {AUG_SRC} px -> "
        f"{SIZE}, first call): {ms:.1f} ms; launches {launches}, by C "
        f"entry {by_entry}")
    assert launches == {k: AUG_ROLES * n for k, n in per_call.items()}, (
        launches)
    # the integer shift's two forms share the row_shift counter: a rotate
    # runs two passes on rows and one on columns
    assert by_entry == {ENTRIES[k]: launches[k] for k in launches} | {
        "image_row_shift": 2 * launches["row_shift"] // 3,
        "image_column_shift": launches["row_shift"] // 3}, by_entry
    assert not any(plain.values()), f"plain versions ran on the card: {plain}"
    for x in (out["qry"], *out["pos"], *out["neg"]):
        assert x.shape == (AUG_BATCH, SIZE, SIZE, 3), x.shape
        assert x.dtype == torch.float32 and x.device.type == DEV.type
        assert torch.isfinite(x).all() and x.min() >= 0 and x.max() <= 1
    with torch.no_grad():
        emb = model.embed(out["qry"])
    assert emb.shape == (AUG_BATCH, DIM) and torch.isfinite(emb).all()
    log(f"augmented queries embedded (b3a): {tuple(emb.shape)}, finite")

    # the transform equals its pieces (the qry role draws first), and the
    # card's table equals the CPU table on every image no rotate touched
    x8 = torch.clamp(torch.round(resize_bilinear(batch["qry"],
                                                 (SIZE, SIZE))),
                     0, 255).to(torch.uint8)
    draws = A.draw_policy(AUG_BATCH,
                          torch.Generator(device=DEV).manual_seed(SEED))
    card = A.apply_policy(x8, *draws)
    assert torch.equal(out["qry"], card.float() / 255.0)
    cpu = A.apply_policy(x8.cpu(), *(d.cpu() for d in draws))
    ops, _, do, _ = (d.cpu() for d in draws)
    rotated = ((ops == A.ROTATE) & do).any(dim=1)
    assert torch.equal(card.cpu()[~rotated], cpu[~rotated])
    same = (card.cpu()[rotated] == cpu[rotated]).float().mean().item()
    log(f"card policy vs CPU table, same draws: {int((~rotated).sum())} of "
        f"{AUG_BATCH} images (no rotate) bitwise equal; the {int(rotated.sum())}"
        f" rotated ones (3-shear vs gather) agree on {same:.4f} of pixels")
    # fidelity of the 3-shear rotate at the policy's rotate magnitudes
    mags = torch.tensor(A._MAGS[A.ROTATE][[3, 8, 9]], device=DEV)
    deg = mags[torch.randint(0, 3, (AUG_BATCH,), generator=gen, device=DEV)]
    deg = deg * torch.where(torch.rand(AUG_BATCH, generator=gen, device=DEV)
                            < 0.5, 1.0, -1.0)
    fid = (A.batched_rotate(x8, deg) == A.op_rotate(x8, deg)).float()
    log(f"fidelity: the 3-shear rotate equals the exact gather rotate on "
        f"{fid.mean().item():.4f} of pixels at ±10/±26.7/±30 degrees "
        "(JAX documents 60-80%)")

    # each kernel against its plain version at the path's shapes (the
    # resized query planes) and at ragged ones, bitwise
    planes = A._planes(x8)                                  # (192, 224, 224)
    planes[0] = 9                                           # one bin
    planes[1].reshape(-1)[:256] = torch.arange(256, device=DEV)
    rows = planes.reshape(-1, SIZE)                         # (43008, 224)
    n = rows.shape[0]
    ragged = u8(5, 37, 41)[..., 0].contiguous()             # 5 planes
    # the histogram's worst case for atomics: each plane of one value
    const_planes = torch.full_like(planes, 128)
    ragged_rows = u8(1, 4097, 223)[0, ..., 0].contiguous()
    p, h, w = planes.shape
    lut = A._equalize_lut(IK.plane_histogram_reference(planes))

    def src0(m, smax):
        return (torch.rand(m, generator=gen, device=DEV) * 2 - 1) * smax

    def shifts(m, smax):
        return torch.randint(-smax, smax + 1, (m,), generator=gen,
                             device=DEV, dtype=torch.int32)

    def column_shifts(planes_, smax):   # (P, W), one per column
        return shifts(planes_.shape[0] * planes_.shape[2], smax).reshape(
            planes_.shape[0], planes_.shape[2])

    errs = {}
    for name, args in (
            ("plane_histogram", [(planes,), (ragged,), (const_planes,)]),
            ("lut_apply", [(planes, lut), (ragged, A._equalize_lut(
                IK.plane_histogram_reference(ragged)))]),
            ("row_shift_cubic", [(rows, src0(n, SMAX_SHEAR)),
                                 (ragged_rows, src0(4097, SMAX_SHEAR))]),
            ("row_shift", [(rows, shifts(n, SMAX_ROTATE[0])),
                           (rows, shifts(n, SMAX_ROTATE[1])),
                           (ragged_rows, shifts(4097, SMAX_ROTATE[1]))]),
            # the Sy pass's shape, and shifts past the 37 rows
            ("column_shift", [(planes, column_shifts(planes,
                                                     SMAX_ROTATE[1])),
                              (ragged, column_shifts(ragged, 40))])):
        kernel = getattr(IK, name)
        reference = getattr(IK, f"{name}_reference")
        errs[name] = 0.0
        for a in args:
            got, want = kernel(*a), reference(*a)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"{name} != plain version at " \
                f"{tuple(a[0].shape)}"
            errs[name] = max(errs[name], (got.float() - want.float()).abs()
                             .max().item())
        log(f"{name} kernel: bitwise equal to its plain version at "
            f"{', '.join(str(tuple(a[0].shape)) for a in args)}")

    # timings at the path's shapes
    src_shear, s_rot = src0(n, SMAX_SHEAR), shifts(n, SMAX_ROTATE[1])
    s_col = column_shifts(planes, SMAX_ROTATE[1])
    flat = planes.reshape(p, -1).long()
    hist_index = (flat + 256 * torch.arange(p, device=DEV)[:, None]).reshape(-1)
    timed = {
        "plane_histogram": ((planes,), p * h * w + 4 * 256 * p, p * h * w,
                            lambda: torch.bincount(hist_index,
                                                   minlength=256 * p),
                            "torch.bincount(plane * 256 + v)"),
        "lut_apply": ((planes, lut), 2 * p * h * w + 4 * 256 * p, 0,
                      lambda: torch.gather(lut, 1, flat),
                      "torch.gather(lut, 1, planes)"),
        "row_shift_cubic": ((rows, src_shear), 2 * n * SIZE + 4 * n,
                            CUBIC_OPS_PER_PIXEL * n * SIZE, None, None),
        "row_shift": ((rows, s_rot), 2 * n * SIZE + 4 * n, 0, None, None),
        "column_shift": ((planes, s_col), 2 * p * h * w + 4 * p * w, 0, None,
                         None),
    }
    entries = []
    for name, (a, nbytes, ops, library, library_name) in timed.items():
        kernel = getattr(IK, name)
        reference = getattr(IK, f"{name}_reference")
        ms = event_ms(lambda: kernel(*a), reps=50)
        b_ms = PF.pipelined_ms(lambda: kernel(*a))
        plain_ms = event_ms(lambda: reference(*a), reps=10)
        library_ms = event_ms(library, reps=50) if library else None
        lib_b_ms = PF.pipelined_ms(library) if library else None
        bound_ms, bound_by = bound(nbytes, ops, peaks)
        _, dev_ms = device_ms(lambda: kernel(*a), name)
        _, hbm_ms = device_ms(from_hbm(kernel, a), name)
        steps = host_steps(name, a)
        log(f"{name} at {tuple(a[0].shape)}: {ms:.4f} ms, back-to-back "
            f"{b_ms:.4f}, device {dev_ms:.4f} per launch, {hbm_ms:.4f} with "
            f"its operands read from HBM (bound {bound_ms:.4f} ms, "
            f"{bound_by}); plain {plain_ms:.4f} ms; "
            + (f"library {library_ms:.4f} ms, back-to-back {lib_b_ms:.4f} "
               f"({library_name})" if library
               else "library: none (no single PyTorch call computes it)"))
        log(f"  host µs per call: " + "; ".join(f"{k} {v:.1f}"
                                                 for k, v in steps.items()))
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "imageretrievalresearch_tpu_torch/csrc/image_ops.cu",
            "replaces": f"imageretrievalresearch_tpu/{IMAGE_KERNELS[name]}",
            "launches": by_entry[ENTRIES[name]],
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
            "ms_by": "single call",
            "burst_ms": b_ms,
            "library_burst_ms": lib_b_ms,
            "device_ms": dev_ms,
            "device_hbm_ms": hbm_ms,
            "host_us": steps["whole call"],
        })

    # the histogram's device time per launch on planes of one value, read
    # from HBM (tools/image_kernel_times times the parent's beside it)
    _, const_hbm_ms = device_ms(from_hbm(IK.plane_histogram,
                                         (const_planes,)), "plane_histogram")
    log(f"plane_histogram on {p} planes of one value: {const_hbm_ms:.4f} ms "
        "per launch with its operands read from HBM")
    next(e for e in entries if e["name"] == "plane_histogram")[
        "device_hbm_one_value_ms"] = const_hbm_ms

    # the whole triplet transform, warm, and its device time by kernel
    aug_gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    t_ms = event_ms(lambda: transform(batch, aug_gen), reps=5)
    log(f"AutoAugment triplet transform, warm: {t_ms:.2f} ms for "
        f"{AUG_ROLES} x {AUG_BATCH} images ({t_ms / AUG_ROLES:.2f} ms per "
        "role)")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, wall_ms = sync_time(lambda: transform(batch, aug_gen))
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"profiled triplet transform: {wall_ms:.1f} ms wall, {busy_ms:.1f} "
        "ms device busy; top kernels by device time:")
    events.sort(key=lambda e: -e.self_device_time_total)
    ours = ("histogram_kernel", "lut_kernel", "row_shift_kernel",
            "row_shift_cubic_kernel", "column_shift_kernel")
    for e in events[:10] + [e for e in events[10:]
                            if any(k in e.key for k in ours)]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} "
            f"{e.key[:90]}")
    return entries


class MemoryLoader:
    """Seeded uint8 triplet batches in host memory, with the loader
    interface the trainer takes (``__len__``, ``set_epoch``)."""

    def __init__(self, rng: np.random.Generator, n_batches: int, b: int):
        def u8():
            return rng.integers(0, 256, (b, TRAIN_SRC, TRAIN_SRC, 3),
                                dtype=np.uint8)
        self.batches = [{"qry": u8(), "pos": [u8()], "neg": [u8()],
                         "cat_idx": rng.integers(0, N_CLASSES, b),
                         "prod_idx": rng.integers(0, N_CLASSES, b)}
                        for _ in range(n_batches)]

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)

    def set_epoch(self, epoch: int) -> None:
        pass


def dw_layer_shapes(model) -> list:
    """(C, H, W, K, stride) of each depthwise layer of ``model`` at SIZE."""
    shapes, hooks = [], []
    for m in model.modules():
        if isinstance(m, DepthwiseConv2d):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp: shapes.append(
                    (mod.in_channels, inp[0].shape[2], inp[0].shape[3],
                     mod.kernel_size[0], mod.stride[0]))))
    with torch.no_grad():
        model.embed(torch.zeros((1, SIZE, SIZE, 3), device=DEV))
    for h in hooks:
        h.remove()
    return shapes


def dw_operands(gen, n, shape, dtype):
    c, h, w, k, s = shape
    ho, wo = DW.out_len(h, k, s), DW.out_len(w, k, s)
    x = torch.randn((n, h, w, c), generator=gen, device=DEV).to(dtype)
    g = torch.randn((n, ho, wo, c), generator=gen, device=DEV).to(dtype)
    wt = torch.randn((c, 1, k, k), generator=gen, device=DEV).to(dtype)
    return x, g, wt


def dw_passes(x, g, taps, shape) -> dict:
    """pass -> (kernel, plain version), callables on one layer's operands."""
    c, h, w, k, s = shape
    return {"forward": (lambda: DW.depthwise_forward(x, taps, s),
                        lambda: DW.depthwise_forward_reference(x, taps, s)),
            "dx": (lambda: DW.depthwise_grad_x(g, taps, s, h, w),
                   lambda: DW.depthwise_grad_x_reference(g, taps, s, h, w)),
            "dw": (lambda: DW.depthwise_grad_w(x, g, k, s),
                   lambda: DW.depthwise_grad_w_reference(x, g, k, s))}


def dw_check(shape, x, g, passes: dict) -> tuple[float, float]:
    """Each pass's kernel against its plain version, once: the forward and
    dx bitwise, the tap gradients within DW_GRAD_W_RTOL of the sum of
    |x| |g| over each tap's terms, and a second launch of the tap-gradient
    kernel bitwise equal to the first. Returns the tap gradients' largest
    |kernel - plain| and its largest share of that sum."""
    got = {p: kern() for p, (kern, _) in passes.items()}
    again = passes["dw"][0]()
    want = {p: plain() for p, (_, plain) in passes.items()}
    torch.cuda.synchronize()
    where = (x.dtype, x.shape[0], shape)
    for p in ("forward", "dx"):
        assert torch.equal(got[p], want[p]), (p, *where)
    assert torch.equal(got["dw"], again), ("dw run to run", *where)
    scale = DW.depthwise_grad_w_reference(x.abs(), g.abs(), shape[3],
                                          shape[4])
    err = (got["dw"] - want["dw"]).abs()
    rel = torch.where(scale > 0, err / scale, err).max().item()
    assert rel <= DW_GRAD_W_RTOL, ("dw", *where, rel)
    return err.max().item(), rel


def dw_compare(shapes, gen) -> tuple[float, float]:
    """Kernels 9 (forward, dx) and 10 against their plain versions on the
    card at N = DW_COMPARE_N, f32 and bf16; returns the tap gradients'
    largest |kernel - plain| and share (``dw_check``)."""
    err = rel = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in shapes:
            x, g, wt = dw_operands(gen, DW_COMPARE_N, shape, dtype)
            e, r = dw_check(shape, x, g,
                            dw_passes(x, g, DW._taps(wt), shape))
            err, rel = max(err, e), max(rel, r)
    log(f"depthwise kernels vs plain versions, {len(shapes)} shapes x f32 "
        f"and bf16 at N = {DW_COMPARE_N}: forward and dx bitwise equal; tap "
        f"gradients: two launches bitwise equal, max |kernel - plain| "
        f"{err:.3g}, at most {rel:.3g} of the sum of |x| |g| (limit "
        f"{DW_GRAD_W_RTOL})")
    return err, rel


def dw_times(shapes, gen, peaks: dict) -> tuple[dict, float, float]:
    """Per pass (forward, dx, dw) at N = DW_TIME_N in bf16, summed over
    ``shapes``: kernel, plain and library (cuDNN) ms, and the bound; each
    kernel is also held against its plain version on the same operands
    (``dw_check``), whose largest tap-gradient error and share come back
    with the times."""
    conv_bwd = torch.ops.aten.convolution_backward
    tot = {p: dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                             "bytes_ms", "ops_ms", "burst_ms",
                             "library_burst_ms"), 0.0)
           for p in ("forward", "dx", "dw")}
    n = DW_TIME_N
    err = rel = 0.0
    log(f"depthwise passes at N = {n}, bf16, per layer (C, H, K, stride): "
        "kernel / cuDNN ms for forward, dx, dw (single call; back-to-back)")
    for shape in shapes:
        c, h, w, k, s = shape
        p = k // 2
        ho, wo = DW.out_len(h, k, s), DW.out_len(w, k, s)
        x, g, wt = dw_operands(gen, n, shape, torch.bfloat16)
        passes = dw_passes(x, g, DW._taps(wt), shape)
        xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        library = {
            "forward": lambda: torch.nn.functional.conv2d(
                xc, wt, stride=s, padding=p, groups=c),
            "dx": lambda: conv_bwd(gc, xc, wt, None, [s, s], [p, p], [1, 1],
                                   False, [0, 0], c, [True, False, False]),
            "dw": lambda: conv_bwd(gc, xc, wt, None, [s, s], [p, p], [1, 1],
                                   False, [0, 0], c, [False, True, False])}
        # every pass reads one activation and the taps and writes another
        nbytes = 2 * n * (h * w + ho * wo) * c + 4 * k * k * c
        ops = 2 * k * k * n * ho * wo * c
        row = []
        for name, (kern, plain) in passes.items():
            t = tot[name]
            ms = event_ms(kern, reps=10)
            lib_ms = event_ms(library[name], reps=10)
            b_ms = PF.pipelined_ms(kern)
            lib_b_ms = PF.pipelined_ms(library[name])
            t["ms"] += ms
            t["library_ms"] += lib_ms
            t["burst_ms"] += b_ms
            t["library_burst_ms"] += lib_b_ms
            t["plain_ms"] += event_ms(plain, reps=2, warmup=1)
            t["bytes_ms"] += nbytes / peaks["bytes"] * 1e3
            t["ops_ms"] += ops / peaks["float32"] * 1e3
            t["bound_ms"] += bound(nbytes, ops, peaks)[0]
            row.append(f"{ms:.3f} / {lib_ms:.3f}; {b_ms:.3f} / "
                       f"{lib_b_ms:.3f}")
        e, r = dw_check(shape, x, g, passes)
        err, rel = max(err, e), max(rel, r)
        log(f"  ({c}, {h}, {k}, {s}): " + "; ".join(row))
        del x, g, wt, xc, gc, passes, library
    log(f"depthwise kernels vs plain versions at N = {n}, bf16, "
        f"{len(shapes)} layers: forward and dx bitwise equal; tap "
        f"gradients: two launches bitwise equal, max |kernel - plain| "
        f"{err:.3g}, at most {rel:.3g} of the sum of |x| |g| (limit "
        f"{DW_GRAD_W_RTOL})")
    for name, t in tot.items():
        log(f"depthwise {name} over {len(shapes)} layers at N = {n}, bf16: "
            f"kernel {t['ms']:.3f} ms, bound {t['bound_ms']:.3f} ms (bytes "
            f"{t['bytes_ms']:.3f}, operations {t['ops_ms']:.3f}), plain "
            f"{t['plain_ms']:.3f} ms, cuDNN {t['library_ms']:.3f} ms; "
            f"back-to-back: kernel {t['burst_ms']:.3f} ms, cuDNN "
            f"{t['library_burst_ms']:.3f} ms")
    return tot, err, rel


def dw_host_us(gen) -> None:
    """The host's time (µs per call, host clock) of each depthwise pass
    through its kernel wrapper and through cuDNN, and of one layer's
    forward + backward through the opt-in Function and through the grouped
    conv, at a small layer (N = 8, 40 channels at 28 px, bf16), where the
    device's work is short and the host's issue time shows."""
    shape = (40, 28, 28, 3, 1)
    c, h, w, k, s = shape
    x, g, wt = dw_operands(gen, DW_COMPARE_N, shape, torch.bfloat16)
    taps = DW._taps(wt)
    xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    conv_bwd = torch.ops.aten.convolution_backward
    xl = xc.detach().requires_grad_(True)
    wl = wt.float().detach().requires_grad_(True)

    def layer(kernels: bool):
        def run():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                y = (DW.depthwise_conv(xl, wl, s) if kernels else
                     torch.nn.functional.conv2d(xl, wl, stride=s,
                                                padding=k // 2, groups=c))
            torch.autograd.grad(y.float().sum(), (xl, wl))
        return run

    timed = {
        "forward": (lambda: DW.depthwise_forward(x, taps, s),
                    lambda: torch.nn.functional.conv2d(
                        xc, wt, stride=s, padding=k // 2, groups=c)),
        "dx": (lambda: DW.depthwise_grad_x(g, taps, s, h, w),
               lambda: conv_bwd(gc, xc, wt, None, [s, s], [k // 2] * 2,
                                [1, 1], False, [0, 0], c,
                                [True, False, False])),
        "dw": (lambda: DW.depthwise_grad_w(x, g, k, s),
               lambda: conv_bwd(gc, xc, wt, None, [s, s], [k // 2] * 2,
                                [1, 1], False, [0, 0], c,
                                [False, True, False])),
        "layer forward + backward (autocast)": (layer(True), layer(False)),
    }
    log(f"host time per call at {shape}, N = {DW_COMPARE_N}, bf16 (µs, host "
        "clock; kernel wrapper / cuDNN): " + "; ".join(
            f"{name} {host_us(a):.1f} / {host_us(b):.1f}"
            for name, (a, b) in timed.items()))


def t3_config(checkpoint_dir: str | None, **kw):
    return make_config("train_efficient_cos_con_ce_loss",
                       batch_size=TRAIN_BATCH, image_size=SIZE,
                       checkpoint_dir=checkpoint_dir, **kw)


def set_opt_in(on: bool) -> None:
    if on:
        os.environ["IRT_FORCE_PALLAS_DW"] = "1"
    else:
        os.environ.pop("IRT_FORCE_PALLAS_DW", None)


def fit_once(model, init: dict, train, val, kernels: bool,
             label: str | None = None) -> dict:
    """One epoch of ``Trainer.fit`` from ``init``, launch counts set to 0
    just before and read just after; its per-step losses from
    metrics.jsonl."""
    set_opt_in(kernels)
    model.load_state_dict(init)
    with tempfile.TemporaryDirectory() as d:
        trainer = Trainer(t3_config(d, log_every_n_steps=1), model, train,
                          val)
        for mod in (DW, IK):
            mod.reset_launch_counts()
        (state, hist), ms = sync_time(lambda: trainer.fit(max_epochs=1))
        counts = {"dw": dict(DW.KERNEL_LAUNCHES),
                  "dw_plain": dict(DW.PLAIN_ON_CARD),
                  "copies": dict(DW.LAYOUT_COPIES),
                  "image": dict(IK.KERNEL_LAUNCHES),
                  "image_plain": dict(IK.PLAIN_ON_CARD)}
        with open(os.path.join(d, "metrics.jsonl")) as f:
            losses = [r["train_loss"] for r in map(json.loads, f)
                      if "train_loss" in r]
        saved = {kind: os.listdir(os.path.join(d, kind))
                 for kind in ("best", "last")}
    epoch = hist["epochs"][0]
    assert state.step == TRAIN_STEPS and len(losses) == TRAIN_STEPS
    assert all(np.isfinite(v) for v in epoch.values()), epoch
    assert saved == {"best": [str(TRAIN_STEPS)], "last": [str(TRAIN_STEPS)]}
    log(f"T3 fit, 1 epoch ({TRAIN_STEPS} steps of {TRAIN_BATCH} triplets + 1 "
        f"val batch), "
        f"{label or ('depthwise kernels' if kernels else 'cuDNN')}: "
        f"{ms:.0f} ms (first use, includes warm-up); train_loss per step "
        f"{losses}; val_loss {epoch['val_loss']:.5g}, cos_sims "
        f"{epoch['cos_sims']:.5g}; launches {counts}")
    return {"losses": losses, "counts": counts}


@contextlib.contextmanager
def planted(fault: str):
    """The opt-in path with one slip of its autograd wiring, undone on
    exit: "forward" runs the forward on transposed taps, "dx" leaves dx's
    taps unflipped, "dw" transposes the tap gradients. The kernels stay
    as they are."""
    fwd = vars(DW._DepthwiseConv)["forward"]
    grad_x, grad_w = DW.depthwise_grad_x, DW.depthwise_grad_w
    if fault == "forward":
        DW._DepthwiseConv.forward = staticmethod(
            lambda ctx, x, w, s: fwd.__func__(ctx, x, w.transpose(2, 3), s))
    elif fault == "dx":
        DW.depthwise_grad_x = lambda g, taps, s, h, w: DW.depthwise_forward(
            DW.dilate(g, s, h, w), taps, 1)
    else:
        DW.depthwise_grad_w = lambda x, g, k, s: grad_w(
            x, g, k, s).transpose(0, 1).contiguous()
    try:
        yield
    finally:
        DW._DepthwiseConv.forward = fwd
        DW.depthwise_grad_x, DW.depthwise_grad_w = grad_x, grad_w


def f32_step(model, init: dict, train, kernels: bool, layers) -> tuple:
    """One f32 train step (TF32 off) on 16 triplets from ``init``: the loss
    and the gradients of the depthwise weights of ``layers``."""
    set_opt_in(kernels)
    model.load_state_dict(init)
    cfg = t3_config(None, compute_dtype="float32")
    trainer = Trainer(cfg, model, train)
    raw = {k: ([a[:16] for a in v] if isinstance(v, list) else v[:16])
           for k, v in train.batches[0].items()}
    batch = trainer.transform(raw, torch.Generator(DEV).manual_seed(SEED))
    batch = {**batch, **{k: torch.as_tensor(raw[k], device=DEV)
                         for k in ("cat_idx", "prod_idx")}}
    step = build_train_step(cfg, trainer.schedule)
    _, metrics = step(trainer.init_state(), batch,
                      torch.Generator(DEV).manual_seed(SEED))
    return (float(metrics["train_loss"]),
            [layers[i].weight.grad.clone() for i in range(len(layers))])


def timed_epochs(model, init: dict, train, kernels: bool) -> dict:
    """Warm epoch time of the T3 path (wall around a synchronised epoch
    and CUDA events), peak memory, and one profiled epoch."""
    set_opt_in(kernels)
    model.load_state_dict(init)
    trainer = Trainer(t3_config(None), model, train)
    state = trainer.init_state()
    trainer.train_epoch(state, 0)
    torch.cuda.reset_peak_memory_stats()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    trainer.train_epoch(state, 1)
    b.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    ev = a.elapsed_time(b) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated() / 1e9
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, pwall = sync_time(lambda: trainer.train_epoch(state, 2))
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    name = "depthwise kernels" if kernels else "cuDNN"
    log(f"T3 train step, {name}, warm: {wall:.1f} ms wall, {ev:.1f} ms CUDA "
        f"events per step of {TRAIN_BATCH} triplets (epoch of "
        f"{TRAIN_STEPS}); peak {peak:.2f} GB; profiled epoch {pwall:.1f} ms "
        f"wall, {busy:.1f} ms device busy, idle share "
        f"{1 - busy / pwall:.3f}; top device ops:")
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:12]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<5d} "
            f"{e.key[:90]}")
    # where the host's time goes (the step is host-bound where the device
    # idles): the top host ops by self time
    host = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    host.sort(key=lambda e: -e.self_cpu_time_total)
    log("  top host ops by self time: " + "; ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.1f} ms x{e.count}"
        for e in host[:8]))
    return {"wall": wall, "events": ev, "peak": peak, "idle": 1 - busy / pwall}


def dx_kernels_only(shapes, gen) -> None:
    """The dx path on the card launches its own kernel and nothing else
    (no dilated copy, no flip): the device kernels of ``depthwise_grad_x``
    at each stride-2 layer, N = DW_COMPARE_N, in one profiled window that
    runs them twice (the profiler has missed launches at the start of its
    window on the card, and once, with CUDA activity alone, the whole
    window; host activity is recorded beside it, as every other profiled
    window here does)."""
    calls = []
    for c, h, w, k, s in shapes:
        if s == 2:
            _, g, wt = dw_operands(gen, DW_COMPARE_N, (c, h, w, k, s),
                                   torch.bfloat16)
            calls.append((g, DW._taps(wt), s, h, w))
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            for args in calls:
                DW.depthwise_grad_x(*args)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    assert names and all("dw_band_kernel" in n for n in names), names
    log(f"dx on the card, profiled twice at b3a's {len(calls)} stride-2 "
        f"layers: device kernels {sorted(n[:60] for n in names)} only (no "
        "dilate, no flip)")


def training_phase(serving_model, gen, peaks: dict) -> list:
    """Phase 6: kernels 9 and 10 against their plain versions and timed,
    then the T3 training path with them and on cuDNN; returns their
    entries of the ``kernels`` line."""
    shapes = dw_layer_shapes(serving_model)
    assert len(shapes) == 26, shapes
    err_small, _ = dw_compare(shapes + DW_RAGGED, gen)
    dx_kernels_only(shapes, gen)
    dw_host_us(gen)
    tot, err_path, _ = dw_times(shapes, gen, peaks)
    errs = {"depthwise_conv_forward": 0.0,
            "depthwise_conv_grad_w": max(err_small, err_path)}

    model = create_model("efficientnet_b3a", num_classes=N_CLASSES,
                         seed=SEED)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(SEED)
    train = MemoryLoader(rng, TRAIN_STEPS, TRAIN_BATCH)
    val = MemoryLoader(rng, 1, TRAIN_BATCH)

    # the main path: kernels 9 and 10 on every depthwise layer
    ours = fit_once(model, init, train, val, kernels=True)
    launches = ours["counts"]["dw"]
    per_step = {k: 3 * n for k, n in launches_per_policy().items()}
    assert launches == {
        "depthwise_conv_forward": 26 * TRAIN_STEPS + 26,
        "depthwise_conv_grad_x": 26 * TRAIN_STEPS,
        "depthwise_conv_grad_w": 26 * TRAIN_STEPS}, launches
    assert ours["counts"]["image"] == {
        k: TRAIN_STEPS * n for k, n in per_step.items()}, ours["counts"]
    for plain in ("dw_plain", "image_plain"):
        assert not any(ours["counts"][plain].values()), ours["counts"]
    # the activations reach the kernels as channels-last views
    assert ours["counts"]["copies"] == {"nhwc": 0}, ours["counts"]
    ref = fit_once(model, init, train, val, kernels=False)
    assert not any(ref["counts"]["dw"].values()), ref["counts"]

    def rel(run):
        return [abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                     ref["losses"])]
    faulted = {}
    for fault in BF16_FAULTS:
        with planted(fault):
            faulted[fault] = rel(fit_once(model, init, train, val, True,
                                          f"planted fault: {fault}"))
    log(f"T3 train_loss per step against cuDNN's (bf16), relative "
        f"differences: depthwise kernels {rel(ours)}; planted faults "
        f"{faulted}; tolerances {BF16_LOSS_RTOL}")
    assert all(r <= t for r, t in zip(rel(ours), BF16_LOSS_RTOL)), rel(ours)
    for fault, r in faulted.items():
        assert any(a > t for a, t in zip(r, BF16_LOSS_RTOL)), (fault, r)

    dws = [m for m in model.modules() if isinstance(m, DepthwiseConv2d)]
    layers = [dws[0], dws[len(dws) // 2], dws[-1]]
    l_r, g_r = f32_step(model, init, train, False, layers)

    def f32_rel(fault=None):
        with planted(fault) if fault else contextlib.nullcontext():
            l_k, g_k = f32_step(model, init, train, True, layers)
        return (abs(l_k - l_r) / abs(l_r),
                max(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(g_k, g_r)))
    sound = f32_rel()
    faulted = {fault: f32_rel(fault) for fault in DW_FAULTS}
    log(f"one f32 T3 step on 16 triplets (TF32 off) against cuDNN's: loss "
        f"{l_r:.7g}; relative loss difference and depthwise weight gradients "
        f"of layers 0, 13, 25 (max |diff| / max |grad|): depthwise kernels "
        f"{sound}; planted faults {faulted}; tolerances "
        f"{(F32_LOSS_RTOL, F32_GRAD_RTOL)}")
    assert sound[0] <= F32_LOSS_RTOL and sound[1] <= F32_GRAD_RTOL, sound
    for fault, (dl, dg) in faulted.items():
        assert dl > F32_LOSS_RTOL or dg > F32_GRAD_RTOL, (fault, dl, dg)

    # warm step times, in turns: kernels, cuDNN, cuDNN, kernels
    for kernels in (True, False, False, True):
        timed_epochs(model, init, train, kernels)
    set_opt_in(False)

    entries = []
    # kernel 9 (the TPU's _dw_fwd_kernel, which JAX runs for dx too): the
    # forward and dx kernels' launches and times together
    for name, passes, counters in (
            ("depthwise_conv_forward", ("forward", "dx"),
             ("depthwise_conv_forward", "depthwise_conv_grad_x")),
            ("depthwise_conv_grad_w", ("dw",), ("depthwise_conv_grad_w",))):
        def total(key):
            return sum(tot[p][key] for p in passes)
        entries.append({
            "name": name,
            "route": "cuda",
            "source": DW_SOURCE,
            "replaces": f"imageretrievalresearch_tpu/{DW_KERNELS[name]}",
            "launches": sum(launches[c] for c in counters),
            "max_abs_err": errs[name],
            "ms": total("ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": ("bytes" if total("bytes_ms") >= total("ops_ms")
                         else "operations"),
            "library_ms": total("library_ms"),
            "ms_by": "single call",
            "burst_ms": total("burst_ms"),
            "library_burst_ms": total("library_burst_ms"),
        })
    return entries


def scores_bounds(q: int, g: int, d: int, peaks: dict) -> dict:
    """Kernel 4's bounds (``f32_bounds``), by JAX's cost estimate: bytes
    (Q·D + G·D + Q·G)·4 against 2·Q·G·D operations."""
    return f32_bounds(4 * (q * d + g * d + q * g), 2 * q * g * d, peaks)


def scores_check(qh, g, exact: bool) -> float:
    """Kernel 4 against its plain version on the card, one launch each
    (not counted): bitwise where ``exact``, else within 1e-5. Returns the
    largest |kernel - plain|."""
    R.reset_launch_counts()
    got, want = R.fused_cosine_scores(qh, g), R.cosine_scores_reference(qh, g)
    torch.cuda.synchronize()
    assert got.shape == (qh.shape[0], g.shape[0])
    err = (got - want).abs().max().item()
    if exact:
        assert torch.equal(got, want), (tuple(qh.shape), tuple(g.shape), err)
    assert err <= 1e-5, (tuple(qh.shape), tuple(g.shape), err)
    return err


def inference_phase(model, index, paths, gen, peaks) -> list:
    """Phase 7: the inference evaluation on the scores kernel (kernel 4),
    kernel 4 at the main path's gallery and against its plain version, and
    the profiling tool's ladder (kernel 11) and stream probe (kernel 12);
    returns their entries of the ``kernels`` line."""
    eval_tf = build_eval_transform("squarepad", SIZE)
    engines = {flag: RetrievalEngine(model, transform=eval_tf,
                                     use_pallas=flag)
               for flag in (True, False)}
    loader = MemoryLoader(np.random.default_rng(SEED + 7), EVAL_BATCHES,
                          TRAIN_BATCH)
    n_eval = EVAL_BATCHES * TRAIN_BATCH

    # 7.1 the inference CLI's evaluation on kernel 4: embed_triplet_loader
    # -> evaluate_class_dedup / evaluate_index_match, counts set to 0 just
    # before and read just after
    R.reset_launch_counts()
    embeds, embed_ms = sync_time(
        lambda: engines[True].embed_triplet_loader(loader))
    assert not any(R.KERNEL_LAUNCHES.values()), R.KERNEL_LAUNCHES
    dedup, dedup_ms = sync_time(lambda: engines[True].evaluate_class_dedup(
        embeds, k=K, num_unique=3))
    assert R.KERNEL_LAUNCHES["fused_cosine_scores"] == 1, R.KERNEL_LAUNCHES
    match, match_ms = sync_time(
        lambda: engines[True].evaluate_index_match(embeds))
    launches = dict(R.KERNEL_LAUNCHES)
    plain = dict(R.PLAIN_ON_CARD)
    log(f"inference evaluation, use_pallas=True: embed_triplet_loader "
        f"({EVAL_BATCHES} batches of {TRAIN_BATCH} seeded {TRAIN_SRC} px "
        f"triplets, b3a at {SIZE} px) {embed_ms:.1f} ms; "
        f"evaluate_class_dedup (k={K}, Q=G={n_eval}) {dedup_ms:.1f} ms; "
        f"evaluate_index_match {match_ms:.1f} ms; launches {launches}")
    # one query block of 512 per evaluation: one launch each
    assert launches["fused_cosine_scores"] == 2, launches
    assert sum(launches.values()) == 2, launches
    assert not any(plain.values()), f"plain versions ran on the card: {plain}"
    for key in ("fms_ims_all", "fms_poss_all", "fms_negs_all"):
        assert embeds[key].shape == (n_eval, DIM), embeds[key].shape
        assert np.isfinite(embeds[key]).all()
    assert embeds["classes_all"].shape == (n_eval,)
    ref_dedup = engines[False].evaluate_class_dedup(embeds, k=K,
                                                    num_unique=3)
    ref_match = engines[False].evaluate_index_match(embeds)
    for key in ("top1", "top3"):
        assert dedup[key] == ref_dedup[key], (key, dedup[key],
                                              ref_dedup[key])
        assert match[key] == ref_match[key], (key, match[key],
                                              ref_match[key])
    verr = np.abs(dedup["top_vals"] - ref_dedup["top_vals"]).max()
    assert verr <= 1e-5, verr
    n_pos = int((dedup["topk_inds"] != ref_dedup["topk_inds"]).sum())
    assert abs(match["loss"] - ref_match["loss"]) <= 1e-5
    log(f"  against use_pallas=False (fused kernel 1 / dense): top1 "
        f"{dedup['top1']:.4f} / {ref_dedup['top1']:.4f}, top3 "
        f"{dedup['top3']:.4f} / {ref_dedup['top3']:.4f} (class dedup); "
        f"index match top1 {match['top1']:.4f}, top3 {match['top3']:.4f}, "
        f"loss {match['loss']:.6f} / {ref_match['loss']:.6f}; {n_pos} "
        f"deduped positions differ, values within {verr:.3g}")

    # 7.2 kernel 4 on the main path's gallery: RetrievalEngine.search
    gal, norms = index._gallery_on_device()
    for n, emb in ((64, paths["float32"][0][0]), (8, paths["float32"][2][0])):
        assert emb.shape == (n, DIM)
        R.reset_launch_counts()
        _, cold_ms = sync_time(lambda: engines[True].search(emb, gal, k=K))
        (v, i), warm_ms = sync_time(
            lambda: engines[True].search(emb, gal, k=K))
        counts, plain = dict(R.KERNEL_LAUNCHES), dict(R.PLAIN_ON_CARD)
        assert counts["fused_cosine_scores"] == 2, counts
        assert sum(counts.values()) == 2, counts
        assert not any(plain.values()), plain
        qh = R.l2_normalize(emb)
        fv, fi = R.cosine_topk(emb, gal, K, gallery_norms=norms,
                               method="fused")
        v, i = torch.from_numpy(v).to(DEV), torch.from_numpy(i).to(DEV)
        verr = (v - fv).abs().max().item()
        assert verr <= 1e-5, (n, verr)
        n_diff = near_tie_rows(
            i, fi, R.dense_scores(qh, gal, gallery_norms=norms),
            fv[:, K - 1:K], ("search", n))
        log(f"RetrievalEngine(use_pallas=True).search, Q={n}, G={G_TOTAL}, "
            f"k={K}: {cold_ms:.2f} ms first, {warm_ms:.2f} ms warm (host "
            f"clock, synchronised); launches {counts}; against the fused "
            f"kernel 1: max |vals| diff {verr:.3g}, {n_diff} of {n} rows "
            "with index sets that differ, only at near-ties")

    # 7.3 kernel 4 against its plain version: ±1 rows with 16 nonzeros
    # (norm 4, every partial sum exact) bitwise, seeded float rows within
    # 1e-5, at the path's Q = 64 and 512 over G = 100,000 and at a ragged
    # shape; then its times
    err = 0.0
    pg = pm1_rows(gen, G_TOTAL, DIM, nnz=16)
    for q in (64, 512):
        err = max(err, scores_check(R.l2_normalize(pm1_rows(gen, q, DIM, 16)),
                                    pg, exact=True))
        err = max(err, scores_check(R.l2_normalize(torch.randn(
            (q, DIM), generator=gen, device=DEV)), gal, exact=False))
    del pg
    q, g, d = SCORES_RAGGED
    err = max(err, scores_check(R.l2_normalize(pm1_rows(gen, q, d, 16)),
                                pm1_rows(gen, g, d, 16), exact=True))
    err = max(err, scores_check(R.l2_normalize(torch.randn(
        (q, d), generator=gen, device=DEV)), torch.randn(
        (g, d), generator=gen, device=DEV) * 3, exact=False))
    log(f"scores kernel vs plain version at Q=64 and 512 x G={G_TOTAL} x "
        f"D={DIM} and at {SCORES_RAGGED}: bitwise on ±1 rows, max "
        f"|kernel - plain| {err:.3g} on float rows (limit 1e-5)")
    # against f64 on seeded unit rows over the served gallery: the kernel's
    # 3xTF32 within 1e-6, beside the plain version's true f32
    g64 = gal.double()
    g64 = g64 / torch.clamp(torch.linalg.vector_norm(g64, dim=1, keepdim=True),
                            min=R.COSINE_SIM_EPS)
    for q in (64, 512):
        qh = R.l2_normalize(torch.randn((q, DIM), generator=gen, device=DEV))
        R.reset_launch_counts()   # comparison launches are not counted
        got, want = R.fused_cosine_scores(qh, gal), \
            R.cosine_scores_reference(qh, gal)
        exact = qh.double() @ g64.t()
        k_err = (got.double() - exact).abs().max().item()
        p_err = (want.double() - exact).abs().max().item()
        log(f"scores kernel Q={q} against f64 (seeded unit rows, served "
            f"gallery): max |kernel - f64| {k_err:.3g} (limit 1e-6), max "
            f"|plain - f64| {p_err:.3g}")
        assert k_err <= 1e-6, (q, k_err)
        del got, want, exact
    del g64
    entries = []
    row = {}
    for q in (64, 512):
        qh = R.l2_normalize(paths["float32"][0][0]) if q == 64 else \
            R.l2_normalize(torch.randn((q, DIM), generator=gen, device=DEV))
        call = (lambda: R.fused_cosine_scores(qh, gal))
        lib_call = (lambda: torch.matmul(qh, R.l2_normalize(gal).t()))
        ms, b_ms = event_ms(call, reps=20), PF.pipelined_ms(call)
        plain_ms = event_ms(lambda: R.cosine_scores_reference(qh, gal),
                            reps=10)
        library_ms = event_ms(lib_call, reps=10)
        lib_b_ms = PF.pipelined_ms(lib_call)
        bounds = scores_bounds(q, G_TOTAL, DIM, peaks)
        log(f"fused_cosine_scores Q={q} G={G_TOTAL} D={DIM}: {ms:.3f} ms, "
            f"back-to-back {b_ms:.3f} (bound {bounds['bound_ms']:.3f} ms, "
            f"{bounds['bound_by']}, 3xTF32; f32-FMA bound "
            f"{bounds['f32_fma_bound_ms']:.3f}); plain {plain_ms:.3f} ms; "
            f"library {library_ms:.3f} ms, back-to-back {lib_b_ms:.3f} "
            "(torch.matmul(q̂, l2_normalize(g)ᵀ), f32, TF32 off)")
        if q == 64:
            row = {
                "name": "fused_cosine_scores", "route": "cuda",
                "source": "imageretrievalresearch_tpu_torch/csrc/"
                          "fused_topk.cu",
                "replaces": "imageretrievalresearch_tpu/ops/retrieval.py:109",
                "launches": launches["fused_cosine_scores"],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                **bounds, "library_ms": library_ms, "ms_by": "single call",
                "burst_ms": b_ms, "library_burst_ms": lib_b_ms}
        else:
            row.update({"ms_q512": ms, "burst_ms_q512": b_ms,
                        "plain_ms_q512": plain_ms,
                        "library_ms_q512": library_ms,
                        "library_burst_ms_q512": lib_b_ms,
                        "bound_ms_q512": bounds["bound_ms"],
                        "bound_by_q512": bounds["bound_by"],
                        "f32_fma_bound_ms_q512":
                            bounds["f32_fma_bound_ms"]})
    entries.append(row)

    # 7.4 kernel 11, the ladder: each rung against its plain version on ±1
    # data (every word, sum and score exact: bitwise) and stream_only on
    # the float gallery within its stated bound; then the tool's ladder at
    # Q = 64 over the resident f32 and bf16 galleries, counts set to 0
    # just before and read just after
    q_hat = R.l2_normalize(paths["float32"][0][0])
    pq, pg = R.l2_normalize(pm1_rows(gen, 64, DIM)), pm1_rows(gen, G_TOTAL,
                                                              DIM)
    variants = PF.build_variants()
    # each mode's resident form: (gallery, the rungs' keyword arguments);
    # the int8 ladder is the port's own (kernel 3; JAX's tool has none)
    g8, gs8 = index._gallery_on_device("int8")
    forms = {"float32": (gal, {"gallery_norms": norms}),
             "bfloat16": (index._gallery_on_device("bfloat16")[0], {}),
             "int8": (g8, {"gallery_scale": gs8})}
    tags = {"float32": "f32", "bfloat16": "bf16", "int8": "int8"}
    errs = {}
    splits = R.fused_splits(64, G_TOTAL, K, DEV)
    for mode in forms:
        g_pm1, s_pm1 = ((pg, None) if mode == "float32"
                        else R._prepare_gallery(pg, mode))
        for rung in PF.RUNGS:
            got = variants[rung].kernel(pq, g_pm1, K, gallery_scale=s_pm1)
            want = variants[rung].plain(pq, g_pm1, K, splits=splits,
                                        gallery_scale=s_pm1)
            torch.cuda.synchronize()
            for a, b in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                assert torch.equal(a, b), (mode, rung)
            errs[(mode, rung)] = 0.0
        g_in, aux = forms[mode]
        got = variants["stream_only"].kernel(q_hat, g_in, K, **aux)
        want = variants["stream_only"].plain(q_hat, g_in, K, splits=splits,
                                             **aux)
        scale = variants["stream_only"].plain(
            q_hat.abs(), g_in.abs(), K, splits=splits, **aux)
        err = (got - want).abs()
        rtol = PF.stream_only_rtol(G_TOTAL, DIM, splits, g_in.dtype)
        assert (err <= rtol * scale).all(), (mode, (err / scale).max())
        errs[(mode, "stream_only")] = err.max().item()
        log(f"ladder ({mode}): stream_only, matmul_only, insert_only "
            f"bitwise equal to their plain versions on ±1 data; stream_only "
            f"on the served gallery within {(err / scale).max().item():.3g} "
            f"of the sum of |words| (limit {rtol:.3g})")
    del pq, pg, g_pm1, s_pm1

    PF.reset_launch_counts()
    R.reset_launch_counts()
    ladder = {mode: PF.run_ladder(q_hat, g_in, K, **aux)
              for mode, (g_in, aux) in forms.items()}
    ladder_launches = dict(PF.KERNEL_LAUNCHES)
    assert not any(R.PLAIN_ON_CARD.values())
    for mode, times in ladder.items():
        tag = tags[mode]
        for rung in PF.RUNGS:
            assert ladder_launches[f"fused_topk_{tag}_{rung}"] > 0
        log(f"ladder ({mode}), Q=64 G={G_TOTAL} D={DIM} k={K}, back-to-back "
            f"launches (CUDA events): " + ", ".join(
                f"{n} {t:.3f} ms" for n, t in times.items()))
        for phase, t in PF.attribution(times).items():
            log(f"  {phase:26s} {t:8.3f} ms")
    with tempfile.TemporaryDirectory() as d:
        with trace(d) as prof:
            # two bursts: the profiler missed the first rung's launches at
            # the start of its window in a run on the card
            for _ in range(2):
                PF.run_ladder(q_hat, gal, K, gallery_norms=norms, n_iter=2,
                              repeats=1)
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "fused_topk_tc_kernel" in e.key]
        assert len(os.listdir(d)) == 1 and len(names) == 4, names
    log(f"utils.profiling.trace of one f32 ladder burst: the four phases of "
        f"the tensor-core kernel's F32 instance on the device: {names}")
    for mode, (g_in, aux) in forms.items():
        tag = tags[mode]
        g_bytes = g_in.numel() * g_in.element_size() + 4 * G_TOTAL * len(aux)
        for rung in PF.RUNGS:
            plain_ms = event_ms(lambda: variants[rung].plain(
                q_hat, g_in, K, splits=splits, **aux), reps=3, warmup=1)
            out_bytes = 4 * 64 * splits * (2 * K if rung == "insert_only"
                                           else 1)
            nbytes = 4 * 64 * DIM + g_bytes + out_bytes
            ops = 0 if rung == "stream_only" else 2 * 64 * G_TOTAL * DIM
            # f32: the 3xTF32 bound, and the f32-FMA one beside it
            bounds = (f32_bounds(nbytes, ops, peaks) if mode == "float32"
                      else dict(zip(("bound_ms", "bound_by"),
                                    bound(nbytes, ops, peaks, mode))))
            entries.append({
                "name": f"fused_topk_{tag}_{rung}", "route": "cuda",
                "source": "imageretrievalresearch_tpu_torch/csrc/"
                          "fused_topk.cu",
                "replaces": f"tools/profile_fused_kernel.py:{LADDER[rung]}",
                "launches": ladder_launches[f"fused_topk_{tag}_{rung}"],
                "max_abs_err": errs[(mode, rung)],
                "ms": ladder[mode][rung], "plain_ms": plain_ms, **bounds,
                "library_ms": None, "ms_by": "back-to-back",
                "burst_ms": ladder[mode][rung], "library_burst_ms": None})

    # 7.5 kernel 12, the stream probe over a (100,352, 1536) f32 array:
    # bitwise on small integers (exact in f32), within its stated bound on
    # float data; then the tool's probes, counts set to 0 just before and
    # read just after, and the torch read+write pass
    x = torch.randint(-3, 4, (PF.G_PAD, DIM), generator=gen, device=DEV
                      ).float()
    for rows in PF.PROBE_ROWS:
        assert torch.equal(PF.stream_probe(x, rows),
                           PF.stream_probe_reference(x, rows)), rows
    x.normal_(generator=gen)
    perr = 0.0
    for rows in PF.PROBE_ROWS:
        err = (PF.stream_probe(x, rows)
               - PF.stream_probe_reference(x, rows)).abs()
        scale = PF.stream_probe_reference(x.abs(), rows)
        rtol = PF.stream_probe_rtol(PF.G_PAD, DIM, rows)
        assert (err <= rtol * scale).all(), (rows, (err / scale).max())
        perr = max(perr, err.max().item())
    torch.cuda.synchronize()
    log(f"stream probe vs plain version at rows {PF.PROBE_ROWS}: bitwise on "
        f"small integers; float data within the stated bound (max |diff| "
        f"{perr:.3g})")
    PF.reset_launch_counts()
    probes = PF.run_probes(x)
    probe_launches = PF.KERNEL_LAUNCHES["stream_probe"]
    assert probe_launches > 0
    x_bytes = x.numel() * 4
    for rows, ms in probes.items():
        log(f"stream probe, blocks of ({rows}, {DIM}) over "
            f"{x_bytes / 1e6:.1f} MB: {ms:.4f} ms = "
            f"{x_bytes / ms / 1e6:.1f} GB/s read")
    rw_ms = PF.torch_stream_ms(x)
    log(f"torch elementwise read+write pass (torch.mul(x, c, out=y)): "
        f"{rw_ms:.4f} ms = {2 * x_bytes / rw_ms / 1e6:.1f} GB/s")
    rows = min(probes, key=probes.get)   # the fastest height
    sum_ms = event_ms(lambda: PF.stream_probe_reference(x, rows), reps=10)
    sum_b_ms = PF.pipelined_ms(lambda: PF.stream_probe_reference(x, rows))
    log(f"stream probe row: rows={rows}; plain = library = one torch call "
        f"x.reshape(-1, rows, D).sum((0, 2)): {sum_ms:.4f} ms, "
        f"back-to-back {sum_b_ms:.4f}")
    bound_ms, bound_by = bound(x_bytes + 4 * rows, x.numel(), peaks)
    entries.append({
        "name": "stream_probe", "route": "cuda",
        "source": "imageretrievalresearch_tpu_torch/csrc/stream_probe.cu",
        "replaces": "tools/profile_fused_kernel.py:212",
        "launches": probe_launches, "max_abs_err": perr,
        "ms": probes[rows], "plain_ms": sum_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": sum_ms, "ms_by": "back-to-back",
        "burst_ms": probes[rows], "library_burst_ms": sum_b_ms})
    del x
    return entries


def codec_report() -> str:
    """What this machine offers for image decoding: whether PIL, cv2 and
    torchvision.io import (each in a child process: the port itself never
    imports them), and whether a program against jpeglib.h and png.h
    compiles and links with -ljpeg -lpng. A report only."""
    found = []
    for mod in ("PIL", "cv2", "torchvision.io"):
        r = subprocess.run([sys.executable, "-c", f"import {mod}"],
                           capture_output=True, text=True, timeout=300)
        err = (r.stderr.strip().splitlines() or ["?"])[-1]
        found.append(f"{mod} {'imports' if r.returncode == 0 else err}")
    cc = shutil.which("cc") or shutil.which("gcc") or shutil.which("g++")
    if cc is None:
        probe = "no C compiler on PATH"
    else:
        with tempfile.TemporaryDirectory() as d:
            src, exe = os.path.join(d, "probe.c"), os.path.join(d, "probe")
            with open(src, "w") as f:
                f.write(CODEC_PROBE)
            r = subprocess.run([cc, src, "-o", exe, "-ljpeg", "-lpng"],
                               capture_output=True, text=True, timeout=300)
            if r.returncode == 0:
                ran = subprocess.run([exe], capture_output=True, text=True,
                                     timeout=60)
                probe = f"compiles and links ({ran.stdout.strip()})"
            else:
                lines = (r.stderr.strip().splitlines() or ["?"])
                probe = f"does not build: {lines[0][:160]}"
    return (f"image codecs on this machine: {'; '.join(found)}; a C program "
            f"with jpeglib.h + png.h, -ljpeg -lpng ({cc}): {probe}")


def png_bytes(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> an RGB PNG whose rows cycle through the five
    filter types (None, Sub, Up, Average, Paeth)."""
    h, w, _ = img.shape
    x = img.reshape(h, w * 3).astype(np.int16)
    up = np.vstack([np.zeros_like(x[:1]), x[:-1]])
    left = np.pad(x, ((0, 0), (3, 0)))[:, :-3]
    upleft = np.pad(up, ((0, 0), (3, 0)))[:, :-3]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    ftype = np.arange(h) % 5
    pred = np.choose(ftype[:, None], (np.zeros_like(x), left, up,
                                      (left + up) >> 1, paeth))
    raw = np.hstack([ftype[:, None].astype(np.uint8),
                     ((x - pred) & 255).astype(np.uint8)]).tobytes()

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def smooth_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A seeded gradient in two random colours with three flat shapes."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi)
    t = x * np.cos(ang) + y * np.sin(ang)
    t = (t - t.min()) / max(float(t.max() - t.min()), 1.0)
    c0, c1 = rng.uniform(0, 255, (2, 3)).astype(np.float32)
    img = c0 + (c1 - c0) * t[..., None]
    for _ in range(3):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(0.05, 0.25) * min(h, w)
        mask = ((y - cy) ** 2 + (x - cx) ** 2 < r * r if rng.random() < 0.5
                else (np.abs(y - cy) < r) & (np.abs(x - cx) < r))
        img[mask] = rng.uniform(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_cli_tree(root: str) -> tuple[str, str]:
    """The phase's PNG tree under ``root``: ``gallery/class_<c>/`` and
    ``queries/``; returns both directories."""
    rng = np.random.default_rng(SEED + 8)
    gal, qry = os.path.join(root, "gallery"), os.path.join(root, "queries")
    for c in range(CLI_CLASSES):
        os.makedirs(os.path.join(gal, f"class_{c}"))
        for i in range(CLI_PER_CLASS):
            with open(os.path.join(gal, f"class_{c}", f"{i:03d}.png"),
                      "wb") as f:
                f.write(png_bytes(smooth_image(rng, CLI_SRC, CLI_SRC)))
    os.makedirs(qry)
    for i in range(CLI_QUERIES):
        h, w = (CLI_SRC, CLI_SRC) if i % 2 else (200, 300)
        with open(os.path.join(qry, f"q{i:03d}.png"), "wb") as f:
            f.write(png_bytes(smooth_image(rng, h, w)))
    return gal, qry


def cli_stdout(argv: list) -> tuple[list, float]:
    """``run(build_parser().parse_args(argv))`` in this process: its JSON
    lines and its wall ms (host clock, synchronised)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, ms = sync_time(lambda: CLI.run(CLI.build_parser().parse_args(
            argv)))
    return [json.loads(line) for line in buf.getvalue().splitlines()], ms


def library_path(npz: str, paths: list):
    """The library path for the same query files: ``data.decode`` with the
    artifact's host size, ``RetrievalEngine`` over the same seeded model,
    then (the returned function of the mode)
    ``GalleryIndex.query_class_dedup`` on the same artifact."""
    idx = GalleryIndex.load(npz)
    host = idx.meta["host_size"]
    x = np.stack([resize_bilinear_host(square_pad_host(decode_image(p)),
                                       (host, host)) for p in paths])
    model = create_model("efficientnet_b3a",
                         num_classes=idx.meta["num_classes"])
    engine = RetrievalEngine(model, transform=build_eval_transform(
        "squarepad", SIZE))
    emb = engine.embed_batch(x)

    def records(mode: str) -> list:
        vals, inds, cls = idx.query_class_dedup(emb, k=K, num_unique=3,
                                                matmul_dtype=mode,
                                                shortlist=SHORTLIST)
        return CLI._records(vals, inds, cls, idx.paths)

    return records


def near_tie_records(recs: list, refs: list, where: str) -> int:
    """Rows whose indices differ; at every position the two records'
    scores agree within SERVE_TIE_ATOL, so a differing index is a near-tie
    swap."""
    n_diff = 0
    for rec, ref in zip(recs, refs):
        assert len(rec["scores"]) == len(ref["scores"]), where
        gap = np.abs(np.subtract(rec["scores"], ref["scores"])).max()
        assert gap <= SERVE_TIE_ATOL, (where, rec, ref)
        n_diff += rec["indices"] != ref["indices"]
    return n_diff


def cli_phase(card: str) -> dict:
    """Phase 8: the gallery CLI in this process, as a user runs it
    (``build_parser().parse_args([...])`` -> ``run``), with
    ``efficientnet_b3a`` at full width and 224 px; returns each fused
    kernel's launches over the four query paths."""
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    root = tempfile.mkdtemp(prefix="cli_phase_")
    try:
        t0 = time.perf_counter()
        gal, qry = write_cli_tree(root)
        log(f"CLI tree: {CLI_CLASSES} x {CLI_PER_CLASS} gallery PNGs of "
            f"{CLI_SRC} px and {CLI_QUERIES} query PNGs (half 300 x 200), "
            "rows cycling through the five filters: "
            f"{time.perf_counter() - t0:.1f} s to write")
        qpaths = sorted(os.path.join(qry, f) for f in os.listdir(qry))
        sample = qpaths + sorted(
            os.path.join(gal, "class_0", f)
            for f in os.listdir(os.path.join(gal, "class_0")))
        t0 = time.perf_counter()
        decoded = [decode_image(p) for p in sample]
        decode_ms = (time.perf_counter() - t0) * 1e3 / len(sample)
        assert all(d.shape[2] == 3 and d.dtype == np.uint8 for d in decoded)
        log(f"PNG decode (data.decode, numpy + zlib, one host thread): "
            f"{decode_ms:.2f} ms per image over {len(sample)} images "
            f"(256 x 256 and 300 x 200); {card}")

        npz = os.path.join(root, "gallery.npz")
        _, build_ms = cli_stdout(["build", npz, gal, "-mn",
                                  "efficientnet_b3a", "-is", str(SIZE),
                                  "-bs", "64", "--host_size", str(CLI_SRC)])
        n_items = CLI_CLASSES * CLI_PER_CLASS
        log(f"CLI build: {n_items} images in {build_ms:.0f} ms, "
            f"{n_items / build_ms * 1e3:.1f} images/s (decode, b3a embed at "
            f"bs 64, save); {card}")
        buf = io.StringIO()    # info prints one indented JSON document
        with contextlib.redirect_stdout(buf):
            CLI.run(CLI.build_parser().parse_args(["info", npz]))
        info = json.loads(buf.getvalue())
        assert info["items"] == n_items and info["dim"] == DIM
        assert info["classes"] == CLI_CLASSES
        assert info["meta"]["host_size"] == CLI_SRC
        log(f"CLI info: {json.dumps({k: info[k] for k in ('items', 'dim', 'classes')})}, "
            f"meta keys {sorted(info['meta'])}")

        launches, queried, library = {}, {}, None
        for mode, kernel in CLI_MODES.items():
            plain_before = dict(R.PLAIN_ON_CARD)
            R.reset_launch_counts()
            recs, ms = cli_stdout(["query", npz, qry, "-k", str(K),
                                   "--num_unique", "3", "--matmul_dtype",
                                   mode])
            counts = dict(R.KERNEL_LAUNCHES)
            assert len(recs) == CLI_QUERIES, (mode, len(recs))
            assert counts[kernel] == 1, (mode, counts)
            assert sum(counts.values()) == counts[kernel], (mode, counts)
            assert R.PLAIN_ON_CARD == plain_before, (mode, R.PLAIN_ON_CARD)
            launches[kernel] = launches.get(kernel, 0) + counts[kernel]
            library = library or library_path(npz, qpaths)
            for rec, ref, path in zip(recs, library(mode), qpaths):
                assert rec["query"] == path
                assert rec["indices"] == ref["indices"], (mode, path)
                assert rec["classes"] == ref["classes"], (mode, path)
                assert np.abs(np.subtract(rec["scores"],
                                          ref["scores"])).max() <= 1e-6
                assert len(rec["indices"]) == 3
            queried[mode] = recs
            log(f"CLI query {mode}: {CLI_QUERIES} JSON lines in {ms:.0f} ms "
                f"wall (model, artifact, decode, embed, k={K} ranking, "
                f"dedup, print); launches {counts}; records equal to the "
                f"library path's; {card}")

        args = CLI.build_parser().parse_args(["serve", npz, "--port", "0"])
        srv = CLI._make_server(args)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            url = f"http://127.0.0.1:{srv.server_address[1]}"
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                health = json.loads(r.read())
            assert health == {"ok": True, "items": n_items, "dim": DIM}
            bodies = [open(p, "rb").read() for p in qpaths[:CLI_POSTS]]

            def post(body):
                t = time.perf_counter()
                req = urllib.request.Request(url + "/search", data=body,
                                             method="POST")
                with urllib.request.urlopen(req, timeout=300) as r:
                    assert r.status == 200
                    out = json.loads(r.read())
                return out, (time.perf_counter() - t) * 1e3

            # serve's decode lock ablated between two warm rounds with it
            lock = CLI._DECODE_LOCK
            for rnd, held in (("cold", lock), ("warm", lock),
                              ("warm, decodes not locked",
                               contextlib.nullcontext()),
                              ("warm again", lock)):
                before = srv.batcher.dispatches
                CLI._DECODE_LOCK = held
                try:
                    with ThreadPoolExecutor(CLI_POSTS) as pool:
                        res = list(pool.map(post, bodies))
                finally:
                    CLI._DECODE_LOCK = lock
                dispatches = srv.batcher.dispatches - before
                assert dispatches < CLI_POSTS, dispatches
                lat = np.array([ms for _, ms in res])
                n_diff = near_tie_records(
                    [rec for rec, _ in res],
                    queried["float32"][:CLI_POSTS], f"serve {rnd}")
                log(f"CLI serve ({rnd}): {CLI_POSTS} parallel POST /search "
                    f"answered 200 in {dispatches} dispatches; per request "
                    f"p50 {np.percentile(lat, 50):.1f} ms, p95 "
                    f"{np.percentile(lat, 95):.1f} ms (host clock); "
                    f"{n_diff} of {CLI_POSTS} records differ from query's "
                    "(float32), all at near-ties: serve's micro-batches "
                    "take the dense path (true f32), query's Q=64 the "
                    f"kernel (3xTF32); {card}")
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=60)
        peak = torch.cuda.max_memory_allocated()
        log(f"CLI phase peak device memory: {peak / 1e9:.2f} GB allocated by "
            f"torch ({(peak - base) / 1e9:.2f} GB above what the earlier "
            f"phases hold); {card}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def main() -> None:
    card = torch.cuda.get_device_name(0)
    # 1. build
    log(f"card: {PF.card()}; {torch.cuda.device_count()} visible, this run "
        "drives card 0 only")
    t0 = time.perf_counter()
    # one nvcc per source, all started together (each waits in its thread)
    with ThreadPoolExecutor(len(_cuda.SOURCES)) as pool:
        outputs = dict(zip(_cuda.SOURCES,
                           pool.map(_cuda.build, _cuda.SOURCES)))
    log(f"build {', '.join(outputs)} (fused_topk: the tensor-core split "
        "kernel in f32 (3xTF32), bf16 and int8 + selection merge, the int8 "
        "query quantization, the f32, bf16 and int8 ladder rungs, the "
        "scores kernel (3xTF32); image_ops: histogram, LUT, row shifts; "
        "depthwise_conv: the band kernel (forward and dx), tap gradients + "
        "reduction; stream_probe: row sums + fold), one nvcc each in "
        f"parallel: {time.perf_counter() - t0:.1f} s")
    for name, out in outputs.items():
        for line in out.splitlines():
            if any(w in line for w in ("registers", "Compiling entry",
                                       "spill")):
                log(f"  {name}: {line.strip()}")
    log(codec_report())

    # 2. main path: model + gallery
    R.reset_launch_counts()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    model = create_model("efficientnet_b3a", seed=SEED)
    engine = RetrievalEngine(model,
                             transform=build_eval_transform("squarepad",
                                                            SIZE))
    index = GalleryIndex(DIM)
    embeds = []

    def embed_gallery():
        for _ in range(N_IMAGES // 64):
            embeds.append(engine.embed_batch(images(gen, 64)))
        return torch.cat(embeds)

    gal_emb, ms = sync_time(embed_gallery)
    assert gal_emb.shape == (N_IMAGES, DIM)
    assert torch.isfinite(gal_emb).all(), "non-finite embeddings"
    log(f"embed {N_IMAGES} images (b3a, {SIZE} px, f32): {ms:.1f} ms")
    rng = np.random.default_rng(SEED)
    classes = rng.integers(0, 1000, G_TOTAL).astype(np.int32)
    rows = torch.randn((G_TOTAL - N_IMAGES, DIM), generator=gen,
                       device=DEV)
    rows = R.l2_normalize(rows)
    index.add(gal_emb.cpu().numpy(), classes[:N_IMAGES])
    index.add(rows.cpu().numpy(), classes[N_IMAGES:])
    del rows
    assert len(index) == G_TOTAL

    # 3. requests, one path per serving mode: cold round (first calls at
    # each batch size), then a warm one
    def serve(mode: str, sizes) -> list:
        served = []
        for n in sizes * 2:
            batch = images(gen, n)
            before = dict(R.KERNEL_LAUNCHES)
            emb, embed_ms = sync_time(lambda: engine.embed_batch(batch))
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            (vals, inds, cls), query_ms = sync_time(
                lambda: index.query_class_dedup(emb, k=K, num_unique=3,
                                                matmul_dtype=mode,
                                                shortlist=SHORTLIST))
            peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
            ms = embed_ms + query_ms
            assert vals.shape == inds.shape == cls.shape == (n, 3)
            assert np.isfinite(vals).all() and (inds >= 0).all()
            np.testing.assert_array_equal(cls, index.classes[inds])
            assert (np.diff(vals, axis=1) <= 0).all(), "dedup order"
            if n < 32:    # below the fused threshold: the dense path
                assert R.KERNEL_LAUNCHES == before, (mode, n)
            served.append((emb, ms))
            log(f"{mode} request Q={n}: {ms:.1f} ms end to end = embed "
                f"{embed_ms:.1f} + k={K} top-k and class dedup "
                f"{query_ms:.1f}"
                f"{' (includes the gallery upload)' if len(served) == 1 else ''}"
                f"{'; cold' if len(served) <= len(sizes) else '; warm'}; "
                f"query peak {peak_mb:.1f} MB above what was allocated")
        return served

    launches, paths = {}, {}
    for mode, sizes, kernel in (
            ("float32", (64, 64, 8), "fused_cosine_topk"),
            ("bfloat16", (64, 8), "fused_cosine_topk_bf16"),
            ("int8", (64, 8), "fused_cosine_topk_int8"),
            ("int8_rerank", (64, 8), "fused_cosine_topk_int8")):
        R.reset_launch_counts()
        paths[mode] = serve(mode, sizes)
        counts = dict(R.KERNEL_LAUNCHES)
        log(f"{mode} path launches: {counts}")
        # each Q=64 request launches the mode's kernel once, Q=8 never
        assert counts[kernel] == 2 * sizes.count(64), (mode, counts)
        assert sum(counts.values()) == counts[kernel], (mode, counts)
        launches[kernel] = launches.get(kernel, 0) + counts[kernel]
        form = index._gallery_on_device(mode)
        log(f"{mode} resident gallery: "
            f"{sum(t.numel() * t.element_size() for t in form) / 1e6:.1f}"
            f" MB ({', '.join(f'{t.dtype} {tuple(t.shape)}' for t in form)})")
    for name, n in launches.items():
        assert n > 0, f"kernel {name} never ran on the main path"

    # device time of one warm Q=64 request per mode, by kernel
    for mode in paths:
        batch = images(gen, 64)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            _, wall_ms = sync_time(lambda: index.query_class_dedup(
                engine.embed_batch(batch), k=K, num_unique=3,
                matmul_dtype=mode))
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        log(f"profiled {mode} Q=64 request: {wall_ms:.1f} ms wall, "
            f"{busy_ms:.1f} ms device busy; top kernels by device time, "
            "and the fused top-k kernels:")
        events.sort(key=lambda e: -e.self_device_time_total)
        for e in events[:6] + [e for e in events[6:] if "fused_topk" in e.key]:
            log(f"  {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} "
                f"{e.key[:90]}")

    # the served ranking against the dense path on the card
    gal, norms = index._gallery_on_device()
    q64 = paths["float32"][1][0]
    fv, fi = R.cosine_topk(q64, gal, K, gallery_norms=norms)
    dv, di = R.cosine_topk(q64, gal, K, gallery_norms=norms, method="dense")
    # random weights map every image near one direction, so the served
    # top-k is dense with near-ties: positions may swap, values may not
    mism = (fi != di).float().mean().item()
    assert (fv - dv).abs().max().item() <= 1e-5
    log(f"fused vs dense on the served gallery: {mism:.5f} of positions "
        "differ, all at near-ties (values agree within 1e-5)")

    # 4. kernels against their plain versions, at the main path's shapes
    q_hat = R.l2_normalize(q64)
    splits = R.fused_splits(64, G_TOTAL, K, DEV)
    log(f"kernel geometry: bins={R.FUSED_BINS}, t_depth={R.FUSED_T_DEPTH}, "
        f"splits={splits}")

    def compare(mode, qh, g, kw, k=K):
        R.reset_launch_counts()   # comparison launches are not counted
        kv, ki, kok = R.fused_cosine_topk(qh, g, k, **kw)
        rv, ri, rok = R.fused_cosine_topk_reference(
            qh, g, k, matmul_dtype=mode,
            splits=R.fused_splits(qh.shape[0], g.shape[0], k, DEV), **kw)
        torch.cuda.synchronize()
        return kv, ki, kok, rv, ri, rok

    # ±1 data, with one query planted in 8 rows of bin 0 of split 0 (tiles
    # are dealt round-robin to the splits) so its certificate must fail
    pq = pm1_rows(gen, 64, DIM)
    pg = pm1_rows(gen, G_TOTAL, DIM)
    for j in range(R.FUSED_T_DEPTH + 2):
        pg[j * splits * R.FUSED_BINS] = pq[0]
    pqh = R.l2_normalize(pq)
    pn = torch.linalg.vector_norm(pg, dim=1)
    for mode in KERNELS:
        g_in, kw = kernel_args(mode, (pg, pn) if mode == "float32"
                               else R._prepare_gallery(pg, mode))
        kv, ki, kok, rv, ri, rok = compare(mode, pqh, g_in, kw)
        assert torch.equal(kv, rv) and torch.equal(ki, ri) and torch.equal(
            kok, rok), f"{mode} kernel != plain version on ±1 data"
        assert kok[0].item() == 0 and kok.any(), (mode, kok)
        wv, wi = R.cosine_topk(pq, g_in, K, matmul_dtype=mode, **kw)
        ev, ei = R.cosine_topk(pq, g_in, K, matmul_dtype=mode,
                               method="dense", **kw)
        assert torch.equal(wi, ei) and torch.equal(wv, ev), (mode, "repair")
        log(f"{mode} kernel, ±1 data: vals/inds/ok bitwise equal to the "
            "plain version; the planted bin overflow fails its certificate "
            "and cosine_topk repairs it exactly")
    del pq, pg, pqh, pn, g_in

    # the float gallery in each mode's resident form: the served queries
    # (random weights put them near one direction, so their top-k is dense
    # with near-ties) and seeded unit rows, whose top-k gaps are far wider.
    # int8 runs twice: at k=150 over the int8 form, and at the shortlist
    # c=256 (its own split count) over the int8_rerank form, as stage 1 of
    # the int8_rerank path runs it
    def resident(mode):
        return kernel_args(mode, index._gallery_on_device(mode))

    unit_q = R.l2_normalize(torch.randn((64, DIM), generator=gen,
                                        device=DEV))
    errs = {}
    for mode, form, k in (("float32", "float32", K),
                          ("bfloat16", "bfloat16", K), ("int8", "int8", K),
                          ("int8", "int8_rerank", SHORTLIST)):
        g_in, kw = resident(form)
        errs.setdefault(mode, 0.0)
        for what, qh in (("served queries", q_hat),
                         ("seeded unit rows", unit_q)):
            kv, ki, kok, rv, ri, rok = compare(mode, qh, g_in, kw, k)
            e = (kv - rv).abs().max().item()
            errs[mode] = max(errs[mode], e)
            n_ok, n_rok = int(kok.sum()), int(rok.sum())
            assert torch.equal(kok, rok), (mode, form, k, what, n_ok, n_rok)
            if mode == "int8":    # exact int32 dot, the same rescale
                assert torch.equal(kv, rv) and torch.equal(ki, ri), (
                    form, k, what)
                log(f"int8 kernel, float gallery ({form} form), k={k}, "
                    f"{R.fused_splits(64, G_TOTAL, k, DEV)} splits, {what}: "
                    f"vals/inds/ok bitwise equal to the plain version; "
                    f"{n_ok} rows certified")
                continue
            assert e <= 1e-5, (mode, what, e)
            if mode == "float32" and what == "seeded unit rows":
                # kernel 1's 3xTF32 values against f64 at the indices each
                # returns, within 1e-6; the plain version's true f32 beside
                g64 = g_in.double()
                g64 = g64 / torch.clamp(
                    kw["gallery_norms"].double().reshape(-1, 1),
                    min=R.COSINE_SIM_EPS)
                exact = qh.double() @ g64.t()
                k_err = (kv.double() - torch.gather(
                    exact, 1, ki.long())).abs().max().item()
                p_err = (rv.double() - torch.gather(
                    exact, 1, ri.long())).abs().max().item()
                log(f"float32 kernel against f64 ({what}, served gallery): "
                    f"max |kernel vals - f64| {k_err:.3g} (limit 1e-6), max "
                    f"|plain vals - f64| {p_err:.3g}")
                assert k_err <= 1e-6, k_err
                del g64, exact
            n_diff = near_tie_rows(ki, ri, R.dense_scores(qh, g_in, mode),
                                   rv[:, K - 1:K], (mode, what))
            log(f"{mode} kernel, float gallery, {what}: max |vals - plain| "
                f"= {e:.3g}; {n_diff} of {kv.shape[0]} rows have index sets "
                "that differ, only at near-ties of the k-th value; "
                f"{n_ok} rows certified by the kernel and its plain version "
                "alike")
            if mode == "bfloat16":
                log(f"bf16 certificate pass rate, {what}: {n_ok} of "
                    f"{kv.shape[0]} rows with ok = 1; the contract's (the "
                    f"plain version's, which every design of the kernel is "
                    f"held to): {n_rok} of {kv.shape[0]}")
        del g_in, kw

    # fidelity of each serving mode against f32 exact, unit-row queries
    uq = unit_q.cpu().numpy()
    fv, fi, _ = index.query(uq, k=K)
    g_hat = R._normalized_gallery(gal, norms)
    f32_scores = torch.matmul(unit_q, g_hat.t())
    for mode in ("bfloat16", "int8", "int8_rerank"):
        mv, mi, _ = index.query(uq, k=K, matmul_dtype=mode)
        top1 = float((mi[:, 0] == fi[:, 0]).mean())
        overlap = float(np.mean([len(set(a) & set(b)) / K
                                 for a, b in zip(mi, fi)]))
        verr = float(np.abs(mv - fv).max())
        log(f"fidelity {mode} vs f32 exact, 64 unit-row queries: top-1 "
            f"agreement {top1:.4f}, top-{K} overlap {overlap:.5f}, max "
            f"|vals - f32| {verr:.3g}")
        if mode == "int8_rerank":
            assert verr <= 5e-5, verr
            for r in range(len(mi)):
                diff = sorted(set(mi[r]) ^ set(fi[r]))
                if diff:
                    gap = (f32_scores[r, torch.tensor(diff, device=DEV)]
                           - float(fv[r, K - 1])).abs().max().item()
                    assert gap <= 5e-5, (r, gap)

    # timings at the main path's shapes
    peaks = PEAKS["pcie" if "PCIe" in card else "sxm"]
    q = q_hat.shape[0]
    q16 = q_hat.to(torch.bfloat16)
    qq, qs = R.quantize_rows_int8(q_hat)
    kernels = []
    for mode, (name, replaces) in KERNELS.items():
        g_in, kw = resident(mode)
        call = (lambda: R.fused_cosine_topk(q_hat, g_in, K, **kw))
        ms, b_ms = event_ms(call, reps=20), PF.pipelined_ms(call)
        plain_ms = event_ms(lambda: R.fused_cosine_topk_reference(
            q_hat, g_in, K, matmul_dtype=mode, splits=splits, **kw),
            reps=5, warmup=1)
        if mode == "float32":
            library = "torch.topk(torch.matmul(q̂, ĝᵀ), 150), f32"
            lib_call = (lambda: torch.topk(torch.matmul(q_hat, g_hat.t()),
                                           K))
            g_bytes = 4 * (G_TOTAL * DIM + G_TOTAL)
        elif mode == "bfloat16":
            library = ("torch.topk(torch.matmul(q̂16, ĝ16ᵀ).float(), 150); "
                       "cuBLAS rounds its output to bf16")
            lib_call = (lambda: torch.topk(
                torch.matmul(q16, g_in.t()).float(), K))
            g_bytes = 2 * G_TOTAL * DIM
        else:
            library = ("torch._int_mm(q8, g8ᵀ) -> rescale -> torch.topk, "
                       "int8 tensor cores")
            gs = kw["gallery_scale"]
            lib_call = (lambda: torch.topk(
                torch._int_mm(qq, g_in.t()).float()
                * (qs * gs.reshape(1, -1)), K))
            g_bytes = G_TOTAL * DIM + 4 * G_TOTAL
        library_ms = event_ms(lib_call, reps=20)
        lib_b_ms = PF.pipelined_ms(lib_call)
        nbytes = 4 * q * DIM + g_bytes + 8 * q * K + 4 * q
        ops = 2 * q * G_TOTAL * DIM
        bound_bytes = nbytes / peaks["bytes"] * 1e3
        if mode == "float32":   # 3xTF32, and the f32-FMA bound beside it
            bounds = f32_bounds(nbytes, ops, peaks)
            bound_ops = TF32_PASSES * ops / peaks["tf32"] * 1e3
        else:
            bound_ops = ops / peaks[mode] * 1e3
            bounds = {"bound_ms": max(bound_bytes, bound_ops),
                      "bound_by": "operations" if bound_ops >= bound_bytes
                      else "bytes"}
        log(f"{name} Q={q} G={G_TOTAL} D={DIM} k={K}: {ms:.3f} ms "
            f"(bound {bounds['bound_ms']:.3f} ms: bytes {bound_bytes:.3f}, "
            f"operations {bound_ops:.3f}"
            + (f"; f32-FMA bound {bounds['f32_fma_bound_ms']:.3f}"
               if mode == "float32" else "")
            + f"); plain {plain_ms:.3f} ms; library "
            f"{library_ms:.3f} ms ({library}); back-to-back: kernel "
            f"{b_ms:.3f} ms, library {lib_b_ms:.3f} ms")
        if mode == "float32":
            # the library at one TF32 pass: lower precision, not the
            # yardstick; logged only
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32_ms = event_ms(lib_call, reps=20)
                tf32_b_ms = PF.pipelined_ms(lib_call)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            log(f"  library at single-pass TF32 (allow_tf32=True, LOWER "
                f"precision than the kernel's 3xTF32; not the yardstick): "
                f"{tf32_ms:.3f} ms single call, {tf32_b_ms:.3f} "
                "back-to-back")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "imageretrievalresearch_tpu_torch/csrc/fused_topk.cu",
            "replaces": f"imageretrievalresearch_tpu/{replaces}",
            "launches": launches[name],
            "max_abs_err": errs[mode],
            "ms": ms,
            "plain_ms": plain_ms,
            **bounds,
            "library_ms": library_ms,
            "ms_by": "single call",
            "burst_ms": b_ms,
            "library_burst_ms": lib_b_ms,
        })
        del g_in, kw

    # kernel 3's query quantization (its first launch) against its plain
    # version, bitwise, on the served queries and the unit rows
    for qh in (q_hat, unit_q):
        got, want = R.quantize_queries_int8(qh), R.quantize_rows_int8(qh)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    log("int8 query quantization kernel: codes and scales bitwise equal to "
        "quantize_rows_int8 on the served queries and the unit rows")

    # the library yardstick from q̂, as the kernels start: the cast or the
    # quantization inside the timed call
    g16 = resident("bfloat16")[0]
    g8, kw8 = resident("int8")
    gs8 = kw8["gallery_scale"]

    def lib_int8_from_qhat():
        qq8, qs8 = R.quantize_rows_int8(q_hat)
        return torch.topk(torch._int_mm(qq8, g8.t()).float()
                          * (qs8 * gs8.reshape(1, -1)), K)

    for mode, lib_call in (
            ("bfloat16", lambda: torch.topk(torch.matmul(
                q_hat.to(torch.bfloat16), g16.t()).float(), K)),
            ("int8", lib_int8_from_qhat)):
        log(f"library from q̂ ({mode}; cast or quantize_rows_int8 inside the "
            f"timed call): {event_ms(lib_call, reps=20):.3f} ms single call, "
            f"{PF.pipelined_ms(lib_call):.3f} ms back-to-back")
    # the host's time in the wrappers of kernels 2 and 3, step by step
    for mode, (g_in, kw) in (("bfloat16", (g16, {})), ("int8", (g8, kw8))):
        att = host_dispatch(mode, q_hat, g_in, kw)
        log(f"host dispatch, {mode} fused top-k at Q=64 (µs per call, host "
            "clock): " + "; ".join(f"{n} {t:.1f}"
                                   for n, t in att["now"].items()))
        log("  steps the earlier wrapper ran in their place (µs): "
            + "; ".join(f"{n} {t:.1f}"
                        for n, t in att["earlier_steps"].items()))
    del g16, g8, kw8, gs8

    kernels += augment_phase(model, gen, peaks)
    kernels += training_phase(model, gen, peaks)
    kernels += inference_phase(model, index, paths, gen, peaks)
    # the CLI's launches of kernels 1-3 (each query path's counts set to 0
    # just before it and read just after), beside the main path's
    cli = cli_phase(PF.card())
    for row in kernels:
        if row["name"] in cli:
            row["cli_launches"] = cli[row["name"]]

    # 9. result: the one card this run drove
    print(json.dumps({"kernels": kernels}))
    print(PF.card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": 1}}), flush=True)


if __name__ == "__main__":
    main()
