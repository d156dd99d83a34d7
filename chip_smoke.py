"""Smoke run of the PyTorch/CUDA port on one GPU: build, serve, verify, time.

    python3 chip_smoke.py

Phases (any failure exits non-zero, with no result line):

1. Build the port's CUDA kernels (``csrc/fused_topk.cu``,
   ``csrc/image_ops.cu``, ``csrc/depthwise_conv.cu`` and
   ``csrc/stream_probe.cu``, one nvcc process each, started together) and
   print the card's name and power limit.
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
   bitwise for int8 at k=150 and at int8_rerank's shortlist c=256.
   Fidelity of each mode against f32 exact on the unit-row queries.
   Kernel, plain and library times (CUDA events) and each kernel's bound.
5. AutoAugment training input: a seeded triplet batch (qry, one pos, one
   neg; 64 x 256 x 256 x 3 uint8 each) through
   ``build_triplet_transform`` with three ``train_autoaugment(224)``
   specs and a seeded generator, launch counts set to 0 just before and
   read just after (histogram 6, LUT 9, cubic row shift 3, row shift 18,
   worked out from ``_STAGE_OPS``; no plain version on the card), the
   augmented queries through the b3a embed. The transform equals its
   pieces, and the card's policy the CPU table's on every image no rotate
   touched; the 3-shear rotate's agreement with the exact gather rotate.
   Each image kernel against its plain version, bitwise, at the path's
   shapes and at ragged ones; kernel, plain and library times and bounds;
   the transform's time, and its device time by kernel.
6. T3 training with the depthwise kernels (IRT_FORCE_PALLAS_DW=1).
   Kernels 9 and 10 against their plain versions at the 26 depthwise
   layer shapes of b3a at 224 px (N = 8) and at ragged ones, in f32 and
   bf16: the forward and dx bitwise, the tap gradients within 1e-6 of the
   sum of absolute products (another summation order); then their
   kernel, plain and library (cuDNN) times per pass at N = 192, summed
   over the 26 layers, beside the bound, each kernel held against its
   plain version there as well. Then ``Trainer.fit(max_epochs=1)``
   of ``make_config("train_efficient_cos_con_ce_loss", batch_size=64)``
   on ``efficientnet_b3a`` (125 classes, seeded weights) over in-memory
   loaders (3 train batches, 1 val batch of seeded 256 px uint8
   triplets), first with the opt-in, counts set to 0 just before and read
   just after (kernel 9: 52 per train step and 26 per val batch, kernel
   10: 26 per train step, kernels 5-8 at phase 5's counts per step, no
   plain version on the card, no layout copy), then from the same weights
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
   shape; its kernel, plain and library (cuBLAS + normalize) times. The
   ladder's rungs (kernel 11, f32 and bf16) against their plain versions,
   then ``tools.profile_fused_kernel.run_ladder`` at Q = 64 with the
   attribution by differences and one burst under ``utils.profiling.
   trace``; the stream probe (kernel 12) against its plain version and its
   read rate at four block heights, beside a torch read+write pass.
8. One JSON line of kernels, the nvidia-smi line, and the result line.

Imports nothing of JAX. Needs one CUDA card.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device; nothing was run")

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
from imageretrievalresearch_tpu_torch.train import (  # noqa: E402
    Trainer,
    build_train_step,
)
from imageretrievalresearch_tpu_torch.utils.profiling import trace  # noqa: E402

SEED = 0
G_TOTAL, N_IMAGES, DIM, K, SIZE = 100_000, 512, 1536, 150, 224
SHORTLIST = 256   # int8_rerank's stage-1 depth on the main path
DEV = torch.device("cuda")
# published dense peaks of the H100 (NVIDIA data sheets), at full power:
# memory bytes/s, and operations/s per score arithmetic (f32 without
# tensor cores; bf16 and int8 on tensor cores)
PEAKS = {"sxm": {"bytes": 3.35e12, "float32": 67e12, "bfloat16": 989e12,
                 "int8": 1979e12},
         "pcie": {"bytes": 2.0e12, "float32": 51e12, "bfloat16": 756e12,
                  "int8": 1513e12}}
# the TPU kernel each CUDA kernel replaces (imageretrievalresearch_tpu)
KERNELS = {"float32": ("fused_cosine_topk", "ops/retrieval.py:259"),
           "bfloat16": ("fused_cosine_topk_bf16", "ops/retrieval.py:288"),
           "int8": ("fused_cosine_topk_int8", "ops/retrieval.py:313")}
IMAGE_KERNELS = {"plane_histogram": "ops/pallas_image.py:28",
                 "lut_apply": "ops/pallas_image.py:233",
                 "row_shift_cubic": "ops/pallas_image.py:150",
                 "row_shift": "ops/pallas_image.py:76"}
# the AutoAugment phase: a triplet batch of three roles, each 64 seeded
# 256 px uint8 images, resized to SIZE
AUG_BATCH, AUG_SRC, AUG_ROLES = 64, 256, 3
# the TPU kernels' static shift bounds at SIZE (JAX's batched_shear_x and
# batched_rotate): shear int(0.3 * H) + 1, rotate passes
# int(tan(15°) * H/2) + 1 and int(sin(30°) * W/2) + 1
SMAX_SHEAR = int(0.3 * SIZE) + 1
SMAX_ROTATE = (int(np.tan(np.deg2rad(30.0) / 2.0) * (SIZE / 2.0)) + 1,
               int(np.sin(np.deg2rad(30.0)) * (SIZE / 2.0)) + 1)
# f32 operations per output pixel of the cubic row shift: 4 taps x (the
# weight polynomial 6, the weighted sum 2, the weight sum 1) + the division
CUBIC_OPS_PER_PIXEL = 37
# the training phase: T3 on b3a with Sketchy's 125 categories, batches of
# 64 seeded 256 px triplets; kernels 9 and 10 compared at N = 8 and timed
# at N = 192 (one train step's depthwise batch)
DW_KERNELS = {"depthwise_conv_forward": "ops/pallas_conv.py:181",
              "depthwise_conv_grad_w": "ops/pallas_conv.py:189"}
DW_SOURCE = "imageretrievalresearch_tpu_torch/csrc/depthwise_conv.cu"
N_CLASSES, TRAIN_BATCH, TRAIN_SRC, TRAIN_STEPS = 125, 64, 256, 3
DW_COMPARE_N, DW_TIME_N = 8, 3 * TRAIN_BATCH
# (C, H, W, K, stride) beyond b3a's layers: odd H and W at stride 2, C not
# a multiple of 32, K = 7
DW_RAGGED = [(144, 13, 9, 5, 2), (40, 15, 15, 7, 2), (200, 9, 9, 7, 1),
             (24, 57, 43, 3, 2)]
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


def log(msg: str) -> None:
    print(msg, flush=True)


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def event_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of ``reps`` single-call CUDA-event times, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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


def bound(nbytes: float, ops: float, peaks: dict) -> tuple[float, str]:
    """The least time (ms) for the work: bytes over the memory rate or f32
    operations over the f32 rate (CUDA cores), whichever is larger."""
    t_bytes = nbytes / peaks["bytes"] * 1e3
    t_ops = ops / peaks["float32"] * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops > t_bytes
                                 else "bytes")


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
    plain = dict(IK.PLAIN_ON_CARD)
    log(f"AutoAugment triplet transform (3 x {AUG_BATCH} x {AUG_SRC} px -> "
        f"{SIZE}, first call): {ms:.1f} ms; launches {launches}")
    assert launches == {k: AUG_ROLES * n for k, n in per_call.items()}, (
        launches)
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
    ragged_rows = u8(1, 4097, 223)[0, ..., 0].contiguous()
    lut = A._equalize_lut(IK.plane_histogram_reference(planes))

    def src0(m, smax):
        return (torch.rand(m, generator=gen, device=DEV) * 2 - 1) * smax

    def shifts(m, smax):
        return torch.randint(-smax, smax + 1, (m,), generator=gen,
                             device=DEV, dtype=torch.int32)

    errs = {}
    for name, args in (
            ("plane_histogram", [(planes,), (ragged,)]),
            ("lut_apply", [(planes, lut), (ragged, A._equalize_lut(
                IK.plane_histogram_reference(ragged)))]),
            ("row_shift_cubic", [(rows, src0(n, SMAX_SHEAR)),
                                 (ragged_rows, src0(4097, SMAX_SHEAR))]),
            ("row_shift", [(rows, shifts(n, SMAX_ROTATE[0])),
                           (rows, shifts(n, SMAX_ROTATE[1])),
                           (ragged_rows, shifts(4097, SMAX_ROTATE[1]))])):
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
    p, h, w = planes.shape
    src_shear, s_rot = src0(n, SMAX_SHEAR), shifts(n, SMAX_ROTATE[1])
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
    }
    entries = []
    for name, (a, nbytes, ops, library, library_name) in timed.items():
        kernel = getattr(IK, name)
        reference = getattr(IK, f"{name}_reference")
        ms = event_ms(lambda: kernel(*a), reps=50)
        plain_ms = event_ms(lambda: reference(*a), reps=10)
        library_ms = event_ms(library, reps=50) if library else None
        bound_ms, bound_by = bound(nbytes, ops, peaks)
        log(f"{name} at {tuple(a[0].shape)}: {ms:.4f} ms (bound "
            f"{bound_ms:.4f} ms, {bound_by}); plain {plain_ms:.4f} ms; "
            + (f"library {library_ms:.4f} ms ({library_name})" if library
               else "library: none (no single PyTorch call computes it)"))
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "imageretrievalresearch_tpu_torch/csrc/image_ops.cu",
            "replaces": f"imageretrievalresearch_tpu/{IMAGE_KERNELS[name]}",
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
        })

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
            "row_shift_cubic_kernel")
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


def dw_plain_grad_x(g, taps, s, h, w):
    return DW.depthwise_forward_reference(DW.dilate(g, s, h, w),
                                          taps.flip(0, 1), 1)


def dw_passes(x, g, taps, shape) -> dict:
    """pass -> (kernel, plain version), callables on one layer's operands."""
    c, h, w, k, s = shape
    return {"forward": (lambda: DW.depthwise_forward(x, taps, s),
                        lambda: DW.depthwise_forward_reference(x, taps, s)),
            "dx": (lambda: DW.depthwise_grad_x(g, taps, s, h, w),
                   lambda: dw_plain_grad_x(g, taps, s, h, w)),
            "dw": (lambda: DW.depthwise_grad_w(x, g, k, s),
                   lambda: DW.depthwise_grad_w_reference(x, g, k, s))}


def dw_check(shape, x, g, passes: dict) -> tuple[float, float]:
    """Each pass's kernel against its plain version, once: the forward and
    dx bitwise, the tap gradients within DW_GRAD_W_RTOL of the sum of
    |x| |g| over each tap's terms. Returns the tap gradients' largest
    |kernel - plain| and its largest share of that sum."""
    got = {p: kern() for p, (kern, _) in passes.items()}
    want = {p: plain() for p, (_, plain) in passes.items()}
    torch.cuda.synchronize()
    where = (x.dtype, x.shape[0], shape)
    for p in ("forward", "dx"):
        assert torch.equal(got[p], want[p]), (p, *where)
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
        f"gradients: max |kernel - plain| {err:.3g}, at most {rel:.3g} of "
        f"the sum of |x| |g| (limit {DW_GRAD_W_RTOL})")
    return err, rel


def dw_times(shapes, gen, peaks: dict) -> tuple[dict, float, float]:
    """Per pass (forward, dx, dw) at N = DW_TIME_N in bf16, summed over
    ``shapes``: kernel, plain and library (cuDNN) ms, and the bound; each
    kernel is also held against its plain version on the same operands
    (``dw_check``), whose largest tap-gradient error and share come back
    with the times."""
    conv_bwd = torch.ops.aten.convolution_backward
    tot = {p: dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                             "bytes_ms", "ops_ms"), 0.0)
           for p in ("forward", "dx", "dw")}
    n = DW_TIME_N
    err = rel = 0.0
    log(f"depthwise passes at N = {n}, bf16, per layer (C, H, K, stride): "
        "kernel / cuDNN ms for forward, dx, dw")
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
            t["ms"] += ms
            t["library_ms"] += lib_ms
            t["plain_ms"] += event_ms(plain, reps=2, warmup=1)
            t["bytes_ms"] += nbytes / peaks["bytes"] * 1e3
            t["ops_ms"] += ops / peaks["float32"] * 1e3
            t["bound_ms"] += bound(nbytes, ops, peaks)[0]
            row.append(f"{ms:.3f} / {lib_ms:.3f}")
        e, r = dw_check(shape, x, g, passes)
        err, rel = max(err, e), max(rel, r)
        log(f"  ({c}, {h}, {k}, {s}): " + "; ".join(row))
        del x, g, wt, xc, gc, passes, library
    log(f"depthwise kernels vs plain versions at N = {n}, bf16, "
        f"{len(shapes)} layers: forward and dx bitwise equal; tap "
        f"gradients: max |kernel - plain| {err:.3g}, at most {rel:.3g} of "
        f"the sum of |x| |g| (limit {DW_GRAD_W_RTOL})")
    for name, t in tot.items():
        log(f"depthwise {name} over {len(shapes)} layers at N = {n}, bf16: "
            f"kernel {t['ms']:.3f} ms, bound {t['bound_ms']:.3f} ms (bytes "
            f"{t['bytes_ms']:.3f}, operations {t['ops_ms']:.3f}), plain "
            f"{t['plain_ms']:.3f} ms, cuDNN {t['library_ms']:.3f} ms")
    return tot, err, rel


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
    return {"wall": wall, "events": ev, "peak": peak, "idle": 1 - busy / pwall}


def training_phase(serving_model, gen, peaks: dict) -> list:
    """Phase 6: kernels 9 and 10 against their plain versions and timed,
    then the T3 training path with them and on cuDNN; returns their
    entries of the ``kernels`` line."""
    shapes = dw_layer_shapes(serving_model)
    assert len(shapes) == 26, shapes
    err_small, _ = dw_compare(shapes + DW_RAGGED, gen)
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
        "depthwise_conv_forward": 52 * TRAIN_STEPS + 26,
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
    for name, passes in (("depthwise_conv_forward", ("forward", "dx")),
                         ("depthwise_conv_grad_w", ("dw",))):
        def total(key):
            return sum(tot[p][key] for p in passes)
        entries.append({
            "name": name,
            "route": "cuda",
            "source": DW_SOURCE,
            "replaces": f"imageretrievalresearch_tpu/{DW_KERNELS[name]}",
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": total("ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": ("bytes" if total("bytes_ms") >= total("ops_ms")
                         else "operations"),
            "library_ms": total("library_ms"),
        })
    return entries


def scores_bound(q: int, g: int, d: int, peaks: dict) -> tuple[float, str]:
    """Kernel 4's bound, by JAX's cost estimate: bytes (Q·D + G·D + Q·G)·4
    against 2·Q·G·D f32 operations."""
    return bound(4 * (q * d + g * d + q * g), 2 * q * g * d, peaks)


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
    entries = []
    for q in (64, 512):
        qh = R.l2_normalize(paths["float32"][0][0]) if q == 64 else \
            R.l2_normalize(torch.randn((q, DIM), generator=gen, device=DEV))
        ms = event_ms(lambda: R.fused_cosine_scores(qh, gal), reps=20)
        plain_ms = event_ms(lambda: R.cosine_scores_reference(qh, gal),
                            reps=10)
        library_ms = event_ms(lambda: torch.matmul(
            qh, R.l2_normalize(gal).t()), reps=10)
        bound_ms, bound_by = scores_bound(q, G_TOTAL, DIM, peaks)
        log(f"fused_cosine_scores Q={q} G={G_TOTAL} D={DIM}: {ms:.3f} ms "
            f"(bound {bound_ms:.3f} ms, {bound_by}); plain {plain_ms:.3f} "
            f"ms; library {library_ms:.3f} ms (torch.matmul(q̂, "
            "l2_normalize(g)ᵀ), f32, TF32 off)")
        if q == 64:
            entries.append({
                "name": "fused_cosine_scores", "route": "cuda",
                "source": "imageretrievalresearch_tpu_torch/csrc/"
                          "fused_topk.cu",
                "replaces": "imageretrievalresearch_tpu/ops/retrieval.py:109",
                "launches": launches["fused_cosine_scores"],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms})

    # 7.4 kernel 11, the ladder: each rung against its plain version on ±1
    # data (every word, sum and score exact: bitwise) and stream_only on
    # the float gallery within its stated bound; then the tool's ladder at
    # Q = 64 over the resident f32 and bf16 galleries, counts set to 0
    # just before and read just after
    q_hat = R.l2_normalize(paths["float32"][0][0])
    pq, pg = R.l2_normalize(pm1_rows(gen, 64, DIM)), pm1_rows(gen, G_TOTAL,
                                                              DIM)
    variants = PF.build_variants()
    forms = {"float32": (gal, norms),
             "bfloat16": (index._gallery_on_device("bfloat16")[0], None)}
    errs = {}
    splits = R.fused_splits(64, G_TOTAL, K, DEV)
    for mode in forms:
        g_pm1 = pg if mode == "float32" else R._prepare_gallery(pg, mode)[0]
        for rung in PF.RUNGS:
            got = variants[rung].kernel(pq, g_pm1, K)
            want = variants[rung].plain(pq, g_pm1, K, splits=splits)
            torch.cuda.synchronize()
            for a, b in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                assert torch.equal(a, b), (mode, rung)
            errs[(mode, rung)] = 0.0
        g_in, n_in = forms[mode]
        got = variants["stream_only"].kernel(q_hat, g_in, K,
                                             gallery_norms=n_in)
        want = variants["stream_only"].plain(q_hat, g_in, K,
                                             gallery_norms=n_in,
                                             splits=splits)
        scale = variants["stream_only"].plain(
            q_hat.abs(), g_in.abs(), K, gallery_norms=n_in, splits=splits)
        err = (got - want).abs()
        rtol = PF.stream_only_rtol(G_TOTAL, DIM, splits)
        assert (err <= rtol * scale).all(), (mode, (err / scale).max())
        errs[(mode, "stream_only")] = err.max().item()
        log(f"ladder ({mode}): stream_only, matmul_only, insert_only "
            f"bitwise equal to their plain versions on ±1 data; stream_only "
            f"on the served gallery within {(err / scale).max().item():.3g} "
            f"of the sum of |words| (limit {rtol:.3g})")
    del pq, pg, g_pm1

    PF.reset_launch_counts()
    R.reset_launch_counts()
    ladder = {mode: PF.run_ladder(q_hat, g_in, K, gallery_norms=n_in)
              for mode, (g_in, n_in) in forms.items()}
    ladder_launches = dict(PF.KERNEL_LAUNCHES)
    assert not any(R.PLAIN_ON_CARD.values())
    for mode, times in ladder.items():
        tag = "f32" if mode == "float32" else "bf16"
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
                 and "fused_topk_split_kernel" in e.key]
        assert len(os.listdir(d)) == 1 and len(names) == 4, names
    log(f"utils.profiling.trace of one ladder burst: the four split-kernel "
        f"phases on the device: {names}")
    for mode, (g_in, n_in) in forms.items():
        tag = "f32" if mode == "float32" else "bf16"
        g_bytes = g_in.numel() * g_in.element_size() + (
            0 if n_in is None else 4 * G_TOTAL)
        for rung in PF.RUNGS:
            plain_ms = event_ms(lambda: variants[rung].plain(
                q_hat, g_in, K, gallery_norms=n_in, splits=splits), reps=3,
                warmup=1)
            out_bytes = 4 * 64 * splits * (2 * K if rung == "insert_only"
                                           else 1)
            nbytes = 4 * 64 * DIM + g_bytes + out_bytes
            t_bytes = nbytes / peaks["bytes"] * 1e3
            t_ops = (0.0 if rung == "stream_only"
                     else 2 * 64 * G_TOTAL * DIM / peaks[mode] * 1e3)
            entries.append({
                "name": f"fused_topk_{tag}_{rung}", "route": "cuda",
                "source": "imageretrievalresearch_tpu_torch/csrc/"
                          "fused_topk.cu",
                "replaces": f"tools/profile_fused_kernel.py:{LADDER[rung]}",
                "launches": ladder_launches[f"fused_topk_{tag}_{rung}"],
                "max_abs_err": errs[(mode, rung)],
                "ms": ladder[mode][rung], "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "operations" if t_ops > t_bytes else "bytes",
                "library_ms": None})

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
    log(f"stream probe row: rows={rows}; plain = library = one torch call "
        f"x.reshape(-1, rows, D).sum((0, 2)): {sum_ms:.4f} ms")
    bound_ms, bound_by = bound(x_bytes + 4 * rows, x.numel(), peaks)
    entries.append({
        "name": "stream_probe", "route": "cuda",
        "source": "imageretrievalresearch_tpu_torch/csrc/stream_probe.cu",
        "replaces": "tools/profile_fused_kernel.py:212",
        "launches": probe_launches, "max_abs_err": perr,
        "ms": probes[rows], "plain_ms": sum_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": sum_ms})
    del x
    return entries


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
    log(f"build {', '.join(outputs)} (fused_topk: f32, bf16, int8 split "
        "kernels + merge, the f32 and bf16 ladder rungs, the scores kernel; "
        "image_ops: histogram, LUT, row shifts; depthwise_conv: forward, tap "
        "gradients + reduction; stream_probe: row sums + fold), one nvcc "
        f"each in parallel: {time.perf_counter() - t0:.1f} s")
    for name, out in outputs.items():
        for line in out.splitlines():
            if any(w in line for w in ("registers", "Compiling entry",
                                       "spill")):
                log(f"  {name}: {line.strip()}")

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
            n_diff = near_tie_rows(ki, ri, R.dense_scores(qh, g_in, mode),
                                   rv[:, K - 1:K], (mode, what))
            log(f"{mode} kernel, float gallery, {what}: max |vals - plain| "
                f"= {e:.3g}; {n_diff} of {kv.shape[0]} rows have index sets "
                "that differ, only at near-ties of the k-th value; "
                f"{n_ok} rows certified by the kernel and its plain version "
                "alike")
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
        ms = event_ms(lambda: R.fused_cosine_topk(q_hat, g_in, K, **kw),
                      reps=20)
        plain_ms = event_ms(lambda: R.fused_cosine_topk_reference(
            q_hat, g_in, K, matmul_dtype=mode, splits=splits, **kw),
            reps=5, warmup=1)
        if mode == "float32":
            library = "torch.topk(torch.matmul(q̂, ĝᵀ), 150), f32"
            library_ms = event_ms(lambda: torch.topk(
                torch.matmul(q_hat, g_hat.t()), K), reps=20)
            g_bytes = 4 * (G_TOTAL * DIM + G_TOTAL)
        elif mode == "bfloat16":
            library = ("torch.topk(torch.matmul(q̂16, ĝ16ᵀ).float(), 150); "
                       "cuBLAS rounds its output to bf16")
            library_ms = event_ms(lambda: torch.topk(
                torch.matmul(q16, g_in.t()).float(), K), reps=20)
            g_bytes = 2 * G_TOTAL * DIM
        else:
            library = ("torch._int_mm(q8, g8ᵀ) -> rescale -> torch.topk, "
                       "int8 tensor cores")
            gs = kw["gallery_scale"]
            library_ms = event_ms(lambda: torch.topk(
                torch._int_mm(qq, g_in.t()).float() * (qs * gs.reshape(1, -1)),
                K), reps=20)
            g_bytes = G_TOTAL * DIM + 4 * G_TOTAL
        nbytes = 4 * q * DIM + g_bytes + 8 * q * K + 4 * q
        ops = 2 * q * G_TOTAL * DIM
        bound_bytes = nbytes / peaks["bytes"] * 1e3
        bound_ops = ops / peaks[mode] * 1e3
        bound = max(bound_bytes, bound_ops)
        log(f"{name} Q={q} G={G_TOTAL} D={DIM} k={K}: {ms:.3f} ms "
            f"(bound {bound:.3f} ms: bytes {bound_bytes:.3f}, operations "
            f"{bound_ops:.3f}); plain {plain_ms:.3f} ms; library "
            f"{library_ms:.3f} ms ({library})")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "imageretrievalresearch_tpu_torch/csrc/fused_topk.cu",
            "replaces": f"imageretrievalresearch_tpu/{replaces}",
            "launches": launches[name],
            "max_abs_err": errs[mode],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "library_ms": library_ms,
        })
        del g_in, kw

    kernels += augment_phase(model, gen, peaks)
    kernels += training_phase(model, gen, peaks)
    kernels += inference_phase(model, index, paths, gen, peaks)

    # 8. result: the one card this run drove
    print(json.dumps({"kernels": kernels}))
    print(PF.card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": 1}}), flush=True)


if __name__ == "__main__":
    main()
