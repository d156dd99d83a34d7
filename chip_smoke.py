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
9. The other backbones at full width with seeded weights, each card
   forward (f32, TF32 off) against the CPU's of the same weights on 4
   images (``CPU_FWD_RTOL``). ``rexnet_150`` (D = 1920) and
   ``swin_s3_base_224`` (D = 768) serve as phases 2-4 do: 512 embedded
   images + seeded unit rows (G = 100,000), a Q = 64 request in each
   mode, cold then warm, counts set to 0 just before each and read just
   after (one launch of the mode's kernel), then kernels 1-3 against
   their plain versions by phase 4's rules and timed over that gallery
   (rows 1-3's ``models``). T1 (``make_config("train")``, cos 0.5 + CE)
   on ``rexnet_150`` at 32 triplets, as phase 6 runs T3: kernels 9 and
   10 against their plain versions at its 16 depthwise layers (ten with
   C % 8 != 0) and timed at N = 96 beside cuDNN; a fit with the opt-in
   (16 forward + 16 dx + 16 tap-gradient launches a step, 16 forwards a
   val batch) and on cuDNN, losses compared; the f32 step with its
   planted faults; warm step times (rows 9-10's ``models``). T4
   (``make_config("train_vit_triplet")``, embedding-only cos 0.2) on
   ``swin_s3_base_224`` at its 32 triplets under bf16 autocast: a fit of
   3 steps + 1 val batch, warm step ms, device busy against wall, peak
   memory. ``resnet50`` and ``darknet53``: a batch of 64 embedded.
10. Training from disk through the CLIs users run, in this process
   (``build_parser().parse_args([...])`` -> ``run``). The port's
   ``make_sketchy_tree`` writes 8 categories x 10 products at 256 px (240
   JPEG photos, 160 PNG sketches; time to write); ``decode_image`` reads
   every file (ms per JPEG and per PNG), each photo within the stated
   error of its written pixels, each sketch exact, and every file bit for
   bit against PIL's decode where PIL imports (in a child process; the
   count that agree). ``cli.data_split --layout sketchy --policy prod``
   gives 192 / 24 / 24 queries. ``cli.train --recipe
   train_efficient_cos_con_ce_loss -bs 16 --max_epochs 2 --cache
   --host_size 256`` (T3, efficientnet_b3a at 224 px, AutoAugment, bf16)
   with ``IRT_FORCE_PALLAS_DW=1``, counts set to 0 just before and read
   just after: kernels 5-8 at phase 5's counts per policy call x 3 roles
   x 24 train steps, kernel 9's forward 26 per train step and per val
   batch, dx and kernel 10 26 per train step, ``PLAIN_ON_CARD``
   unchanged, no layout copy; ``hparams.yaml``, ``metrics.jsonl``,
   ``best/`` and ``last/`` written, and the ``last/`` checkpoint read back
   by ``models.convert.load_checkpoint`` embeds 4 images bit for bit as
   the in-memory final state. Its times: the cache fill, each epoch's
   wall and CUDA-event ms per step and the loader's wait, a warm epoch
   profiled (device idle share, top host ops), 4 uncached steps' loader
   wait, peak memory. ``cli.find_lr --recipe find_lr -bs 16
   --num_lr_steps 30 --cache --host_size 256`` (rexnet_150) with the
   opt-in: a finite suggestion inside [min_lr, max_lr] from at least 3
   losses, 16 + 16 + 16 depthwise launches per sweep step, ms per step.
   Rows 5-10 of the kernels line carry the train run's launches as
   ``train_cli_launches`` (rows 5-8 by C entry), rows 9-10 the sweep's as
   ``find_lr_launches``. Then the decode pool (``data.native_loader``,
   JAX's C++ loader's counterpart): ``decode_resize_batch`` over the
   tree's 400 files on 1 and on ``os.cpu_count()`` processes (the pool's
   start-up and the fill, every worker used, each image's digest the
   in-process ``decode_image``'s); the uncached train loader with
   ``use_native`` (wait per step at 1 process over 4 steps, and over an
   epoch at cpu_count, whose batches equal bit for bit the threaded
   loader's epoch, which reads the pool's images from its dataset's
   cache); ``cli.train ... --max_epochs 1 --use_native_loader``: every
   train and val batch from the pool, each pass's pool using all its
   processes.
11. Evaluation and analysis from disk, in this process. The port's
   ``make_sketchy_tree`` writes 8 categories x 11 products at 256 px (264
   JPEG photos, 176 PNG sketches). Whether matplotlib imports is asked in
   a child process (a report of the machine: without it no ``--viz_dir``
   step runs). ``cli.inference -ip <tree> -bs 64 --cache True
   --save_gallery <npz> --gallery_dtype int8`` (+ ``--viz_dir`` where
   matplotlib imports): rexnet_150, its default (D = 1920), seeded
   weights, 224 px squarepad, class_dedup, counts set to 0 just before and
   read just after: kernel 1 once (the evaluation's Q = G = 264), nothing
   else, no plain version on the card; its printed top1 / top3 / scores
   against ``RetrievalEngine.evaluate_class_dedup`` on the same embeddings
   through ``method='dense'`` (true f32): deduplicated values within
   ``EVAL_TIE_ATOL`` and top1 / top3 within the share of queries ranked
   otherwise (near-ties); the grids written and not empty. Then
   ``--topk_variant index_match`` (kernel 1 once, held to the dense path
   the same way). ``cli.gallery query`` of 64 photos against the int8
   artifact in int8 (kernel 3) and float32 (kernel 1), one launch each,
   records and top-1 classes against the library path (near-tie rule).
   ``grad_cam_pair`` and ``grad_cam_class`` on rexnet_150 and
   swin_s3_base_224 (49 tokens folded to 7 x 7) for 8 queries on the card
   against the CPU's maps of the same weights (``CAM_ATOL``).
   ``method='approx'`` over the phase 2 gallery (G = 100,000) at Q = 64:
   no kernel, indices and values equal to ``method='dense'``'s, recall
   against exact, and both warm times. The wall of each CLI run, the
   cache fill, embed ms per batch, the evaluation's ms, the query walls
   and the CAM ms. Rows 1 and 3 of the kernels line carry these launches
   as ``inference_cli_launches``.
12. Sharded retrieval (``parallel/``) on the one card, over the phase 2
   gallery (G = 100,000 x 1536): ``GalleryIndex.query_class_dedup(
   mesh=Mesh(["cuda:0"] * R))`` at Q = 64, k = 150, num_unique = 3, for R
   = 2 and 4 in float32, bfloat16 and int8, the same gallery with 3
   seeded rows more (G = 100,003) over R = 8 (5 pad rows), and
   ``make_mesh()`` (one device) in float32; counts set to 0 just before
   each request and read just after: one launch of the mode's kernel (1,
   2 or 3) per shard, nothing else, no certificate repair, no plain
   version; the dedup and the top-150 bit for bit the unsharded request's
   (and the f32 shards' norms the unsharded norms); warm request times,
   sharded against unsharded, in turns. Rows 1-3 of the kernels line
   carry these launches as ``sharded_launches``.
13. Multi-device training on the one card (``multidevice_phase``):
   phase 6's T3 step (b3a, 64 triplets of 256 px sources, its seeds) in
   f32 with SGD, once on the card without a process group (the
   reference; and again, for the card's own run-to-run spread), then (a)
   as DDP and (c) as FSDP in an NCCL group of one in this process, the
   group-wide BatchNorm's own arithmetic at world size 1, (b) over 2
   ranks sharing card 0 over gloo (NCCL refuses two ranks on one card,
   which is checked too), launched as worker processes by the port's
   launcher, 32 triplets each, and (f) ``Trainer.fit`` with FSDP, which
   launches its workers, one per card. Each against the reference: the
   loss, the parameters, the BatchNorm running statistics, the train
   metrics (``MD_*``); kernels 9 and 10 at 26 + 26 + 26 and kernels 5-8
   at phase 5's counts per step, in every rank. Where more cards are
   visible, (e) the step on one rank per card over NCCL, replicated and
   FSDP. (d) runs inside phase 10, on its tree: ``cli.train`` over
   ``--coordinator_address localhost:<port> --num_processes 1
   --process_id 0`` (one epoch, DDP in an NCCL group of one) against
   phase 10's first epoch. Rows 5-10 of the kernels line carry (b)'s
   launches per rank as ``multi_device_launches_per_rank``.
14. The last of the JAX package. (a) runs inside phase 10, on its
   ``cli.train`` run directory: ``cli.convert --to torch
   --lightning_out`` and the file back ``--to native`` (each CLI call's
   seconds), each read by ``load_checkpoint`` into a fresh b3a on the
   card; the tree's 400 files embed bit for bit through the three, and a
   Q = 64 class-dedup query over them ranks the same through kernel 1
   (row 1's ``convert_launches``). (b) the 2-D (data, model) hybrid
   layout (``group_mesh((2, 2), ("data", "model"))``, ``put_fsdp(...,
   axis_name="model")``: FSDP2's HSDP; ``shard_batch``; the step built
   with ``mesh=``) over 4 gloo ranks sharing card 0, launched by the
   port's launcher (target ``chip_smoke:hybrid_rank``): one f32 SGD step
   of full-width b3a (T3, 32 triplets, 16 a data row; kernels 5-10 in
   every rank, rows 5-10's ``hybrid_launches_per_rank``) and one of
   full-width ``swin_s3_tiny_224`` (T4's recipe at SGD 1e-2, 16
   triplets), each against the same step on one card by phase 13's
   limits, with each rank's step ms, peak GB, launches and shard sizes.
   (c) the b3a step on a (1, 1) mesh at world size 1 over NCCL; where
   four cards are visible, (b) with one rank per card over NCCL (else a
   line says it did not run; ``python -c "import chip_smoke as C;
   C.hybrid_phase(C.PF.card())"`` runs (b) and (c) alone, and
   ``C.hybrid_four_cards(C.PF.card())`` the four-card stanza alone).
15. One JSON line of kernels, the nvidia-smi line, and the result line.

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
import copy
import ctypes
import dataclasses
import functools
import gc
import hashlib
import importlib
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
from typing import NamedTuple

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device; nothing was run")

from imageretrievalresearch_tpu_torch.cli import convert as CONVERT_CLI  # noqa
from imageretrievalresearch_tpu_torch.cli import data_split as SPLIT_CLI  # noqa
from imageretrievalresearch_tpu_torch.cli import find_lr as FIND_LR_CLI  # noqa
from imageretrievalresearch_tpu_torch.cli import gallery as CLI  # noqa: E402
from imageretrievalresearch_tpu_torch.cli import inference as INFER_CLI  # noqa
from imageretrievalresearch_tpu_torch.cli import train as TRAIN_CLI  # noqa
from imageretrievalresearch_tpu_torch.data import native_loader as NL  # noqa
from imageretrievalresearch_tpu_torch.data import synthetic as SYN  # noqa
from imageretrievalresearch_tpu_torch.data.decode import (  # noqa: E402
    DecodeCacheMixin,
)
from imageretrievalresearch_tpu_torch.data.loader import (  # noqa: E402
    TripletLoader,
)
from imageretrievalresearch_tpu_torch.data.decode import (  # noqa: E402
    decode_image,
    resize_bilinear_host,
    square_pad_host,
)
from imageretrievalresearch_tpu_torch.models import create_model  # noqa: E402
from imageretrievalresearch_tpu_torch.models.convert import (  # noqa: E402
    load_checkpoint,
)
from imageretrievalresearch_tpu_torch.models import layers as GBN  # noqa
from imageretrievalresearch_tpu_torch.models.layers import (  # noqa: E402
    DepthwiseConv2d,
)
from imageretrievalresearch_tpu_torch.ops import _cuda  # noqa: E402
from imageretrievalresearch_tpu_torch.ops import autoaugment as A  # noqa: E402
from imageretrievalresearch_tpu_torch.ops import depthwise as DW  # noqa: E402
from imageretrievalresearch_tpu_torch.ops import image_kernels as IK  # noqa: E402
from imageretrievalresearch_tpu_torch.ops import retrieval as R  # noqa: E402
from imageretrievalresearch_tpu_torch.parallel import (  # noqa: E402
    Mesh,
    fsdp_spec,
    group_mesh,
    make_mesh,
    put_fsdp,
    shard_batch,
)
from imageretrievalresearch_tpu_torch.parallel import (  # noqa: E402
    distributed,
)
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
from imageretrievalresearch_tpu_torch.retrieval import engine as ENGINE  # noqa
from imageretrievalresearch_tpu_torch.retrieval.gradcam import (  # noqa: E402
    grad_cam_class,
    grad_cam_pair,
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
    TrainState,
    build_train_step,
    lr_finder,
    make_optimizer,
    multistep_lr,
)
from imageretrievalresearch_tpu_torch.train.trainer import (  # noqa: E402
    _generator_seeds,
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
DW_COMPARE_N = 8
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


class TrainRun(NamedTuple):
    """A training path of the smoke: its recipe on its model, ``steps``
    train batches of ``batch`` seeded triplets (+ 1 val batch); kernels 9
    and 10 are timed at one step's depthwise batch, 3 x ``batch``; the
    f32 step's depthwise weight gradients agree with cuDNN's within
    ``f32_grad_rtol``."""
    tag: str
    recipe: str
    model: str
    batch: int
    steps: int = TRAIN_STEPS
    f32_grad_rtol: float = F32_GRAD_RTOL


# T3 on b3a (phase 6); T1 on rexnet_150 at 32 triplets, T4 on
# swin_s3_base_224 at its recipe's 32 (phase 9). RexNet's depthwise
# weight gradients in a train-mode f32 step pass through more
# batch-statistics BatchNorm than b3a's (SE's over one value per image),
# which magnifies f32 rounding: T1's limit sits between the card's sound
# reading, 6.6e-3, and the planted faults' nearest, 1.31 (NVIDIA H100
# 80GB HBM3, 700 W).
T3 = TrainRun("T3", "train_efficient_cos_con_ce_loss", "efficientnet_b3a",
              TRAIN_BATCH)
T1 = TrainRun("T1", "train", "rexnet_150", 32, f32_grad_rtol=0.1)
T4 = TrainRun("T4", "train_vit_triplet", "swin_s3_base_224", 32)
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
MODE_KERNELS = {"float32": "fused_cosine_topk",
             "bfloat16": "fused_cosine_topk_bf16",
             "int8": "fused_cosine_topk_int8",
             "int8_rerank": "fused_cosine_topk_int8"}
SERVE_TIE_ATOL = 2e-5
# a ten-line program against the native loader's libraries
# (native/Makefile: -ljpeg -lpng)
# phase 9: the other backbones at full width with seeded weights; the
# served ones and their embedding widths, and the ones embedded once. The
# card's f32 forward (TF32 off) against the CPU's on CPU_CHECK_N seeded
# images: the largest |card - CPU| as a share of the largest |CPU value|,
# f32 sums in other orders through the model's depth (cuDNN, oneDNN)
SERVED = {"rexnet_150": 1920, "swin_s3_base_224": 768}
EMBEDDED = ("resnet50", "darknet53")
CPU_CHECK_N, CPU_FWD_RTOL = 4, 1e-4
# phase 10, training from disk: the port's synthetic Sketchy tree at
# Sketchy DB-256's 256 px (8 categories x 10 products: 240 JPEG photos,
# 160 PNG sketches), split by product (JAX's data_split gives this tree
# 192 / 24 / 24 queries), T3 for 2 epochs and the find_lr sweep at 16
# triplets a step. Sketchy validation drops the remainder: 12 train steps
# and 1 val batch an epoch.
DISK_TREE = dict(n_cats=8, n_prods=10, n_photos=3, n_sketches=2, size=256,
                 structured=True, seed=0)
DISK_SPLIT = {"train": 192, "val": 24, "test": 24}
DISK_BATCH, DISK_EPOCHS, DISK_LR_STEPS = 16, 2, 30
DISK_STEPS = DISK_SPLIT["train"] // DISK_BATCH          # per epoch
DISK_VAL_BATCHES = DISK_SPLIT["val"] // DISK_BATCH      # per epoch
# depthwise layers of efficientnet_b3a (T3) and rexnet_150 (find_lr)
B3A_DW_LAYERS, REXNET_DW_LAYERS = 26, 16
# the writer codes each photo's pixels (a class pattern + N(0, 28) noise)
# at quality 75 with 4:2:0 chroma, which drops most of the noise: a photo
# decodes within these of its written pixels, mean |error| per photo and
# the largest |error|; a decoder with swapped, shifted or unsampled planes
# lands far outside the mean. PNG sketches decode exactly.
DISK_JPEG_MEAN_ERR, DISK_JPEG_MAX_ERR = 24.0, 200
# the uncached loader's steps measured after the CLI run (each decodes 48
# files: query, positive and negative of 16 triplets)
DISK_UNCACHED_STEPS = 4
# phase 13, multi-device training: phase 6's T3 step (b3a, TRAIN_BATCH
# triplets of TRAIN_SRC px sources, the same weights, batch and seeds) in
# f32 (TF32 off) with SGD, whose update is linear in the gradient (AdamW's
# first update is about lr * sign(g), which turns rounding differences of
# near-zero gradients into full-size steps). One step on one card, no
# group, is the reference of (a) DDP and (c) FSDP at world size 1 over
# NCCL and (b) MD_RANKS ranks over gloo sharing card 0, TRAIN_BATCH /
# MD_RANKS rows each. The limits: the loss and the BatchNorm running
# statistics (relative), the in-batch top-k equal, and the parameters as
# tests/test_torch_train.py holds steps whose sums run in other orders:
# all of them within MD_PARAM_NORM_RTOL of the update's norm, each
# tensor's largest difference within MD_PARAM_TENSOR_SHARE of its largest
# update. At random weights the T3 loss is ~443 and one SGD step moves
# the early layers by as much as their values, so rounding shows in the
# update: (b) read 1.3e-4 of the norm, and the group-wide BatchNorm's own
# arithmetic in place of cuDNN's at world size 1 1.4e-4, against 3.4e-7
# for the same step run twice (NVIDIA H100 80GB HBM3, 700 W); a missing
# 1 / R on a gradient would read ~0.5.
MD_RANKS = 2
MD_LOSS_RTOL, MD_STAT_RTOL, MD_STAT_ATOL = 1e-4, 1e-4, 1e-6
MD_PARAM_NORM_RTOL, MD_PARAM_TENSOR_SHARE = 1e-3, 1e-2
# (d) cli.train over the multi-host flags at world size 1 against phase
# 10's run: its first epoch's losses and cos_sims, relative (phase 6's
# bf16 per-step limit; the same arithmetic is expected bit for bit)
MD_CLI_RTOL = 5e-3
# phase 14, the last of the JAX package. (a) inside phase 10, on its run
# directory: cli.convert --to torch --lightning_out and back --to native,
# each read by load_checkpoint on the card; the tree's 400 files (decoded
# at 224 px on a pool of CONVERT_DECODERS processes) embed bit for bit,
# and a Q = CONVERT_QUERIES class-dedup query over them (G = 400 >= 256:
# kernel 1) ranks the same. (b) the 2-D (data, model) hybrid layout of
# JAX's tests/test_fsdp.py over HYBRID_SHAPE gloo ranks sharing card 0:
# one f32 SGD step of full-width b3a (T3, phase 13's first batch cut to
# HYBRID_B3A_BATCH triplets, HYBRID_B3A_BATCH / 2 a data row; kernels 5-10
# in every rank) and one of full-width swin_s3_tiny_224 (T4's recipe at
# JAX's hybrid case's SGD 1e-2: T4's own 1e-5 moves a parameter by less
# than its f32 rounding; HYBRID_SWIN_BATCH triplets), each against the
# same step on one card without a group by phase 13's limits. (c) the
# b3a step on a (1, 1) mesh at world size 1 over NCCL, and, where four
# cards are visible, (b) with one rank per card over NCCL.
HYBRID_SHAPE, HYBRID_AXES = (2, 2), ("data", "model")
HYBRID_B3A_BATCH, HYBRID_SWIN_BATCH, HYBRID_SWIN_LR = 32, 16, 1e-2
HYBRID_SWIN = "swin_s3_tiny_224"
CONVERT_QUERIES, CONVERT_DECODERS = 64, 8
# phase 11, evaluation and analysis from disk: the port's synthetic Sketchy
# tree at 256 px with 11 products a category (264 JPEG photos, 176 PNG
# sketches), so the evaluation's gallery (one positive per photo, G = Q =
# 264) reaches kernel 1's G >= 4 x FUSED_BINS = 256; phase 10's 8 x 10
# tree has 240, and the generator's draws depend on n_prods, so the phase
# writes its own. cli.inference runs rexnet_150, its default (D = 1920),
# at 224 px and batches of 64; the artifact is queried with 64 photos.
EVAL_TREE = dict(n_cats=8, n_prods=11, n_photos=3, n_sketches=2, size=256,
                 structured=True, seed=0)
EVAL_ITEMS, EVAL_BATCH, EVAL_QUERIES, EVAL_DIM = 264, 64, 64, 1920
# kernel 1 computes 3xTF32 scores (within ~1e-7 of an f64 product), the
# dense reference true f32: the evaluation's deduplicated values agree
# within EVAL_TIE_ATOL, and a query's top classes may differ only where
# they do (a near-tie); top1 / top3 then move by at most those queries
EVAL_TIE_ATOL = 1e-6
# Grad-CAM on the card against the CPU's, same weights and inputs, 8
# queries, maps normalized to [0, 1]: f32 against f64 on the CPU differs
# by up to 1.3e-5 (RexNet-150, pair CAM) and 1.0e-4 (Swin-S3-base, pair
# CAM) on seeded images, so the card's f32 sums in other orders are held
# to CAM_ATOL, ten times that
CAM_MODELS = ("rexnet_150", "swin_s3_base_224")
CAM_N, CAM_SIDE, CAM_ATOL = 8, 7, 1e-3
APPROX_REPS = 5
# phase 10's decode pool: the tree's 400 files decoded on 1 and on
# os.cpu_count() processes; the uncached loader with use_native timed over
# DISK_UNCACHED_STEPS steps at 1 process and over an epoch at cpu_count
# (held bitwise against the threaded loader's epoch)
# phase 12, sharded retrieval: the phase 2 gallery (G = 100,000 x 1536)
# over R row shards of the one card for R in SHARDS, and G = 100,003 (3
# seeded unit rows appended) over RAGGED_R = 8 shards, which pads 5 rows;
# a Q = 64 request (phase 3's served queries), k = 150, num_unique = 3, in
# each mode; SHARD_REPS warm requests timed per path, sharded and
# unsharded in turns
SHARDS, RAGGED_EXTRA, RAGGED_R, SHARD_REPS = (2, 4), 3, 8, 7
SHARD_MODES = ("float32", "bfloat16", "int8")
# PIL's decode of every file of the tree, in a child process (the smoke
# imports no PIL): one line of JSON, path -> sha256 of the RGB array
PIL_DIGESTS = r"""
import hashlib, json, sys
import numpy as np
from PIL import Image
out = {}
for path in sys.argv[1:]:
    with Image.open(path) as im:
        a = np.ascontiguousarray(np.asarray(im.convert("RGB")))
    out[path] = hashlib.sha256(repr(a.shape).encode() + a.tobytes()).hexdigest()
print(json.dumps(out))
"""
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


def profiled(ms: float | None) -> str:
    """A kernel's device time from torch.profiler, or "not measured" where
    the trace holds none of its launches (CUPTI may miss them)."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


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
            f"{b_ms:.4f}, device {profiled(dev_ms)} per launch, "
            f"{profiled(hbm_ms)} with "
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
    log(f"plane_histogram on {p} planes of one value: "
        f"{profiled(const_hbm_ms)} per launch with its operands read from "
        "HBM")
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


def dw_times(shapes, gen, peaks: dict,
             n: int) -> tuple[dict, float, float]:
    """Per pass (forward, dx, dw) at batch ``n`` in bf16, summed over
    ``shapes``: kernel, plain and library (cuDNN) ms, and the bound; each
    kernel is also held against its plain version on the same operands
    (``dw_check``), whose largest tap-gradient error and share come back
    with the times."""
    conv_bwd = torch.ops.aten.convolution_backward
    tot = {p: dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                             "bytes_ms", "ops_ms", "burst_ms",
                             "library_burst_ms"), 0.0)
           for p in ("forward", "dx", "dw")}
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


def run_config(run: TrainRun, checkpoint_dir: str | None, **kw):
    return make_config(run.recipe, batch_size=run.batch, image_size=SIZE,
                       checkpoint_dir=checkpoint_dir, **kw)


def set_opt_in(on: bool) -> None:
    if on:
        os.environ["IRT_FORCE_PALLAS_DW"] = "1"
    else:
        os.environ.pop("IRT_FORCE_PALLAS_DW", None)


def fit_once(model, init: dict, train, val, kernels: bool, run: TrainRun,
             label: str | None = None) -> dict:
    """One epoch of ``Trainer.fit`` of ``run`` from ``init``, launch
    counts set to 0 just before and read just after; its per-step losses
    from metrics.jsonl."""
    set_opt_in(kernels)
    model.load_state_dict(init)
    with tempfile.TemporaryDirectory() as d:
        trainer = Trainer(run_config(run, d, log_every_n_steps=1), model,
                          train, val)
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
    assert state.step == run.steps and len(losses) == run.steps
    assert all(np.isfinite(v) for v in epoch.values()), epoch
    assert saved == {"best": [str(run.steps)], "last": [str(run.steps)]}
    log(f"{run.tag} fit ({run.model}), 1 epoch ({run.steps} steps of "
        f"{run.batch} triplets + 1 val batch), "
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


def f32_step(model, init: dict, train, kernels: bool, layers,
             run: TrainRun) -> tuple:
    """One f32 train step of ``run`` (TF32 off) on 16 triplets from
    ``init``: the loss and the gradients of the depthwise weights of
    ``layers``."""
    set_opt_in(kernels)
    model.load_state_dict(init)
    cfg = run_config(run, None, compute_dtype="float32")
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


def timed_epochs(model, init: dict, train, kernels: bool,
                 run: TrainRun) -> dict:
    """Warm epoch time of ``run`` (wall around a synchronised epoch and
    CUDA events), peak memory, and one profiled epoch."""
    set_opt_in(kernels)
    model.load_state_dict(init)
    trainer = Trainer(run_config(run, None), model, train)
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
    wall = (time.perf_counter() - t0) * 1e3 / run.steps
    ev = a.elapsed_time(b) / run.steps
    peak = torch.cuda.max_memory_allocated() / 1e9
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, pwall = sync_time(lambda: trainer.train_epoch(state, 2))
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    name = "depthwise kernels" if kernels else "cuDNN"
    log(f"{run.tag} train step ({run.model}), {name}, warm: {wall:.1f} ms "
        f"wall, {ev:.1f} ms CUDA events per step of {run.batch} triplets "
        f"(epoch of {run.steps}); peak {peak:.2f} GB; profiled epoch "
        f"{pwall:.1f} ms "
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


def depthwise_training(run: TrainRun, gen, peaks: dict,
                       ragged: list = ()) -> dict:
    """Kernels 9 and 10 against their plain versions at the depthwise
    layers of ``run``'s model (and ``ragged`` shapes) and timed at one
    step's batch, then ``run`` with them and on cuDNN. Returns the layer
    shapes, the fit's launches, the per-pass totals (``dw_times``) and the
    tap gradients' largest |kernel - plain|."""
    model = create_model(run.model, num_classes=N_CLASSES, seed=SEED)
    shapes = dw_layer_shapes(model)
    err_small, _ = dw_compare(shapes + list(ragged), gen)
    if run is T3:   # properties of the wrappers, not of the shapes
        dx_kernels_only(shapes, gen)
        dw_host_us(gen)
    tot, err_path, _ = dw_times(shapes, gen, peaks, 3 * run.batch)

    init = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(SEED)
    train = MemoryLoader(rng, run.steps, run.batch)
    val = MemoryLoader(rng, 1, run.batch)

    # the main path: kernels 9 and 10 on every depthwise layer, and the
    # image kernels where the recipe augments
    ours = fit_once(model, init, train, val, True, run)
    launches = ours["counts"]["dw"]
    n = len(shapes)
    assert launches == {
        "depthwise_conv_forward": n * run.steps + n,
        "depthwise_conv_grad_x": n * run.steps,
        "depthwise_conv_grad_w": n * run.steps}, launches
    augment = run_config(run, None).autoaugment
    assert ours["counts"]["image"] == {
        k: run.steps * 3 * p * augment
        for k, p in launches_per_policy().items()}, ours["counts"]
    for plain in ("dw_plain", "image_plain"):
        assert not any(ours["counts"][plain].values()), ours["counts"]
    # the activations reach the kernels as channels-last views
    assert ours["counts"]["copies"] == {"nhwc": 0}, ours["counts"]
    ref = fit_once(model, init, train, val, False, run)
    assert not any(ref["counts"]["dw"].values()), ref["counts"]

    def rel(r):
        return [abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                     ref["losses"])]
    faulted = {}
    if run is T3:   # the bf16 planted faults, calibrated on b3a
        for fault in BF16_FAULTS:
            with planted(fault):
                faulted[fault] = rel(fit_once(model, init, train, val, True,
                                              run, f"planted fault: {fault}"))
    log(f"{run.tag} train_loss per step against cuDNN's (bf16), relative "
        f"differences: depthwise kernels {rel(ours)}; planted faults "
        f"{faulted}; tolerances {BF16_LOSS_RTOL}")
    assert all(r <= t for r, t in zip(rel(ours), BF16_LOSS_RTOL)), rel(ours)
    for fault, r in faulted.items():
        assert any(a > t for a, t in zip(r, BF16_LOSS_RTOL)), (fault, r)

    dws = [m for m in model.modules() if isinstance(m, DepthwiseConv2d)]
    picked = [0, len(dws) // 2, len(dws) - 1]
    layers = [dws[i] for i in picked]
    l_r, g_r = f32_step(model, init, train, False, layers, run)

    def f32_rel(fault=None):
        with planted(fault) if fault else contextlib.nullcontext():
            l_k, g_k = f32_step(model, init, train, True, layers, run)
        return (abs(l_k - l_r) / abs(l_r),
                max(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(g_k, g_r)))
    sound = f32_rel()
    faulted = {fault: f32_rel(fault) for fault in DW_FAULTS}
    log(f"one f32 {run.tag} step on 16 triplets (TF32 off) against cuDNN's: "
        f"loss {l_r:.7g}; relative loss difference and depthwise weight "
        f"gradients of layers {picked} (C = "
        f"{[m.in_channels for m in layers]}; max |diff| / max |grad|): "
        f"depthwise kernels {sound}; planted faults {faulted}; tolerances "
        f"{(F32_LOSS_RTOL, run.f32_grad_rtol)}")
    assert sound[0] <= F32_LOSS_RTOL and sound[1] <= run.f32_grad_rtol, sound
    for fault, (dl, dg) in faulted.items():
        assert dl > F32_LOSS_RTOL or dg > run.f32_grad_rtol, (fault, dl, dg)

    # warm step times, in turns: kernels, cuDNN, cuDNN, kernels
    for kernels in (True, False, False, True):
        timed_epochs(model, init, train, kernels, run)
    set_opt_in(False)
    return {"shapes": shapes, "launches": launches, "tot": tot,
            "err": max(err_small, err_path)}


def dw_entries(t3: dict, t1: dict) -> list:
    """Rows 9 and 10 of the kernels line: kernel 9 (the TPU's
    _dw_fwd_kernel, which JAX runs for dx too) counts and times the
    forward and dx kernels together. The top-level numbers are T3's on
    b3a (phase 6), ``models`` holds T1's on rexnet_150."""
    entries = []
    for name, passes, counters in (
            ("depthwise_conv_forward", ("forward", "dx"),
             ("depthwise_conv_forward", "depthwise_conv_grad_x")),
            ("depthwise_conv_grad_w", ("dw",), ("depthwise_conv_grad_w",))):
        def numbers(res):
            def total(key):
                return sum(res["tot"][p][key] for p in passes)
            return {
                "launches": sum(res["launches"][c] for c in counters),
                "max_abs_err": (res["err"] if name == "depthwise_conv_grad_w"
                                else 0.0),
                "ms": total("ms"),
                "plain_ms": total("plain_ms"),
                "bound_ms": total("bound_ms"),
                "bound_by": ("bytes" if total("bytes_ms") >= total("ops_ms")
                             else "operations"),
                "library_ms": total("library_ms"),
                "burst_ms": total("burst_ms"),
                "library_burst_ms": total("library_burst_ms"),
            }
        entries.append({
            "name": name,
            "route": "cuda",
            "source": DW_SOURCE,
            "replaces": f"imageretrievalresearch_tpu/{DW_KERNELS[name]}",
            **numbers(t3),
            "ms_by": "single call",
            "models": {T1.model: {**numbers(t1),
                                  "layers": len(t1["shapes"]),
                                  "n": 3 * T1.batch}},
        })
    return entries


def resident(index, mode: str):
    """``(gallery, keyword arguments)`` of ``fused_cosine_topk`` over the
    index's resident form of ``mode``."""
    return kernel_args(mode, index._gallery_on_device(mode))


def topk_checks(index, q_hat, gen,
                tag: str = "") -> tuple[dict, torch.Tensor]:
    """Kernels 1-3 against their plain versions over ``index`` (G x D),
    phase 4's rules: ±1 data with a planted bin overflow (bitwise, its
    certificate fails and ``cosine_topk`` repairs it exactly); the served
    queries ``q_hat`` and 64 seeded unit rows over each mode's resident
    form (f32 and bf16 within 1e-5 with index differences only at
    near-ties, kernel 1 within 1e-6 of f64 on the unit rows; int8 bitwise
    at k = 150 and at int8_rerank's shortlist). Returns the largest |kernel
    - plain| per mode and the unit rows."""
    g_total, d = len(index), q_hat.shape[1]
    splits = R.fused_splits(64, g_total, K, DEV)

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
    pq = pm1_rows(gen, 64, d)
    pg = pm1_rows(gen, g_total, d)
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
        log(tag + f"{mode} kernel, ±1 data: vals/inds/ok bitwise equal to the "
            "plain version; the planted bin overflow fails its certificate "
            "and cosine_topk repairs it exactly")
    del pq, pg, pqh, pn, g_in

    # the float gallery in each mode's resident form: the served queries
    # (random weights put them near one direction, so their top-k is dense
    # with near-ties) and seeded unit rows, whose top-k gaps are far wider.
    # int8 runs twice: at k=150 over the int8 form, and at the shortlist
    # c=256 (its own split count) over the int8_rerank form, as stage 1 of
    # the int8_rerank path runs it
    unit_q = R.l2_normalize(torch.randn((64, d), generator=gen,
                                        device=DEV))
    errs = {}
    for mode, form, k in (("float32", "float32", K),
                          ("bfloat16", "bfloat16", K), ("int8", "int8", K),
                          ("int8", "int8_rerank", SHORTLIST)):
        g_in, kw = resident(index, form)
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
                log(tag + f"int8 kernel, float gallery ({form} form), k={k}, "
                    f"{R.fused_splits(64, g_total, k, DEV)} splits, {what}: "
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
                log(tag + f"float32 kernel against f64 ({what}, served gallery): "
                    f"max |kernel vals - f64| {k_err:.3g} (limit 1e-6), max "
                    f"|plain vals - f64| {p_err:.3g}")
                assert k_err <= 1e-6, k_err
                del g64, exact
            n_diff = near_tie_rows(ki, ri, R.dense_scores(qh, g_in, mode),
                                   rv[:, K - 1:K], (mode, what))
            log(tag + f"{mode} kernel, float gallery, {what}: max |vals - plain| "
                f"= {e:.3g}; {n_diff} of {kv.shape[0]} rows have index sets "
                "that differ, only at near-ties of the k-th value; "
                f"{n_ok} rows certified by the kernel and its plain version "
                "alike")
            if mode == "bfloat16":
                log(tag + f"bf16 certificate pass rate, {what}: {n_ok} of "
                    f"{kv.shape[0]} rows with ok = 1; the contract's (the "
                    f"plain version's, which every design of the kernel is "
                    f"held to): {n_rok} of {kv.shape[0]}")
        del g_in, kw

    return errs, unit_q


def topk_times(index, q_hat, peaks: dict, tag: str = "") -> dict:
    """Kernels 1-3 over ``index`` at Q = 64 (each mode's resident form):
    kernel, plain and library ms (single calls; back-to-back bursts beside
    them) and the bound (kernel 1: the 3xTF32 bound, the f32-FMA bound
    beside it). Returns them by mode."""
    q, d = q_hat.shape
    g_total = len(index)
    splits = R.fused_splits(q, g_total, K, DEV)
    gal, norms = index._gallery_on_device()
    g_hat = R._normalized_gallery(gal, norms)
    q16 = q_hat.to(torch.bfloat16)
    qq, qs = R.quantize_rows_int8(q_hat)
    out = {}
    for mode, (name, _) in KERNELS.items():
        g_in, kw = resident(index, mode)
        call = (lambda: R.fused_cosine_topk(q_hat, g_in, K, **kw))
        ms, b_ms = event_ms(call, reps=20), PF.pipelined_ms(call)
        plain_ms = event_ms(lambda: R.fused_cosine_topk_reference(
            q_hat, g_in, K, matmul_dtype=mode, splits=splits, **kw),
            reps=5, warmup=1)
        if mode == "float32":
            library = "torch.topk(torch.matmul(q̂, ĝᵀ), 150), f32"
            lib_call = (lambda: torch.topk(torch.matmul(q_hat, g_hat.t()),
                                           K))
            g_bytes = 4 * (g_total * d + g_total)
        elif mode == "bfloat16":
            library = ("torch.topk(torch.matmul(q̂16, ĝ16ᵀ).float(), 150); "
                       "cuBLAS rounds its output to bf16")
            lib_call = (lambda: torch.topk(
                torch.matmul(q16, g_in.t()).float(), K))
            g_bytes = 2 * g_total * d
        else:
            library = ("torch._int_mm(q8, g8ᵀ) -> rescale -> torch.topk, "
                       "int8 tensor cores")
            gs = kw["gallery_scale"]
            lib_call = (lambda: torch.topk(
                torch._int_mm(qq, g_in.t()).float()
                * (qs * gs.reshape(1, -1)), K))
            g_bytes = g_total * d + 4 * g_total
        library_ms = event_ms(lib_call, reps=20)
        lib_b_ms = PF.pipelined_ms(lib_call)
        nbytes = 4 * q * d + g_bytes + 8 * q * K + 4 * q
        ops = 2 * q * g_total * d
        bound_bytes = nbytes / peaks["bytes"] * 1e3
        if mode == "float32":   # 3xTF32, and the f32-FMA bound beside it
            bounds = f32_bounds(nbytes, ops, peaks)
            bound_ops = TF32_PASSES * ops / peaks["tf32"] * 1e3
        else:
            bound_ops = ops / peaks[mode] * 1e3
            bounds = {"bound_ms": max(bound_bytes, bound_ops),
                      "bound_by": "operations" if bound_ops >= bound_bytes
                      else "bytes"}
        log(tag + f"{name} Q={q} G={g_total} D={d} k={K}: {ms:.3f} ms "
            f"(bound {bounds['bound_ms']:.3f} ms: bytes {bound_bytes:.3f}, "
            f"operations {bound_ops:.3f}"
            + (f"; f32-FMA bound {bounds['f32_fma_bound_ms']:.3f}"
               if mode == "float32" else "")
            + f"); plain {plain_ms:.3f} ms; library "
            f"{library_ms:.3f} ms ({library}); back-to-back: kernel "
            f"{b_ms:.3f} ms, library {lib_b_ms:.3f} ms")
        out[mode] = {"ms": ms, "plain_ms": plain_ms, **bounds,
                     "library_ms": library_ms, "burst_ms": b_ms,
                     "library_burst_ms": lib_b_ms}
        del g_in, kw
    return out


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
    """The library path for the same query files: ``data.decode`` (with
    the artifact's host size, where it records one), ``RetrievalEngine``
    over the same seeded model, then (the returned function of the mode)
    ``GalleryIndex.query_class_dedup`` on the same artifact."""
    idx = GalleryIndex.load(npz)
    host = idx.meta.get("host_size")

    def load(path):
        im = decode_image(path)
        if host:
            im = resize_bilinear_host(square_pad_host(im), (host, host))
        return im

    x = np.stack([load(p) for p in paths])
    model = create_model(idx.meta["model"],
                         num_classes=idx.meta["num_classes"])
    engine = RetrievalEngine(model, transform=build_eval_transform(
        idx.meta["transform"], idx.meta["input_size"]))
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
        for mode, kernel in MODE_KERNELS.items():
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


def card_vs_cpu(name: str, model) -> float:
    """The card's f32 forward of ``model`` (embedding and logits, eval
    mode) against the CPU's of a copy of its weights on CPU_CHECK_N
    seeded images at SIZE; returns the largest |card - CPU| as a share of
    the largest |CPU value| (limit CPU_FWD_RTOL)."""
    cpu = copy.deepcopy(model).to("cpu")
    x = torch.rand((CPU_CHECK_N, SIZE, SIZE, 3),
                   generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        want = cpu.features_and_logits(x)
        got = model.features_and_logits(x.to(DEV))
    assert all(torch.isfinite(g).all() for g in got), name
    rel = [(g.cpu() - w).abs().max().item() / w.abs().max().item()
           for g, w in zip(got, want)]
    log(f"[{name}] card vs CPU, f32 forward of {CPU_CHECK_N} images: "
        f"largest |difference| / largest |CPU value| {rel[0]:.3g} "
        f"(embedding, {tuple(want[0].shape)}), {rel[1]:.3g} (logits); limit "
        f"{CPU_FWD_RTOL}")
    assert max(rel) <= CPU_FWD_RTOL, (name, rel)
    return max(rel)


def serve_backbone(name: str, dim: int, gen, peaks: dict) -> dict:
    """Phase 9's serving path of ``name`` (seeded weights, D = ``dim``):
    the card's forward against the CPU's; 512 embedded images + 99,488
    seeded unit rows in a ``GalleryIndex`` (G = 100,000); a Q = 64
    request in each mode, cold then warm, counts set to 0 just before
    each and read just after (one launch of the mode's kernel); kernels
    1-3 against their plain versions over this gallery (``topk_checks``)
    and their times (``topk_times``). Returns, by kernel name, its
    launches, largest |kernel - plain| and times."""
    model = create_model(name, seed=SEED)
    assert model.num_features == dim, (name, model.num_features)
    card_vs_cpu(name, model)
    engine = RetrievalEngine(model,
                             transform=build_eval_transform("squarepad",
                                                            SIZE))
    emb, ms = sync_time(lambda: torch.cat(
        [engine.embed_batch(images(gen, 64))
         for _ in range(N_IMAGES // 64)]))
    assert emb.shape == (N_IMAGES, dim) and torch.isfinite(emb).all()
    log(f"[{name}] embed {N_IMAGES} images ({SIZE} px, f32): {ms:.1f} ms")
    classes = np.random.default_rng(SEED).integers(
        0, 1000, G_TOTAL).astype(np.int32)
    rows = R.l2_normalize(torch.randn((G_TOTAL - N_IMAGES, dim),
                                      generator=gen, device=DEV))
    index = GalleryIndex(dim)
    index.add(emb.cpu().numpy(), classes[:N_IMAGES])
    index.add(rows.cpu().numpy(), classes[N_IMAGES:])
    del rows, emb
    launches = dict.fromkeys(MODE_KERNELS.values(), 0)
    for mode, kernel in MODE_KERNELS.items():
        batch = images(gen, 64)
        for rnd in ("cold", "warm"):
            R.reset_launch_counts()
            q, embed_ms = sync_time(lambda: engine.embed_batch(batch))
            (vals, inds, cls), query_ms = sync_time(
                lambda: index.query_class_dedup(q, k=K, num_unique=3,
                                                matmul_dtype=mode,
                                                shortlist=SHORTLIST))
            counts = dict(R.KERNEL_LAUNCHES)
            assert counts[kernel] == 1 == sum(counts.values()), (
                name, mode, counts)
            assert not any(R.PLAIN_ON_CARD.values()), R.PLAIN_ON_CARD
            assert vals.shape == inds.shape == cls.shape == (64, 3)
            assert np.isfinite(vals).all() and (inds >= 0).all()
            np.testing.assert_array_equal(cls, index.classes[inds])
            assert (np.diff(vals, axis=1) <= 0).all(), "dedup order"
            launches[kernel] += 1
            upload = " (with the mode's upload)" if rnd == "cold" else ""
            log(f"[{name}] {mode} request Q=64, {rnd}: "
                f"{embed_ms + query_ms:.1f} ms end to end = embed "
                f"{embed_ms:.1f} + k={K} top-k and class dedup "
                f"{query_ms:.1f}{upload}; launches {counts}")
    q_hat = R.l2_normalize(q)
    errs, _ = topk_checks(index, q_hat, gen, f"[{name}, D = {dim}] ")
    times = topk_times(index, q_hat, peaks, f"[{name}] ")
    return {kernel: {"launches": launches[kernel],
                     "max_abs_err": errs[mode], **times[mode], "D": dim}
            for mode, (kernel, _) in KERNELS.items()}


def embed_backbone(name: str, gen) -> None:
    """``name`` (seeded weights): its forward against the CPU's, then a
    batch of 64 images through ``RetrievalEngine.embed_batch``, cold and
    warm."""
    model = create_model(name, seed=SEED)
    card_vs_cpu(name, model)
    engine = RetrievalEngine(model,
                             transform=build_eval_transform("squarepad",
                                                            SIZE))
    for rnd in ("cold", "warm"):
        emb, ms = sync_time(lambda: engine.embed_batch(images(gen, 64)))
        assert emb.shape == (64, model.num_features)
        assert torch.isfinite(emb).all(), name
        log(f"[{name}] embed 64 images ({SIZE} px, f32), {rnd}: {ms:.1f} ms")


def backbone_phase(gen, peaks: dict) -> tuple[dict, dict]:
    """Phase 9: rexnet_150 and swin_s3_base_224 serving
    (``serve_backbone``); T1 on rexnet_150 with the depthwise kernels
    and on cuDNN (``depthwise_training``); T4 on swin_s3_base_224 under
    bf16 autocast; resnet50 and darknet53 embedding a batch, each card
    forward against the CPU's. Returns the served rows (by model, then
    kernel) and T1's depthwise results."""
    t0 = time.perf_counter()
    served = {name: serve_backbone(name, dim, gen, peaks)
              for name, dim in SERVED.items()}

    t1 = depthwise_training(T1, gen, peaks)
    shapes = t1["shapes"]
    assert len(shapes) == 16 and sum(c % 8 != 0 for c, *_ in shapes) == 10
    log(f"T1 on {T1.model}: kernels 9 and 10 on its {len(shapes)} "
        f"depthwise layers (C, H, W, K, stride): {shapes}")

    # T4: embedding-only triplet training (cos 0.2) under bf16 autocast
    model = create_model(T4.model, num_classes=N_CLASSES, seed=SEED)
    card_vs_cpu(T4.model, model)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(SEED)
    train = MemoryLoader(rng, T4.steps, T4.batch)
    fit = fit_once(model, init, train, MemoryLoader(rng, 1, T4.batch),
                   False, T4)
    assert not any(v for c in fit["counts"].values() for v in c.values()), (
        fit["counts"])
    timed_epochs(model, init, train, False, T4)
    del model, init

    for name in EMBEDDED:
        embed_backbone(name, gen)
    log(f"phase 9 (other backbones): {time.perf_counter() - t0:.1f} s; "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")
    return served, t1


@contextlib.contextmanager
def patched(owner, name: str, wrap):
    """``owner.name`` replaced by ``wrap(original)`` inside the block: the
    phase's measurement hooks around the code a user runs."""
    orig = getattr(owner, name)
    setattr(owner, name, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def write_disk_tree(root: str) -> dict:
    """The port's ``make_sketchy_tree`` under ``root``; returns each
    file's written pixels."""
    written = {}

    def capture(save):
        def _save(path, arr):
            written[path] = arr
            save(path, arr)
        return _save

    with patched(SYN, "_save", capture):
        SYN.make_sketchy_tree(root, **DISK_TREE)
    return written


def digest(img: np.ndarray) -> str:
    return hashlib.sha256(repr(img.shape).encode()
                          + np.ascontiguousarray(img).tobytes()).hexdigest()


def disk_decode_checks(written: dict) -> dict:
    """Every file of the tree through ``decode_image``: ms per JPEG and
    per PNG, photos within the stated error of their written pixels,
    sketches exact; bit for bit against PIL where PIL imports (a child
    process), and the count that agree. Returns each file's digest."""
    times = {".jpg": [], ".png": []}
    digests, errs = {}, []
    for path, arr in sorted(written.items()):
        t0 = time.perf_counter()
        got = decode_image(path)
        times[os.path.splitext(path)[1]].append(time.perf_counter() - t0)
        assert got.shape == arr.shape and got.dtype == np.uint8, path
        if path.endswith(".png"):
            assert np.array_equal(got, arr), path
        else:
            e = np.abs(got.astype(np.int16) - arr.astype(np.int16))
            errs.append((float(e.mean()), int(e.max())))
        digests[path] = digest(got)
    worst_mean = max(m for m, _ in errs)
    worst_max = max(x for _, x in errs)
    log(f"decode_image over the tree: {1e3 * np.mean(times['.jpg']):.1f} ms "
        f"per 256 px JPEG photo ({len(times['.jpg'])}), "
        f"{1e3 * np.mean(times['.png']):.1f} ms per 256 px PNG sketch "
        f"({len(times['.png'])}), one host thread; photos against their "
        f"written pixels: worst mean |error| {worst_mean:.2f} (limit "
        f"{DISK_JPEG_MEAN_ERR}), largest |error| {worst_max} (limit "
        f"{DISK_JPEG_MAX_ERR}); sketches exact")
    assert worst_mean <= DISK_JPEG_MEAN_ERR and worst_max <= DISK_JPEG_MAX_ERR
    r = subprocess.run([sys.executable, "-c", PIL_DIGESTS, *sorted(digests)],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        log("PIL cross-check skipped: PIL does not import here ("
            f"{(r.stderr.strip().splitlines() or ['?'])[-1][:120]})")
        return digests
    pil = json.loads(r.stdout.strip().splitlines()[-1])
    agree = sum(pil[p] == d for p, d in digests.items())
    log(f"PIL cross-check: {agree} of {len(digests)} files decode bit for "
        "bit as PIL decodes them")
    assert agree == len(digests), "a file decodes unlike PIL"
    return digests


def disk_phase(card: str) -> dict:
    """Phase 10: training from disk through the CLIs users run, in this
    process (``build_parser().parse_args([...])`` -> ``run``): the tree,
    ``cli.data_split``, ``cli.train`` (T3 on efficientnet_b3a) and
    ``cli.find_lr`` (rexnet_150), with the opt-in depthwise kernels, and
    phase 14 (a) on the train run's directory. Returns the launches of
    kernels 5-10 in the train run (by C entry for the image kernels), of
    kernels 9-10 in the sweep and of kernel 1 in 14 (a)."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="disk_phase_")
    try:
        tree = os.path.join(root, "sketchy")
        t0 = time.perf_counter()
        written = write_disk_tree(tree)
        n_jpg = sum(p.endswith(".jpg") for p in written)
        log(f"disk tree: make_sketchy_tree({DISK_TREE}) wrote {n_jpg} JPEG "
            f"photos and {len(written) - n_jpg} PNG sketches in "
            f"{time.perf_counter() - t0:.1f} s (the port's own writers)")
        digests = disk_decode_checks(written)

        split = os.path.join(root, "split.json")
        SPLIT_CLI.run(SPLIT_CLI.build_parser().parse_args([
            "--data_dir", tree, "--out_path", split, "--layout", "sketchy",
            "--policy", "prod", "--seed", "42"]))
        with open(split) as f:
            sizes = {k: len(v) for k, v in json.load(f).items()}
        log(f"cli.data_split --layout sketchy --policy prod: {sizes}")
        assert sizes == DISK_SPLIT, sizes

        train = train_cli_run(tree, split, root, card)
        multihost = multihost_cli_run(tree, split, root, train["epoch0"],
                                      card)
        convert = convert_cli_run(train["run_dir"], written, root, card)
        sweep = find_lr_cli_run(tree, split, card)
        decode_pool_checks(tree, split, root, digests, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        set_opt_in(False)
    log(f"phase 10 (training from disk): "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    return {"train": train, "sweep": sweep, "multihost": multihost,
            "convert": convert}


def timed_loader_iter(waits: list):
    """TripletLoader.__iter__ that records the consumer's wait for each
    batch (host clock)."""
    def wrap(orig):
        def __iter__(self):
            it = orig(self)
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    waits.append(time.perf_counter() - t0)
                    yield batch
            finally:
                it.close()
        return __iter__
    return wrap


def train_cli_run(tree: str, split: str, root: str, card: str) -> dict:
    """``cli.train --recipe train_efficient_cos_con_ce_loss`` for 2 epochs
    with the opt-in: launch counts, the run's files, the last checkpoint
    read back, and where the time goes."""
    set_opt_in(True)
    save = os.path.join(root, "models")
    argv = ["--recipe", "train_efficient_cos_con_ce_loss", "-ip", tree,
            "--split_json", split, "-bs", str(DISK_BATCH), "--max_epochs",
            str(DISK_EPOCHS), "--cache", "--host_size", "256", "-sp", save]
    fills, epochs, waits, trainers = [], [], [], []

    def time_fill(orig):
        def fill(self, *a, **kw):
            t0 = time.perf_counter()
            orig(self, *a, **kw)
            fills.append((time.perf_counter() - t0, len(self._cache)))
        return fill

    def time_epoch(orig):
        def train_epoch(self, state, epoch):
            trainers.append(self)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = len(waits)
            a.record()
            out = orig(self, state, epoch)
            b.record()
            torch.cuda.synchronize()
            epochs.append((time.perf_counter() - t0, a.elapsed_time(b) / 1e3,
                           sum(waits[n:])))
            return out
        return train_epoch

    plain_before = (dict(DW.PLAIN_ON_CARD), dict(IK.PLAIN_ON_CARD))
    for mod in (DW, IK):
        mod.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        for owner, name, wrap in (
                (DecodeCacheMixin, "_init_decode_cache", time_fill),
                (Trainer, "train_epoch", time_epoch),
                (TripletLoader, "__iter__", timed_loader_iter(waits))):
            stack.enter_context(patched(owner, name, wrap))
        (state, history), ms = sync_time(
            lambda: TRAIN_CLI.run(TRAIN_CLI.build_parser().parse_args(argv)))
    counts = {"dw": dict(DW.KERNEL_LAUNCHES), "image": dict(IK.KERNEL_LAUNCHES),
              "entry": dict(IK.ENTRY_LAUNCHES),
              "copies": dict(DW.LAYOUT_COPIES)}
    peak = torch.cuda.max_memory_allocated() / 1e9
    steps = DISK_EPOCHS * DISK_STEPS
    val = DISK_EPOCHS * DISK_VAL_BATCHES
    n = B3A_DW_LAYERS
    want_dw = {"depthwise_conv_forward": n * (steps + val),
               "depthwise_conv_grad_x": n * steps,
               "depthwise_conv_grad_w": n * steps}
    want_image = {k: steps * 3 * p for k, p in launches_per_policy().items()}
    log(f"cli.train T3 ({' '.join(argv)}): {ms / 1e3:.1f} s; state.step "
        f"{state.step}; launches {counts}; expected depthwise {want_dw} "
        f"({n} layers x (train steps {steps} + val batches {val}), x train "
        f"steps), image kernels {want_image} (train steps x 3 roles x per "
        "policy call)")
    assert state.step == steps and len(history["epochs"]) == DISK_EPOCHS
    assert counts["dw"] == want_dw, counts
    assert counts["image"] == want_image, counts
    assert (dict(DW.PLAIN_ON_CARD), dict(IK.PLAIN_ON_CARD)) == plain_before
    assert counts["copies"] == {"nhwc": 0}, counts
    ckpt = os.path.join(save, "efficientnet_b3a_Adam_0.0047863")
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert os.path.isfile(os.path.join(ckpt, "hparams.yaml"))
    assert all(np.isfinite(v) for r in recs for v in r.values())
    assert os.listdir(os.path.join(ckpt, "last")) == [str(steps)]
    assert os.listdir(os.path.join(ckpt, "best")), "no best checkpoint"
    last_epoch = history["epochs"][-1]
    log(f"  files: hparams.yaml, metrics.jsonl ({len(recs)} records), "
        f"best/{os.listdir(os.path.join(ckpt, 'best'))}, last/{steps}; "
        f"last epoch train_loss {last_epoch['train_loss']:.5g}, val_loss "
        f"{last_epoch['val_loss']:.5g}, cos_sims {last_epoch['cos_sims']:.5g}")

    # the last checkpoint read back by load_checkpoint embeds as the
    # in-memory final state does, bit for bit
    only_last = os.path.join(root, "only_last")
    os.makedirs(only_last)
    os.symlink(os.path.join(ckpt, "last"), os.path.join(only_last, "last"))
    loaded = load_checkpoint(only_last, create_model(
        "efficientnet_b3a", num_classes=DISK_TREE["n_cats"], seed=SEED + 10))
    rng = np.random.default_rng(SEED + 10)
    four = torch.from_numpy(rng.integers(0, 256, (4, 256, 256, 3),
                                         dtype=np.uint8)).to(DEV)
    x = build_eval_transform("plain", SIZE)(four)
    final = state.model.eval()
    with torch.no_grad():
        a, b = final.embed(x.float()), loaded.eval().embed(x.float())
    assert torch.equal(a, b), (a - b).abs().max().item()
    log("  last/ checkpoint read back by models.convert.load_checkpoint: 4 "
        "images embed bit for bit as the in-memory final state")

    # where the time goes: the cache fill, each epoch's wall and CUDA
    # events and the loader's wait; a warm epoch profiled for the idle
    # share; the loader's wait on uncached steps (decode in the loop)
    for e, (wall, ev, wait) in enumerate(epochs):
        log(f"  epoch {e}: {1e3 * wall / DISK_STEPS:.1f} ms wall, "
            f"{1e3 * ev / DISK_STEPS:.1f} ms CUDA events per train step "
            f"(epoch of {DISK_STEPS} steps + {DISK_VAL_BATCHES} val batch "
            f"outside it), loader wait {1e3 * wait / DISK_STEPS:.1f} ms per "
            f"step{' (first use, includes warm-up)' if e == 0 else ''}")
    trainer = trainers[-1]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, pwall = sync_time(lambda: trainer.train_epoch(state, DISK_EPOCHS))
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    idle = 1 - busy / pwall
    log(f"  profiled warm epoch: {pwall / DISK_STEPS:.1f} ms wall per step, "
        f"{busy / DISK_STEPS:.1f} ms device busy; idle share {idle:.3f}")
    host = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    host.sort(key=lambda e: -e.self_cpu_time_total)
    log("  top host ops by self time: " + "; ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.1f} ms x{e.count}"
        for e in host[:8]))

    args = TRAIN_CLI.build_parser().parse_args(argv)
    args.cache = False
    cfg = TRAIN_CLI.build_config(args, vars(
        TRAIN_CLI.build_parser().parse_args([])))
    uncached = TRAIN_CLI.build_loader(
        cfg, args, TRAIN_CLI.build_dataset(cfg, args, "train"))
    uwaits = []
    with patched(TripletLoader, "__iter__", timed_loader_iter(uwaits)):
        it = iter(uncached)
        tgen, dgen = trainer._generators(0)
        for _ in range(DISK_UNCACHED_STEPS):
            batch = trainer._prepare(trainer.transform(next(it), tgen))
            trainer._train_step(state, batch, dgen)
        torch.cuda.synchronize()
        it.close()
    log(f"  cache fill (--cache, decode once per dataset): "
        + ", ".join(f"{t:.1f} s for {k} files" for t, k in fills)
        + " (the train and val datasets); uncached loader wait per step over "
        f"{DISK_UNCACHED_STEPS} steps: "
        f"{', '.join(f'{1e3 * w:.0f}' for w in uwaits)} ms (each step "
        f"decodes {3 * DISK_BATCH} files with {cfg.num_workers} loader "
        "threads; the Huffman walk holds the GIL)")
    log(f"  peak device memory {peak:.2f} GB; {card}")
    return {"dw": counts["dw"], "entry": counts["entry"],
            "epoch0": history["epochs"][0], "run_dir": ckpt}


def multihost_cli_run(tree: str, split: str, root: str, ref: dict,
                      card: str) -> dict:
    """Phase 13 (d), run here while phase 10's tree exists: ``cli.train``
    over the multi-host flags at world size 1 (``--coordinator_address
    localhost:<port> --num_processes 1 --process_id 0``: one process, an
    NCCL group of one, the model in DDP), one epoch of phase 10's run,
    against that run's first epoch; launch counts set to 0 just before
    and read just after."""
    set_opt_in(True)
    argv = ["--recipe", "train_efficient_cos_con_ce_loss", "-ip", tree,
            "--split_json", split, "-bs", str(DISK_BATCH), "--max_epochs",
            "1", "--cache", "--host_size", "256", "-sp",
            os.path.join(root, "multihost"), "--coordinator_address",
            f"localhost:{distributed.free_port()}", "--num_processes", "1",
            "--process_id", "0"]
    wrapped = []

    def record(orig):
        def train_epoch(self, state, epoch):
            wrapped.append(type(self.model).__name__)
            return orig(self, state, epoch)
        return train_epoch

    for mod in (DW, IK):
        mod.reset_launch_counts()
    with patched(Trainer, "train_epoch", record):
        (state, history), ms = sync_time(lambda: TRAIN_CLI.run(
            TRAIN_CLI.build_parser().parse_args(argv)))
    counts = {**DW.KERNEL_LAUNCHES, **IK.KERNEL_LAUNCHES}
    assert not distributed.in_group(), "the CLI left its group running"
    assert wrapped == ["DistributedDataParallel"], wrapped
    n = B3A_DW_LAYERS
    want = {"depthwise_conv_forward": n * (DISK_STEPS + DISK_VAL_BATCHES),
            "depthwise_conv_grad_x": n * DISK_STEPS,
            "depthwise_conv_grad_w": n * DISK_STEPS,
            **{k: DISK_STEPS * 3 * p
               for k, p in launches_per_policy().items()}}
    assert counts == want, (counts, want)
    got = history["epochs"][0]
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    rel = {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-12) for k in ref}
    log(f"13 (d) cli.train over the multi-host flags, world size 1 (NCCL, "
        f"DDP), 1 epoch of phase 10's run ({DISK_STEPS} steps of "
        f"{DISK_BATCH} triplets + {DISK_VAL_BATCHES} val batch): "
        f"{ms / 1e3:.1f} s; launches {counts}; against phase 10's first "
        f"epoch: {'bit for bit' if got == ref else 'not bit for bit'}, "
        f"relative differences {rel}; limit {MD_CLI_RTOL} on train_loss, "
        f"val_loss, cos_sims; {card}")
    for k in ("train_loss", "val_loss", "cos_sims"):
        assert rel[k] <= MD_CLI_RTOL, (k, rel[k])
    set_opt_in(False)
    return {"launches": counts, "bitwise": got == ref}


def find_lr_cli_run(tree: str, split: str, card: str) -> dict:
    """``cli.find_lr --recipe find_lr`` (rexnet_150) with the opt-in: a
    finite suggestion inside the range from at least 3 losses, 16 + 16 +
    16 depthwise launches per sweep step, the ms per step."""
    set_opt_in(True)
    argv = ["--recipe", "find_lr", "-ip", tree, "--split_json", split, "-bs",
            str(DISK_BATCH), "--num_lr_steps", str(DISK_LR_STEPS), "--cache",
            "--host_size", "256"]
    step_s = []

    def time_steps(orig):
        def lr_find(make_state, train_step, *a, **kw):
            def timed(state, batch, gen):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = train_step(state, batch, gen)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                return out
            return orig(make_state, timed, *a, **kw)
        return lr_find

    args = FIND_LR_CLI.build_parser().parse_args(argv)
    DW.reset_launch_counts()
    plain_before = dict(DW.PLAIN_ON_CARD)
    with patched(lr_finder, "lr_find", time_steps):
        out, ms = sync_time(lambda: FIND_LR_CLI.run(args))
    counts = dict(DW.KERNEL_LAUNCHES)
    n, taken = REXNET_DW_LAYERS, len(step_s)
    want = {k: n * taken for k in counts}
    s, losses = out["suggestion"], out["losses"]
    log(f"cli.find_lr ({' '.join(argv)}): {ms / 1e3:.1f} s; {taken} sweep "
        f"steps, {len(losses)} losses recorded, suggestion {s}; launches "
        f"{counts} (expected {want}); sweep step "
        f"{1e3 * np.median(step_s[1:]):.1f} ms median wall (host clock, "
        f"synchronised; first {1e3 * step_s[0]:.0f} ms); {card}")
    assert s is not None and np.isfinite(s), s
    # exp(linspace(log)) may leave [min_lr, max_lr] by rounding
    assert (args.min_lr * (1 - 1e-12) <= s <= args.max_lr * (1 + 1e-12)), s
    assert len(losses) >= 3 and np.all(np.isfinite(losses)), losses
    assert counts == want, counts
    assert dict(DW.PLAIN_ON_CARD) == plain_before
    return counts


@contextlib.contextmanager
def recorded_pools():
    """Every ``DecodePool`` started inside the block, in a list; on the
    way out, wait (up to 60 s) until each has stopped its processes (a
    loader closes its pool in its producer thread)."""
    made = []

    class Recorded(NL.DecodePool):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    with patched(NL, "DecodePool", lambda orig: Recorded):
        yield made
    t0 = time.perf_counter()
    while any(p._procs for p in made):
        assert time.perf_counter() - t0 < 60, "a decode pool did not stop"
        time.sleep(0.05)


def loader_steps(loader, steps: int | None = None) -> tuple[list, list]:
    """The first ``steps`` batches of a pass (all by default) and the
    consumer's wait for each (host clock); the pass is closed after."""
    waits: list = []
    with patched(TripletLoader, "__iter__", timed_loader_iter(waits)):
        it = iter(loader)
        batches = [b for _, b in zip(range(steps or len(loader)), it)]
        it.close()
    return batches, waits


def same_batches(a: list, b: list) -> bool:
    def flat(batch):
        return [batch["qry"], *batch["pos"], *batch["neg"],
                batch["cat_idx"], batch["prod_idx"]]
    return len(a) == len(b) and all(
        np.array_equal(x, y) for p, q in zip(a, b)
        for x, y in zip(flat(p), flat(q)))


def decode_pool_checks(tree: str, split: str, root: str, digests: dict,
                       card: str) -> None:
    """The decode pool (``data.native_loader``, the counterpart of JAX's
    C++ loader): the tree's files at 1 and ``os.cpu_count()`` processes
    (start-up and fill times, every worker used, each image's digest the
    in-process decode's); the uncached train loader with ``use_native``
    (its wait per step at 1 process, and over an epoch at cpu_count,
    whose batches equal the threaded loader's epoch bit for bit, that
    loader reading the in-process decodes from its dataset's cache); then
    ``cli.train --use_native_loader`` for one epoch, each batch from the
    pool."""
    paths = sorted(digests)
    n_max = os.cpu_count() or 1
    assert NL.native_available(), "the decode pool does not start here"
    decoded = {}
    for n in (1, n_max):
        t0 = time.perf_counter()
        pool = NL.DecodePool(n).start()
        start_s = time.perf_counter() - t0
        try:
            t0 = time.perf_counter()
            out = NL.decode_resize_batch(paths, DISK_TREE["size"],
                                         DISK_TREE["size"], strict=True,
                                         pool=pool)
            fill_s = time.perf_counter() - t0
            used = len(pool.pids)
        finally:
            pool.close()
        assert used == n, (n, used)
        assert all(digest(img) == digests[p] for p, img in zip(paths, out))
        decoded = dict(zip(paths, out))
        log(f"decode pool of {n} process{'es' if n > 1 else ''}: start-up "
            f"{start_s:.2f} s, {len(paths)} files decoded in {fill_s:.2f} s "
            f"({1e3 * fill_s / len(paths):.1f} ms a file; every worker "
            f"used); each image bit for bit the in-process decode_image; "
            f"{card}")

    argv = ["--recipe", "train_efficient_cos_con_ce_loss", "-ip", tree,
            "--split_json", split, "-bs", str(DISK_BATCH), "--host_size",
            "256"]
    args = TRAIN_CLI.build_parser().parse_args(argv)
    cfg = TRAIN_CLI.build_config(args, vars(
        TRAIN_CLI.build_parser().parse_args([])))
    ds = TRAIN_CLI.build_dataset(cfg, args, "train")
    # the threaded loader's epoch from a twin dataset whose decode cache
    # holds every file's in-process decode (the pool's images, each checked
    # against decode_image's digest above): its pixels without its
    # decodes, which took 4-5 s a step here on 8 threads
    twin = TRAIN_CLI.build_dataset(cfg, args, "train")
    assert set(twin.image_lst) | set(twin.sketch_lst) <= set(decoded)
    twin._cache.update(decoded)
    ref, _ = loader_steps(TRAIN_CLI.build_loader(cfg, args, twin))
    args.use_native_loader = True
    waits = {}
    for n, steps in ((1, DISK_UNCACHED_STEPS), (n_max, None)):
        with recorded_pools() as made:
            loader = TRAIN_CLI.build_loader(
                dataclasses.replace(cfg, num_workers=n), args, ds)
            assert loader.use_native
            got, waits[n] = loader_steps(loader, steps)
        assert len(made) == 1 and len(made[0].pids) == n, (n, made)
        if steps is None:
            assert same_batches(got, ref), "a use_native batch differs"
    log(f"  uncached train loader, loader wait per step (ms; {3 * DISK_BATCH}"
        f" files a step, no training between steps): use_native at 1 "
        "process "
        + ", ".join(f"{1e3 * w:.0f}" for w in waits[1])
        + f"; at {n_max} processes "
        + ", ".join(f"{1e3 * w:.0f}" for w in waits[n_max])
        + f" (the first wait includes the pool's start-up); the "
        f"{len(ref)} use_native batches at {n_max} processes equal the "
        f"threaded loader's epoch bit for bit; {card}")

    save = os.path.join(root, "models_native")
    argv_cli = argv + ["--max_epochs", "1", "--use_native_loader", "-sp",
                       save]
    native = []

    def count(orig):
        def _native_batch(self, indices, pool):
            native.append(len(indices))
            return orig(self, indices, pool)
        return _native_batch

    with recorded_pools() as made, \
            patched(TripletLoader, "_native_batch", count):
        (state, history), ms = sync_time(lambda: TRAIN_CLI.run(
            TRAIN_CLI.build_parser().parse_args(argv_cli)))
    assert state.step == DISK_STEPS, state.step
    assert len(native) == DISK_STEPS + DISK_VAL_BATCHES, native
    # a pool starts its processes at its first batch: every pass that had
    # one used all of them
    used = [p for p in made if p.pids]
    assert len(used) == 1 + (DISK_VAL_BATCHES > 0) and all(
        len(p.pids) == p.size == cfg.num_workers for p in used), [
        (p.size, p.pids) for p in made]
    loss = history["epochs"][0]["train_loss"]
    assert np.isfinite(loss), loss
    log(f"cli.train {' '.join(argv_cli)}: {ms / 1e3:.1f} s; "
        f"{len(native)} batches from {len(used)} decode pools of "
        f"{cfg.num_workers} processes (train and val passes); train_loss "
        f"{loss:.5g}; {card}")


def matplotlib_report() -> bool:
    """Whether matplotlib imports on this machine (Agg backend), asked in
    a child process as ``codec_report`` asks of the codecs: a report of
    the machine, printed either way."""
    r = subprocess.run(
        [sys.executable, "-c", "import matplotlib; matplotlib.use('Agg'); "
         "import matplotlib.pyplot"], capture_output=True, text=True,
        timeout=300)
    if r.returncode == 0:
        log("matplotlib imports on this machine: the phase renders "
            "cli.inference's --viz_dir grids")
        return True
    log("matplotlib does not import on this machine ("
        f"{(r.stderr.strip().splitlines() or ['?'])[-1][:120]}): the "
        "phase runs no --viz_dir step")
    return False


def counters() -> tuple:
    """Every launch and plain-version counter of the port's kernels."""
    return (dict(R.KERNEL_LAUNCHES), dict(R.PLAIN_ON_CARD),
            dict(IK.KERNEL_LAUNCHES), dict(IK.PLAIN_ON_CARD),
            dict(DW.KERNEL_LAUNCHES), dict(DW.PLAIN_ON_CARD))


def inference_cli_run(argv: list, card: str) -> dict:
    """``cli.inference`` in this process with every launch count set to 0
    just before and read just after: its printed metric lines, results,
    launches, wall, cache fill, embed ms per batch and evaluation ms. Only
    kernel 1 may launch (once: the evaluation ranks Q = G = 264), and no
    plain version may run on the card."""
    plain_before = counters()[1::2]
    fills, embeds, evals, evaluated = [], [], [], []

    def time_fill(orig):
        def fill(self, *a, **kw):
            t0 = time.perf_counter()
            orig(self, *a, **kw)
            fills.append((time.perf_counter() - t0, len(self._cache)))
        return fill

    def time_into(store, args=None):
        def wrap(orig):
            def timed(self, *a, **kw):
                out, ms = sync_time(lambda: orig(self, *a, **kw))
                store.append(ms)
                if args is not None:
                    args.append(a[0])
                return out
            return timed
        return wrap

    for mod in (R, IK, DW):
        mod.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.ExitStack() as stack:
        for owner, name, wrap in (
                (DecodeCacheMixin, "_init_decode_cache", time_fill),
                (RetrievalEngine, "embed_batch", time_into(embeds)),
                (RetrievalEngine, "evaluate_class_dedup",
                 time_into(evals, evaluated)),
                (RetrievalEngine, "evaluate_index_match",
                 time_into(evals, evaluated))):
            stack.enter_context(patched(owner, name, wrap))
        stack.enter_context(contextlib.redirect_stdout(buf))
        results, ms = sync_time(lambda: INFER_CLI.run(
            INFER_CLI.build_parser().parse_args(argv)))
    counts = counters()
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith(("Test ", "Saved ", "Wrote ", "The dataset",
                               "Number of"))]
    for ln in lines:
        log(f"  | {ln}")
    # the CLI's printed lines are the results it returns
    for key in ("top1", "top3", "scores"):
        name = "cos sim scores" if key == "scores" else key
        assert f"Test {name}: {results[key]:.3f}" in lines, (key, lines)
    assert counts[0]["fused_cosine_topk"] == 1, counts[0]
    assert sum(counts[0].values()) == 1, counts[0]
    assert not any(counts[2].values()) and not any(counts[4].values())
    assert counts[1::2] == plain_before, (counts[1::2], plain_before)
    fill_s = sum(t for t, _ in fills)
    n_files = sum(n for _, n in fills)
    log(f"cli.inference {' '.join(argv[2:])}: {ms / 1e3:.2f} s wall (host "
        f"clock, synchronised), of it the cache fill {fill_s:.2f} s "
        f"({n_files} files decoded), {len(embeds)} embed_batch calls "
        f"(rexnet_150, {SIZE} px) {np.median(embeds):.1f} ms median, "
        f"{sum(embeds):.0f} ms in all, the evaluation {evals[0]:.1f} ms; "
        f"launches {counts[0]}, no plain version on the card; {card}")
    return {"results": results, "embeds": evaluated[0],
            "launches": counts[0]["fused_cosine_topk"]}


def dense_reference(model, fn: str, embeds: dict) -> dict:
    """``RetrievalEngine.<fn>`` on the CLI's own embeddings with
    ``cosine_topk(method='dense')`` (true f32, TF32 off) in place of the
    fused kernel."""
    dense = lambda f: functools.partial(f, method="dense")  # noqa: E731
    with patched(ENGINE, "cosine_topk", dense):
        return getattr(RetrievalEngine(model), fn)(embeds)


def held_to_dense(got: dict, ref: dict, what: str) -> int:
    """The kernel's evaluation against the dense one: deduplicated values
    within EVAL_TIE_ATOL, top classes differing only in rows where they
    do, top1 / top3 within those rows' share; returns the rows."""
    gv, rv = got["top_vals"], ref["top_vals"]
    both_inf = np.isneginf(gv) & np.isneginf(rv)
    gap = np.abs(np.where(both_inf, 0, gv - rv)).max()
    assert gap <= EVAL_TIE_ATOL, (what, gap)
    rows = int((got["top_r_list"] != ref["top_r_list"]).any(axis=1).sum())
    q = len(gv)
    for key in ("top1", "top3"):
        assert abs(got[key] - ref[key]) <= rows / q + 1e-12, (what, key)
    assert got["scores"] == ref["scores"], what
    log(f"  {what} against the dense path (true f32): top1 {got['top1']:.4f}"
        f" vs {ref['top1']:.4f}, top3 {got['top3']:.4f} vs {ref['top3']:.4f}"
        f", scores {got['scores']:.6f} equal; deduplicated values within "
        f"{gap:.2g} (limit {EVAL_TIE_ATOL}); {rows} of {q} queries rank "
        "their top classes otherwise (near-ties)")
    return rows


def index_match_to_dense(model, got: dict, embeds: dict) -> None:
    """index_match's loss and scores equal to the dense path's (no kernel
    computes them); its top1 / top3 (kernel 1 at k = 3) within the share
    of queries whose top-3 the kernel ranks otherwise than the dense path,
    each such row at a near-tie (values within EVAL_TIE_ATOL)."""
    ref = dense_reference(model, "evaluate_index_match", embeds)
    assert got["loss"] == ref["loss"] and got["scores"] == ref["scores"]
    q, g = (torch.as_tensor(embeds[k], device=DEV)
            for k in ("fms_ims_all", "fms_poss_all"))
    (kv, ki), (dv, di) = (R.cosine_topk(q, g, 3, method=m)
                          for m in ("fused", "dense"))
    gap = (kv - dv).abs().max().item()
    rows = int((ki != di).any(dim=1).sum())
    assert gap <= EVAL_TIE_ATOL, gap
    for key in ("top1", "top3"):
        assert abs(got[key] - ref[key]) <= rows / len(q) + 1e-12, key
    log(f"  index_match against the dense path: loss {got['loss']:.6f} and "
        f"scores equal, top1 {got['top1']:.4f} vs {ref['top1']:.4f}, top3 "
        f"{got['top3']:.4f} vs {ref['top3']:.4f}; the k = 3 values within "
        f"{gap:.2g}, {rows} of {len(q)} rows ranked otherwise (near-ties)")


def artifact_queries(npz: str, qpaths: list, card: str) -> dict:
    """``cli.gallery query`` of EVAL_QUERIES photos against the int8
    artifact ``cli.inference`` saved, in int8 (kernel 3) and float32
    (kernel 1), counts set to 0 just before each and read just after;
    records against the library path (near-tie rule) and their top-1
    classes."""
    library = library_path(npz, qpaths)
    launches = {}
    for mode in ("int8", "float32"):
        kernel = MODE_KERNELS[mode]
        plain_before = counters()[1::2]
        for mod in (R, IK, DW):
            mod.reset_launch_counts()
        recs, ms = cli_stdout(["query", npz, *qpaths, "-k", str(K),
                               "--num_unique", "3", "--matmul_dtype", mode])
        counts = counters()
        assert len(recs) == EVAL_QUERIES, len(recs)
        assert counts[0][kernel] == 1 and sum(counts[0].values()) == 1, (
            mode, counts[0])
        assert counts[1::2] == plain_before, mode
        launches[kernel] = counts[0][kernel]
        refs = library(mode)
        n_diff = near_tie_records(recs, refs, f"artifact query {mode}")
        top1 = sum(r["classes"][0] == f["classes"][0]
                   for r, f in zip(recs, refs))
        assert top1 >= EVAL_QUERIES - n_diff, (mode, top1, n_diff)
        log(f"cli.gallery query of {EVAL_QUERIES} photos against the "
            f"cli.inference int8 artifact, --matmul_dtype {mode}: "
            f"{ms:.0f} ms wall; launches {counts[0]}; top-1 class equal to "
            f"the library path's for {top1} of {EVAL_QUERIES}, {n_diff} "
            f"records differ, all at near-ties; {card}")
    return launches


def gradcam_checks(xs: torch.Tensor, ps: torch.Tensor, card: str) -> None:
    """``grad_cam_pair`` (against each query's positive sketch) and
    ``grad_cam_class`` on the card for CAM_N queries, against the same
    weights' maps on the CPU from the same inputs."""
    cls = torch.arange(CAM_N)
    for name in CAM_MODELS:
        model = create_model(name, num_classes=EVAL_TREE["n_cats"],
                             seed=SEED)
        cpu = copy.deepcopy(model).to("cpu")
        with torch.no_grad():
            ref = model.embed(ps)
        cams = [lambda m, x, r: grad_cam_pair(m, x, r),
                lambda m, x, r: grad_cam_class(m, x, cls)]
        errs, warm = [], []
        for cam in cams:
            cam(model, xs, ref)                         # warm-up
            got, ms = sync_time(lambda: cam(model, xs, ref))
            want = cam(cpu, xs.cpu(), ref.cpu())
            assert got.shape == want.shape == (CAM_N, CAM_SIDE, CAM_SIDE)
            assert torch.isfinite(got).all()
            assert got.min() >= 0 and got.max() <= 1
            errs.append((got.cpu() - want).abs().max().item())
            warm.append(ms)
        log(f"[{name}] Grad-CAM of {CAM_N} queries at {SIZE} px "
            f"({CAM_SIDE} x {CAM_SIDE} maps): pair {warm[0]:.1f} ms, class "
            f"{warm[1]:.1f} ms warm on the card (host clock, synchronised); "
            f"against the CPU's largest |difference| {errs[0]:.3g} (pair), "
            f"{errs[1]:.3g} (class), limit {CAM_ATOL}; {card}")
        assert max(errs) <= CAM_ATOL, (name, errs)
        del model, cpu


def approx_check(index, q64, card: str) -> None:
    """``method='approx'`` on the served G = 100,000 gallery at Q = 64:
    the dense path (no kernel launch), indices and values equal to
    ``method='dense'``'s, recall 1.0 against the exact (fused) request;
    warm times of both."""
    R.reset_launch_counts()
    av, ai, _ = index.query(q64, k=K, method="approx")
    assert not any(R.KERNEL_LAUNCHES.values()), R.KERNEL_LAUNCHES
    dv, di, _ = index.query(q64, k=K, method="dense")
    assert np.array_equal(ai, di) and np.array_equal(av, dv)
    ev, ei, _ = index.query(q64, k=K)
    recall = np.mean([len(set(a) & set(e)) / K for a, e in zip(ai, ei)])
    assert np.abs(av - ev).max() <= 1e-5
    times = {}
    for method in ("approx", "exact"):
        ms = [sync_time(lambda: index.query(q64, k=K, method=method))[1]
              for _ in range(APPROX_REPS)]
        times[method] = float(np.median(ms))
    log(f"method='approx' at Q = 64 over G = {G_TOTAL:,} x {DIM}, k = {K}: "
        f"the dense path, no kernel launched; indices and values equal to "
        f"method='dense'; recall against exact (fused kernel 1) {recall:.4f} "
        f"(positions swapped only at near-ties; values within 1e-5); warm "
        f"GalleryIndex.query {times['approx']:.2f} ms against exact's "
        f"{times['exact']:.2f} ms (median of {APPROX_REPS}, host clock, "
        f"synchronised); {card}")


def analysis_phase(index, q64, card: str) -> dict:
    """Phase 11: evaluation and analysis from disk through the entry
    points users run. Returns kernel 1's launches in the two
    ``cli.inference`` runs and each kernel's launches in the artifact
    queries."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="eval_phase_")
    try:
        tree = os.path.join(root, "sketchy")
        t0 = time.perf_counter()
        SYN.make_sketchy_tree(tree, **EVAL_TREE)
        log(f"eval tree: make_sketchy_tree({EVAL_TREE}) in "
            f"{time.perf_counter() - t0:.1f} s")
        viz = os.path.join(root, "viz") if matplotlib_report() else None
        npz = os.path.join(root, "gallery_int8.npz")
        base = ["-ip", tree, "-bs", str(EVAL_BATCH), "--cache", "True"]
        cd = inference_cli_run(
            base + ["--save_gallery", npz, "--gallery_dtype", "int8"]
            + (["--viz_dir", viz] if viz else []), card)
        res = cd["results"]
        assert res["fms_ims_all"].shape == (EVAL_ITEMS, EVAL_DIM)
        assert np.isfinite(res["fms_ims_all"]).all()
        model = create_model("rexnet_150", num_classes=EVAL_TREE["n_cats"])
        held_to_dense(res, dense_reference(model, "evaluate_class_dedup",
                                           cd["embeds"]), "class_dedup")
        art = GalleryIndex.load(npz)
        assert len(art) == EVAL_ITEMS and art.meta["model"] == "rexnet_150"
        if viz:
            files = sorted(os.listdir(viz))
            assert files == [f"retrieval_{i:03d}.png" for i in range(8)]
            assert all(os.path.getsize(os.path.join(viz, f)) > 0
                       for f in files)
            log(f"  --viz_dir: {len(files)} grids written, none empty")
        im = inference_cli_run(base + ["--topk_variant", "index_match"], card)
        index_match_to_dense(model, im["results"], im["embeds"])
        del model

        photos = sorted(
            os.path.join(d, f) for d, _, fs in
            os.walk(os.path.join(tree, "photo")) for f in fs)
        qpaths = photos[::len(photos) // EVAL_QUERIES][:EVAL_QUERIES]
        queries = artifact_queries(npz, qpaths, card)

        tfm = build_eval_transform("squarepad", SIZE)
        sketches = [p.replace("/photo/", "/sketch/").rsplit("-", 1)[0]
                    + "-0.png" for p in qpaths[:CAM_N]]
        xs = tfm(np.stack([decode_image(p) for p in qpaths[:CAM_N]]))
        ps = tfm(np.stack([decode_image(p) for p in sketches]))
        gradcam_checks(xs, ps, card)
        approx_check(index, q64, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 11 (evaluation and analysis from disk): "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    return {"class_dedup": cd["launches"], "index_match": im["launches"],
            "artifact_query": queries}


def sharded_request(index, q64, mode: str, mesh, card: str, tag: str
                    ) -> int:
    """A Q = 64 request of ``mode`` over ``mesh`` through
    ``GalleryIndex.query_class_dedup(mesh=...)``, counts set to 0 just
    before and read just after: one launch of the mode's kernel per shard,
    nothing else, no row sent to the certificate repair; its dedup and
    its top-k bitwise the unsharded request's; then the warm times of
    both (median of SHARD_REPS, in turns). Returns the launches."""
    r, name = mesh.shape["data"], MODE_KERNELS[mode]
    kw = dict(k=K, matmul_dtype=mode)
    form, t_up = sync_time(lambda: index._gallery_on_device(mode, mesh))
    bad = []

    def count_bad(orig):
        def repair(q_hat, gallery, k, vals, inds, ok, **rkw):
            bad.append(int((ok == 0).sum()))
            return orig(q_hat, gallery, k, vals, inds, ok, **rkw)
        return repair

    R.reset_launch_counts()
    plain_before = dict(R.PLAIN_ON_CARD)
    with patched(R, "certified_topk_repair", count_bad):
        got = index.query_class_dedup(q64, num_unique=3, mesh=mesh, **kw)
    counts = dict(R.KERNEL_LAUNCHES)
    assert counts[name] == r and sum(counts.values()) == r, (tag, counts)
    assert dict(R.PLAIN_ON_CARD) == plain_before
    assert bad == [0] * r, (tag, bad)
    want = index.query_class_dedup(q64, num_unique=3, **kw)
    sv, si, _ = index.query(q64, mesh=mesh, **kw)
    uv, ui, _ = index.query(q64, **kw)
    if mode == "float32":
        norms = torch.cat(form[1].shards)[:len(index)]
        same_norms = torch.equal(norms, index._gallery_on_device(mode)[1])
    else:
        same_norms = True
    if not (np.array_equal(sv, uv) and np.array_equal(si, ui)
            and all(np.array_equal(a, b) for a, b in zip(got, want))):
        log(f"MISMATCH {tag}: top-k positions differing "
            f"{int((si != ui).sum())}, largest |value difference| "
            f"{float(np.abs(sv - uv).max()):.3g}, dedup equal "
            f"{[np.array_equal(a, b) for a, b in zip(got, want)]}, norms "
            f"equal {same_norms}")
        raise AssertionError(f"{tag}: the sharded request is not the "
                             "unsharded one bit for bit")
    assert same_norms, tag
    ts, tu = [], []
    for _ in range(SHARD_REPS):
        tu.append(sync_time(lambda: index.query_class_dedup(
            q64, num_unique=3, **kw))[1])
        ts.append(sync_time(lambda: index.query_class_dedup(
            q64, num_unique=3, mesh=mesh, **kw))[1])
    mb = sum(sh.numel() * sh.element_size() for t in form
             for sh in t.shards) / 1e6
    log(f"sharded {tag}: {mode} over {r} shard{'s' if r > 1 else ''} of "
        f"{form[0].shards[0].shape[0]:,} rows (G = {len(index):,}, padded "
        f"to {form[0].shape[0]:,}): {r} launch{'es' if r > 1 else ''} of "
        f"{name}, no repair; dedup and top-{K} bit for bit the unsharded "
        f"request's; warm request {np.median(ts):.3f} ms against unsharded "
        f"{np.median(tu):.3f} ms (query_class_dedup, Q = 64, host clock, "
        f"synchronised, median of {SHARD_REPS} in turns); shards made in "
        f"{t_up:.0f} ms, {mb:.1f} MB resident; {card}")
    return counts[name]


def sharded_phase(index, q64, card: str) -> dict:
    """Phase 12: sharded retrieval over the phase 2 gallery, on one card:
    ``Mesh(["cuda:0"] * R)`` for R in SHARDS and each mode, a ragged
    gallery (G = 100,003) over RAGGED_R shards, and ``make_mesh()`` once.
    Returns each kernel's launches per case."""
    t_phase = time.perf_counter()
    out = {MODE_KERNELS[m]: {} for m in SHARD_MODES}
    for r in SHARDS:
        mesh = Mesh(["cuda:0"] * r)
        for mode in SHARD_MODES:
            out[MODE_KERNELS[mode]][f"R{r}"] = sharded_request(
                index, q64, mode, mesh, card, f"R={r} {mode}")
    rng = np.random.default_rng(SEED + 12)
    extra = rng.normal(size=(RAGGED_EXTRA, DIM)).astype(np.float32)
    ragged = GalleryIndex(DIM).add(index.embeddings, index.classes).add(
        extra, rng.integers(0, 1000, RAGGED_EXTRA))
    mesh = Mesh(["cuda:0"] * RAGGED_R)
    assert (-len(ragged)) % RAGGED_R == 5
    for mode in SHARD_MODES:
        out[MODE_KERNELS[mode]][f"R{RAGGED_R}_ragged"] = sharded_request(
            ragged, q64, mode, mesh, card, f"ragged R={RAGGED_R} {mode}")
    del ragged
    mesh = make_mesh()
    if mesh.shape["data"] > 1:     # more cards visible: drive the first
        mesh = make_mesh(1)
    assert mesh.shape == {"data": 1}, mesh
    out["fused_cosine_topk"]["make_mesh"] = sharded_request(
        index, q64, "float32", mesh, card, "make_mesh() float32")
    log(f"phase 12 (sharded retrieval): {time.perf_counter() - t_phase:.1f}"
        f" s; {card}")
    return out


def md_config(**kw):
    return run_config(T3, None, compute_dtype="float32",
                      optimizer_name="SGD", **kw)


def md_batch() -> dict:
    """Phase 6's first train batch: the same seeded generator, drawn in
    the same order."""
    return MemoryLoader(np.random.default_rng(SEED), 1, TRAIN_BATCH
                        ).batches[0]


def md_step(trainer: Trainer, raw: dict) -> dict:
    """One train step of ``trainer`` (the compared one; launch counts set
    to 0 just before and read just after), then a second, timed (host
    clock around a synchronised step); the state after the first."""
    set_opt_in(True)
    state = trainer.init_state()
    gens = trainer._generators(0)
    for mod in (DW, IK):
        mod.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    state, m = trainer.train_batch(state, raw, gens)
    counts = {**DW.KERNEL_LAUNCHES, **IK.KERNEL_LAUNCHES}
    entry = dict(IK.ENTRY_LAUNCHES)
    plain = {**DW.PLAIN_ON_CARD, **IK.PLAIN_ON_CARD}
    model = {k: v.detach().cpu() for k, v in
             state.state_dict()["model"].items()}
    _, step_ms = sync_time(lambda: trainer.train_batch(state, raw, gens))
    set_opt_in(False)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "model": model, "launches": counts, "entry": entry,
            "plain": plain,
            "step_ms": step_ms,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "wrapper": type(state.model).__name__}


def md_rank(payload: dict) -> dict:
    """A launched rank: the T3 step on this rank's rows in the payload's
    layout; rank 0 keeps the whole state, every rank its launches and
    times."""
    model = create_model(T3.model, num_classes=N_CLASSES, seed=SEED)
    out = md_step(Trainer(md_config(param_sharding=payload["layout"]),
                          model, [payload["raw"]]), payload["raw"])
    if distributed.rank() != 0:
        out["model"] = None
    return out


def md_nccl_probe(payload) -> None:
    torch.distributed.all_reduce(torch.ones(1, device="cuda"))


def md_compare(tag: str, got: dict, ref: dict, init: dict,
               phase: int = 13) -> bool:
    """``got``'s step against the reference step, by phase 13's limits;
    logs each difference (the worst tensors beside their updates from
    ``init``) under ``phase`` and returns whether all is bit for bit."""
    loss = abs(got["metrics"]["train_loss"] - ref["metrics"]["train_loss"]
               ) / abs(ref["metrics"]["train_loss"])
    worst_stat = 0.0
    params = []
    bitwise = got["metrics"] == ref["metrics"]
    diff2 = upd2 = 0.0
    for k, want in ref["model"].items():
        have = got["model"][k]
        bitwise &= torch.equal(have, want)
        if k.endswith("num_batches_tracked"):
            assert torch.equal(have, want), (tag, k)
            continue
        d = (have.double() - want.double()).abs()
        if k.endswith(("running_mean", "running_var")):
            worst_stat = max(worst_stat, (d / (MD_STAT_ATOL + MD_STAT_RTOL
                                               * want.double().abs())
                                          ).max().item())
            continue
        upd = (want.double() - init[k].double()).abs()
        diff2 += float(d.square().sum())
        upd2 += float(upd.square().sum())
        params.append(((d.max() / (MD_PARAM_TENSOR_SHARE * upd.max()
                                   + 1e-6)).item(), k, d.max().item(),
                       upd.max().item()))
    params.sort(reverse=True)
    norm = (diff2 / upd2) ** 0.5
    log(f"{phase} {tag}: train_loss "
        f"{got['metrics']['train_loss']:.7g} against "
        f"{ref['metrics']['train_loss']:.7g} (relative {loss:.3g}, limit "
        f"{MD_LOSS_RTOL}); the parameters' |diff| / |update| {norm:.3g} "
        f"(limit {MD_PARAM_NORM_RTOL}), the worst tensor at "
        f"{params[0][0]:.3g} of its limit ({MD_PARAM_TENSOR_SHARE} of its "
        f"largest update + 1e-6); BatchNorm running statistics at "
        f"{worst_stat:.3g} of theirs (rtol {MD_STAT_RTOL}, atol "
        f"{MD_STAT_ATOL}); top-3 / top-1 "
        f"{got['metrics']['train_top3']:.4f} / "
        f"{got['metrics']['train_top1']:.4f} against "
        f"{ref['metrics']['train_top3']:.4f} / "
        f"{ref['metrics']['train_top1']:.4f}; "
        f"{'bit for bit' if bitwise else 'not bit for bit'}")
    log("  worst tensors (share of the limit, name, max |diff|, max "
        "|update|): " + "; ".join(f"{r:.3g} {k} {dm:.3g} {um:.3g}"
                                  for r, k, dm, um in params[:4]))
    assert loss <= MD_LOSS_RTOL, (tag, loss)
    assert norm <= MD_PARAM_NORM_RTOL, (tag, norm)
    assert params[0][0] <= 1 and worst_stat <= 1, (tag, params[0],
                                                   worst_stat)
    for k in ("train_top3", "train_top1"):
        assert got["metrics"][k] == ref["metrics"][k], (tag, k)
    return bitwise


def group_bn_arithmetic(orig):
    """GroupBatchNorm2d taking its group path (the all-reduces, its own
    f32 arithmetic) at world size 1 too, in place of nn.BatchNorm2d's."""
    def forward(self, x):
        if not self.training:
            return orig(self, x)
        y, mean, var, n = GBN._GroupBatchNorm.apply(x, self.weight,
                                                    self.bias, self.eps,
                                                    self.group)
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            self.running_mean.mul_(1 - self.momentum).add_(
                mean, alpha=self.momentum)
            self.running_var.mul_(1 - self.momentum).add_(
                var * (n / (n - 1)), alpha=self.momentum)
        return y
    return forward


def md_launches_ok(tag: str, got: dict) -> None:
    """One step's launches: kernels 9 and 10 on each of b3a's depthwise
    layers, kernels 5-8 at phase 5's counts per policy call x 3 roles; no
    plain version on the card."""
    n = B3A_DW_LAYERS
    want = {"depthwise_conv_forward": n, "depthwise_conv_grad_x": n,
            "depthwise_conv_grad_w": n,
            **{k: 3 * p for k, p in launches_per_policy().items()}}
    assert got["launches"] == want, (tag, got["launches"], want)
    assert not any(got["plain"].values()), (tag, got["plain"])


def multidevice_phase(card: str, multihost: dict) -> dict:
    """Phase 13: multi-device training on the one card, each layout's T3
    step against the step on one card without a group (see MD_*): (a) DDP
    and (c) FSDP at world size 1 over NCCL in this process, (b) MD_RANKS
    ranks over gloo sharing card 0, launched as worker processes by the
    port's launcher; the NCCL refusal of two ranks on one card; (d) came
    from phase 10. Returns each rank's launches in (b)."""
    t_phase = time.perf_counter()
    raw = md_batch()
    init = {k: v.cpu() for k, v in create_model(
        T3.model, num_classes=N_CLASSES, seed=SEED).state_dict().items()}
    ref = md_step(Trainer(md_config(), create_model(
        T3.model, num_classes=N_CLASSES, seed=SEED), [raw]), raw)
    md_launches_ok("reference", ref)
    # the same step again: the card's own spread (cuDNN's weight-gradient
    # algorithms may sum in another order from run to run)
    again = md_step(Trainer(md_config(), create_model(
        T3.model, num_classes=N_CLASSES, seed=SEED), [raw]), raw)
    md_compare("the reference again", again, ref, init)
    log(f"13 reference: one T3 step (f32, SGD) of {TRAIN_BATCH} triplets on "
        f"one card without a group: warm step {ref['step_ms']:.1f} ms, peak "
        f"{ref['peak_gb']:.2f} GB; launches {ref['launches']}; {card}")

    distributed.init_group(
        world_size=1, rank=0, device="cuda:0",
        init_method=f"tcp://localhost:{distributed.free_port()}")
    try:
        results = {}
        for tag, layout in (("(a) DDP, world size 1, NCCL", "replicated"),
                            ("(c) FSDP, world size 1, NCCL", "fsdp")):
            trainer = Trainer(md_config(param_sharding=layout),
                              create_model(T3.model, num_classes=N_CLASSES,
                                           seed=SEED), [raw])
            got = md_step(trainer, raw)
            md_launches_ok(tag, got)
            if layout == "fsdp":
                constrain = {type(p).__name__
                             for p in trainer.model.parameters()}
                assert constrain == {"DTensor"}, constrain
            log(f"13 {tag} ({got['wrapper']}): warm step "
                f"{got['step_ms']:.1f} ms, peak {got['peak_gb']:.2f} GB; "
                f"{card}")
            results[tag] = md_compare(tag, got, ref, init)
        # what (b) differs by: the group-wide BatchNorm's arithmetic in
        # place of cuDNN's, on one rank (its f64 all-reduces over NCCL)
        with patched(GBN.GroupBatchNorm2d, "forward", group_bn_arithmetic):
            got = md_step(Trainer(md_config(), create_model(
                T3.model, num_classes=N_CLASSES, seed=SEED), [raw]), raw)
        md_compare("world size 1, the group-wide BatchNorm's own "
                   "arithmetic", got, ref, init)
    finally:
        distributed.destroy_group()

    def launched(tag, devices, backend=None, layout="replicated"):
        t0 = time.perf_counter()
        ranks = distributed.launch(
            "chip_smoke:md_rank", len(devices),
            {"raw": raw, "layout": layout}, devices=devices,
            backend=backend, timeout_s=600)
        wall = time.perf_counter() - t0
        for r, got in enumerate(ranks):
            md_launches_ok(f"{tag}, rank {r}", got)
            log(f"13 {tag}, rank {r} ({got['wrapper']}, "
                f"{TRAIN_BATCH // len(devices)} triplets): warm step "
                f"{got['step_ms']:.1f} ms against the reference's "
                f"{ref['step_ms']:.1f} ms, peak {got['peak_gb']:.2f} GB; "
                f"launches {got['launches']}; {card}")
            assert got["metrics"] == ranks[0]["metrics"], (tag, r)
        log(f"13 {tag}: the launch (fresh interpreters, import, build, "
            f"two steps) {wall:.1f} s")
        results[tag] = md_compare(tag, ranks[0], ref, init)
        return ranks

    ranks = launched(f"(b) {MD_RANKS} ranks over gloo sharing card 0",
                     ["cuda:0"] * MD_RANKS, "gloo")
    log("13 (b): gloo carried the all-reduces, all-gathers and broadcasts "
        "of CUDA tensors (no host copies in the port's code)")
    cards = torch.cuda.device_count()
    if cards > 1:   # a machine with more cards: one rank on each
        for layout in ("replicated", "fsdp"):
            launched(f"(e) {cards} ranks over NCCL, one per card, {layout}",
                     [f"cuda:{i}" for i in range(cards)], layout=layout)

    # (f) the path a user calls: Trainer.fit with FSDP outside a group
    # launches its workers, one per card (one here), and loads rank 0's
    # state. The workers unpickle the loader, so its class comes from
    # this file imported by name (not __main__): phase 6's first batch
    loader = importlib.import_module("chip_smoke").MemoryLoader(
        np.random.default_rng(SEED), 1, TRAIN_BATCH)
    set_opt_in(True)
    trainer = Trainer(md_config(param_sharding="fsdp", num_devices=cards,
                                max_epochs=1), create_model(
        T3.model, num_classes=N_CLASSES, seed=SEED), loader)
    (state, history), ms = sync_time(lambda: trainer.fit())
    set_opt_in(False)
    got = {"metrics": dict(history["epochs"][0]),
           "model": {k: v.cpu() for k, v in
                     state.state_dict()["model"].items()}}
    log(f"13 (f) Trainer(param_sharding='fsdp', num_devices={cards}).fit(), "
        f"one step: {ms / 1e3:.1f} s with the workers' start; {card}")
    results["(f)"] = md_compare(f"(f) Trainer.fit launching {cards} "
                                "FSDP worker(s)", got, ref, init)

    try:
        distributed.launch("chip_smoke:md_nccl_probe", MD_RANKS, None,
                           devices=["cuda:0"] * MD_RANKS, backend="nccl",
                           timeout_s=180)
    except RuntimeError as e:
        said = [line for line in str(e).splitlines()
                if any(w in line.lower() for w in ("invalid usage",
                                                   "duplicate gpu"))]
        assert said, str(e)
        log("13 NCCL refuses two ranks on one card, as expected: "
            + said[0].strip()[:200])
    else:
        raise AssertionError("NCCL ran two ranks on one card")
    log(f"13 (d) from phase 10: "
        f"{'bit for bit' if multihost['bitwise'] else 'within its limit'}")
    log(f"phase 13 (multi-device training): "
        f"{time.perf_counter() - t_phase:.1f} s; bit for bit: {results}; "
        f"{card}")
    return {"ranks": [{**got["launches"], **got["entry"]}
                      for got in ranks]}



def convert_cli_run(run_dir: str, written: dict, root: str,
                    card: str) -> dict:
    """Phase 14 (a), run inside phase 10 while its ``cli.train`` run
    directory exists: ``cli.convert --to torch --lightning_out`` of it,
    read by ``load_checkpoint`` into a fresh b3a on the card, then the
    file ``--to native`` and read again. The tree's files embed bit for
    bit through all three, and a class-dedup query of CONVERT_QUERIES of
    them over all of them ranks the same, each through kernel 1 (counts
    set to 0 just before the query and read just after). Returns kernel
    1's launches."""
    t_phase = time.perf_counter()
    n_cls = DISK_TREE["n_cats"]
    common = ["--model_name", "efficientnet_b3a", "--num_classes",
              str(n_cls)]
    exported = os.path.join(root, "exported.ckpt")
    native = os.path.join(root, "native")
    walls = {}

    def convert(tag: str, argv: list) -> None:
        _, ms = sync_time(lambda: CONVERT_CLI.main([*argv, *common]))
        walls[tag] = ms / 1e3

    convert("--to torch --lightning_out", [
        "--checkpoint", run_dir, "--out", exported, "--to", "torch",
        "--lightning_out"])
    convert("--to native", ["--checkpoint", exported, "--out", native])
    payload = torch.load(exported, map_location="cpu", weights_only=False)
    assert set(payload) == {"state_dict"} and all(
        k.startswith("model.") for k in payload["state_dict"])
    models = {src: load_checkpoint(src, create_model(
        "efficientnet_b3a", num_classes=n_cls, seed=SEED + 20 + i)).eval()
        for i, src in enumerate((run_dir, exported, native))}
    paths = sorted(written)
    t0 = time.perf_counter()
    pixels = NL.decode_resize_batch(paths, SIZE, SIZE,
                                     num_threads=CONVERT_DECODERS)
    decode_s = time.perf_counter() - t0
    names = sorted({os.path.basename(os.path.dirname(p)) for p in paths})
    classes = np.array([names.index(os.path.basename(os.path.dirname(p)))
                        for p in paths], np.int32)
    tf = build_eval_transform("plain", SIZE)
    embeds, ranked, launches = {}, {}, 0
    for src, model in models.items():
        with torch.no_grad():
            embeds[src] = torch.cat([
                model.embed(tf(torch.from_numpy(pixels[i:i + 64]).to(DEV)
                               ).float())
                for i in range(0, len(paths), 64)])
        index = GalleryIndex(DIM)
        index.add(embeds[src].cpu().numpy(), classes)
        R.reset_launch_counts()
        ranked[src] = index.query_class_dedup(
            embeds[src][:CONVERT_QUERIES], k=K, num_unique=3)
        counts = dict(R.KERNEL_LAUNCHES)
        assert counts["fused_cosine_topk"] == 1, counts
        assert sum(counts.values()) == 1, counts
        launches += 1
    ref = embeds[run_dir]
    assert torch.isfinite(ref).all() and ref.shape == (len(paths), DIM)
    for src in (exported, native):
        assert torch.equal(embeds[src], ref), (src, (
            embeds[src] - ref).abs().max().item())
        for got, want in zip(ranked[src], ranked[run_dir]):
            np.testing.assert_array_equal(got, want)
    log(f"14 (a) cli.convert of phase 10's run directory "
        f"({os.path.basename(run_dir)}): " + ", ".join(
            f"{tag} {t:.2f} s" for tag, t in walls.items())
        + f"; the run directory, the exported Lightning file and the "
        f"native directory read by load_checkpoint on the card embed the "
        f"tree's {len(paths)} files ({SIZE} px, decoded on "
        f"{CONVERT_DECODERS} processes in {decode_s:.1f} s) bit for bit, "
        f"and a Q = {CONVERT_QUERIES} class-dedup query (k = {K}, 3 "
        f"unique) over them ranks the same, kernel 1 once each "
        f"({launches} launches); {time.perf_counter() - t_phase:.1f} s; "
        f"{card}")
    return {"fused_cosine_topk": launches}


def hybrid_config(case: str):
    """b3a: phase 13's T3 config; swin: T4's recipe at HYBRID_SWIN_LR."""
    if case == "b3a":
        return run_config(T3._replace(batch=HYBRID_B3A_BATCH), None,
                          compute_dtype="float32", optimizer_name="SGD")
    return run_config(T4._replace(model=HYBRID_SWIN,
                                  batch=HYBRID_SWIN_BATCH), None,
                      compute_dtype="float32", optimizer_name="SGD",
                      model_name=HYBRID_SWIN, learning_rate=HYBRID_SWIN_LR)


def hybrid_raw(case: str) -> dict:
    """Phase 13's first batch, its first rows."""
    n = HYBRID_B3A_BATCH if case == "b3a" else HYBRID_SWIN_BATCH
    return {k: ([a[:n] for a in v] if isinstance(v, list) else v[:n])
            for k, v in md_batch().items()}


def hybrid_reference(case: str) -> dict:
    """The case's step on one card without a group (md_step)."""
    cfg = hybrid_config(case)
    raw = hybrid_raw(case)
    return md_step(Trainer(cfg, create_model(
        cfg.model_name, num_classes=N_CLASSES, seed=SEED), [raw]), raw)


def hybrid_step(mesh, case: str) -> dict:
    """The case's step on this rank of a (data, model) mesh, through the
    path a user calls: ``put_fsdp(mesh, model, axis_name="model")``,
    ``shard_batch``, the Trainer's transform with ``rows=mesh.rows_of``,
    ``build_train_step(cfg, schedule, mesh=mesh)``; launch counts set to
    0 just before the first step and read just after, a second step timed
    (as md_step). Every rank returns its launches, times and shards, rank
    0 the whole state."""
    cfg = hybrid_config(case)
    raw = hybrid_raw(case)
    dev = mesh.local_device
    model = create_model(cfg.model_name, num_classes=N_CLASSES, seed=SEED,
                         device=dev)
    put_fsdp(mesh, model, axis_name="model")
    n_model = mesh.shape["model"]
    shards = [(n, p.to_local().numel(), p.numel())
              for n, p in model.named_parameters()
              if fsdp_spec(p.shape, n_model, "model") != ()]
    assert shards and all(local == total // n_model
                          for _, local, total in shards), shards
    spec = (TransformSpec.train_autoaugment(cfg.image_size)
            if cfg.autoaugment else TransformSpec.train_plain(cfg.image_size))
    spec = dataclasses.replace(spec, dtype=cfg.compute_dtype)
    transform = build_triplet_transform(spec, spec, spec, device=dev)
    step = build_train_step(cfg, multistep_lr(
        cfg.learning_rate, cfg.milestones, cfg.lr_gamma, 1), mesh=mesh)
    state = TrainState(model, make_optimizer(
        cfg.optimizer_name, model.parameters(), cfg.learning_rate,
        cfg.weight_decay))
    tgen, dgen = (torch.Generator(device=dev).manual_seed(s)
                  for s in _generator_seeds(cfg.seed + 1000))

    def train_batch():
        local = shard_batch(mesh, raw)
        rows = mesh.rows_of(len(local["qry"]))
        batch = transform(local, tgen, rows=rows)
        batch = {k: (v.long() if k in ("cat_idx", "prod_idx") else v)
                 for k, v in batch.items()}
        return step(state, {**batch, "rows": rows}, dgen)

    set_opt_in(True)
    for mod in (DW, IK):
        mod.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    _, m = train_batch()
    counts = {**DW.KERNEL_LAUNCHES, **IK.KERNEL_LAUNCHES}
    entry = dict(IK.ENTRY_LAUNCHES)
    plain = {**DW.PLAIN_ON_CARD, **IK.PLAIN_ON_CARD}
    whole = {k: v.detach().cpu() for k, v in
             state.state_dict()["model"].items()}
    _, step_ms = sync_time(train_batch)
    set_opt_in(False)
    local_mb = sum(p.to_local().numel() * 4 for p in model.parameters())
    return {"metrics": {k: float(v) for k, v in m.items()},
            "model": whole if mesh.rank == 0 else None,
            "launches": counts, "entry": entry, "plain": plain,
            "step_ms": step_ms, "coords": mesh.coords,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "shards": len(shards), "local_mb": local_mb / 1e6,
            "whole_mb": sum(p.numel() * 4 for p in model.parameters()) / 1e6}


def hybrid_rank(payload: dict) -> dict:
    """A launched rank of phase 14: both cases on the group's (data,
    model) mesh of ``payload["shape"]``."""
    mesh = group_mesh(payload["shape"], HYBRID_AXES)
    return {case: hybrid_step(mesh, case) for case in ("b3a", "swin")}


def hybrid_checks(tag: str, ranks: list, refs: dict, inits: dict,
                  card: str) -> dict:
    """Each rank's steps against the one-card steps (md_compare), the
    ranks' metrics equal, b3a's kernels 5-10 in every rank; logs each
    rank's step, peak and shards. Returns whether each case is bit for
    bit."""
    out = {}
    for case in ("b3a", "swin"):
        for r, rank in enumerate(ranks):
            got = rank[case]
            if case == "b3a":
                md_launches_ok(f"14 {tag} b3a, rank {r}", got)
            else:
                assert not any(got["plain"].values()), (tag, got["plain"])
            assert got["metrics"] == ranks[0][case]["metrics"], (tag, r)
            log(f"14 {tag} {case}, rank {r} {got['coords']}: warm step "
                f"{got['step_ms']:.1f} ms against one card's "
                f"{refs[case]['step_ms']:.1f} ms, peak {got['peak_gb']:.2f} "
                f"GB; {got['shards']} large parameters at half their size "
                f"over 'model' ({got['local_mb']:.1f} of "
                f"{got['whole_mb']:.1f} MB of parameters held here); "
                f"launches {got['launches']}; {card}")
        out[case] = md_compare(f"{tag} {case}", ranks[0][case],
                               refs[case], inits[case], phase=14)
    return out


def hybrid_references(card: str) -> tuple[dict, dict]:
    """Each case's step on one card without a group, and its initial
    weights (on the host); the card's memory freed after."""
    refs, inits = {}, {}
    for case in ("b3a", "swin"):
        cfg = hybrid_config(case)
        inits[case] = {k: v.cpu() for k, v in create_model(
            cfg.model_name, num_classes=N_CLASSES, seed=SEED
        ).state_dict().items()}
        refs[case] = hybrid_reference(case)
        log(f"14 reference {case} ({cfg.model_name}, "
            f"{len(hybrid_raw(case)['qry'])} triplets, f32 SGD at lr "
            f"{cfg.learning_rate}) on one card without a group: warm step "
            f"{refs[case]['step_ms']:.1f} ms, peak "
            f"{refs[case]['peak_gb']:.2f} GB; {card}")
    md_launches_ok("14 reference b3a", refs["b3a"])
    gc.collect()
    torch.cuda.empty_cache()
    return refs, inits


def hybrid_four_cards(card: str, refs: dict | None = None,
                      inits: dict | None = None) -> dict | None:
    """Phase 14 (c)'s four-card stanza: (b)'s steps with one rank per
    card over NCCL, where four cards are visible (else a line says it did
    not run, and None). Alone: ``python -c "import chip_smoke as C;
    C.hybrid_four_cards(C.PF.card())"``."""
    cards = torch.cuda.device_count()
    if cards < 4:
        log(f"14 (c) the four-card stanza did NOT run: {cards} card(s) "
            "visible (python -c \"import chip_smoke as C; "
            "C.hybrid_four_cards(C.PF.card())\" on four cards runs it)")
        return None
    if refs is None:
        refs, inits = hybrid_references(card)
    t0 = time.perf_counter()
    four = distributed.launch(
        "chip_smoke:hybrid_rank", 4, {"shape": HYBRID_SHAPE},
        devices=[f"cuda:{i}" for i in range(4)], timeout_s=600)
    tag = f"(c) {HYBRID_SHAPE} over NCCL, one rank per card"
    log(f"14 {tag}: the launch {time.perf_counter() - t0:.1f} s")
    return hybrid_checks(tag, four, refs, inits, card)


def hybrid_phase(card: str) -> dict:
    """Phase 14 (b) and (c): the (data, model) layout's steps against
    the one-card steps (freed before the launch). Returns each rank's
    launches of kernels 5-10 in (b)'s b3a step."""
    t_phase = time.perf_counter()
    refs, inits = hybrid_references(card)
    results = {}

    t0 = time.perf_counter()
    ranks = distributed.launch(
        "chip_smoke:hybrid_rank", int(np.prod(HYBRID_SHAPE)),
        {"shape": HYBRID_SHAPE}, devices=["cuda:0"] * 4, backend="gloo",
        timeout_s=600)
    tag = f"(b) {HYBRID_SHAPE} over gloo, 4 ranks sharing card 0"
    log(f"14 {tag}: the launch (fresh interpreters, import, both cases' "
        f"two steps) {time.perf_counter() - t0:.1f} s")
    results["(b)"] = hybrid_checks(tag, ranks, refs, inits, card)

    distributed.init_group(
        world_size=1, rank=0, device="cuda:0",
        init_method=f"tcp://localhost:{distributed.free_port()}")
    try:
        mesh = group_mesh((1, 1), HYBRID_AXES)
        assert torch.distributed.get_backend(mesh.batch_group) == "nccl"
        got = hybrid_step(mesh, "b3a")
    finally:
        distributed.destroy_group()
    md_launches_ok("14 (c) (1, 1) NCCL", got)
    log(f"14 (c) (1, 1) mesh at world size 1 over NCCL (the 2-D DeviceMesh "
        f"and its sub-groups under NCCL), b3a: warm step "
        f"{got['step_ms']:.1f} ms, peak {got['peak_gb']:.2f} GB; {card}")
    results["(c)"] = md_compare("(c) (1, 1) NCCL b3a", got, refs["b3a"],
                                inits["b3a"], phase=14)
    results["(c) four cards"] = hybrid_four_cards(card, refs, inits)
    log(f"phase 14 (b), (c) (the 2-D hybrid layout): "
        f"{time.perf_counter() - t_phase:.1f} s; bit for bit: {results}; "
        f"{card}")
    return {"ranks": [{**rank["b3a"]["launches"], **rank["b3a"]["entry"]}
                      for rank in ranks]}


def main() -> None:
    card = torch.cuda.get_device_name(0)
    # 1. build
    log(f"card: {PF.card()}; {torch.cuda.device_count()} visible, this run "
        "drives card 0 only (phase 13's (e) and (f) take every visible "
        "card)")
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

    errs, unit_q = topk_checks(index, q_hat, gen)

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
    times = topk_times(index, q_hat, peaks)
    kernels = []
    for mode, (name, replaces) in KERNELS.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "imageretrievalresearch_tpu_torch/csrc/fused_topk.cu",
            "replaces": f"imageretrievalresearch_tpu/{replaces}",
            "launches": launches[name],
            "max_abs_err": errs[mode],
            **times[mode],
            "ms_by": "single call",
        })
    # the f32 library at one TF32 pass: lower precision, not the
    # yardstick; logged only
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        lib_call = (lambda: torch.topk(torch.matmul(q_hat, g_hat.t()), K))
        tf32_ms = event_ms(lib_call, reps=20)
        tf32_b_ms = PF.pipelined_ms(lib_call)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    log(f"  library at single-pass TF32 (allow_tf32=True, LOWER "
        f"precision than the kernel's 3xTF32; not the yardstick): "
        f"{tf32_ms:.3f} ms single call, {tf32_b_ms:.3f} "
        "back-to-back")

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
    g16 = resident(index, "bfloat16")[0]
    g8, kw8 = resident(index, "int8")
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

    image_rows = augment_phase(model, gen, peaks)
    t3 = depthwise_training(T3, gen, peaks, DW_RAGGED)
    assert len(t3["shapes"]) == 26, t3["shapes"]
    inference_rows = inference_phase(model, index, paths, gen, peaks)
    # the CLI's launches of kernels 1-3 (each query path's counts set to 0
    # just before it and read just after), beside the main path's
    cli = cli_phase(PF.card())
    served, t1 = backbone_phase(gen, peaks)
    for row in kernels:
        if row["name"] in cli:
            row["cli_launches"] = cli[row["name"]]
        row["models"] = {m: rows[row["name"]] for m, rows in served.items()}
    # 10. training from disk through the CLIs: rows 5-10 carry the train
    # run's launches (the image kernels by C entry), rows 9-10 the sweep's
    disk = disk_phase(PF.card())
    dw_rows = dw_entries(t3, t1)
    for row in image_rows:
        row["train_cli_launches"] = disk["train"]["entry"][ENTRIES[row["name"]]]
    for row in dw_rows:
        counters = (("depthwise_conv_forward", "depthwise_conv_grad_x")
                    if row["name"] == "depthwise_conv_forward"
                    else ("depthwise_conv_grad_w",))
        row["train_cli_launches"] = sum(disk["train"]["dw"][c]
                                        for c in counters)
        row["find_lr_launches"] = sum(disk["sweep"][c] for c in counters)
    kernels += image_rows + dw_rows + inference_rows
    # 11. evaluation and analysis from disk: rows 1 and 3 carry kernel 1's
    # launches in the two cli.inference runs and each kernel's in the
    # artifact's queries
    analysis = analysis_phase(index, q64, PF.card())
    for row in kernels:
        if row["name"] in ("fused_cosine_topk", "fused_cosine_topk_int8"):
            own = row["name"] == "fused_cosine_topk"
            row["inference_cli_launches"] = {
                "class_dedup": analysis["class_dedup"] if own else 0,
                "index_match": analysis["index_match"] if own else 0,
                "artifact_query": analysis["artifact_query"][row["name"]]}

    # 12. sharded retrieval over the phase 2 gallery: rows 1-3 carry each
    # sharded request's launches (one per shard)
    sharded = sharded_phase(index, q64, PF.card())
    for row in kernels:
        if row["name"] in sharded:
            row["sharded_launches"] = sharded[row["name"]]

    # 13. multi-device training on the one card: rows 5-10 carry each
    # rank's launches in (b)
    md = multidevice_phase(PF.card(), disk["multihost"])
    for row in image_rows:
        row["multi_device_launches_per_rank"] = [
            ranks[ENTRIES[row["name"]]] for ranks in md["ranks"]]
    for row in dw_rows:
        counters = (("depthwise_conv_forward", "depthwise_conv_grad_x")
                    if row["name"] == "depthwise_conv_forward"
                    else ("depthwise_conv_grad_w",))
        row["multi_device_launches_per_rank"] = [
            sum(ranks[c] for c in counters) for ranks in md["ranks"]]

    # 14. the converter (inside phase 10: row 1 carries kernel 1's
    # launches in its queries) and the 2-D hybrid layout: rows 5-10 carry
    # each rank's launches in (b)'s b3a step
    for row in kernels:
        if row["name"] in disk["convert"]:
            row["convert_launches"] = disk["convert"][row["name"]]
    hybrid = hybrid_phase(PF.card())
    for row in image_rows:
        row["hybrid_launches_per_rank"] = [
            ranks[ENTRIES[row["name"]]] for ranks in hybrid["ranks"]]
    for row in dw_rows:
        counters = (("depthwise_conv_forward", "depthwise_conv_grad_x")
                    if row["name"] == "depthwise_conv_forward"
                    else ("depthwise_conv_grad_w",))
        row["hybrid_launches_per_rank"] = [
            sum(ranks[c] for c in counters) for ranks in hybrid["ranks"]]

    # 15. result: the one card this run drove
    print(json.dumps({"kernels": kernels}))
    print(PF.card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": 1}}), flush=True)


if __name__ == "__main__":
    main()
