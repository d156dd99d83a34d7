"""Smoke run of the PyTorch/CUDA port on one GPU: build, serve, verify, time.

    python3 chip_smoke.py

Phases (any failure exits non-zero, with no result line):

1. Build the port's CUDA kernel from ``csrc/`` with nvcc and print the
   card's name and power limit.
2. Main path: ``efficientnet_b3a`` at full width with seeded random weights
   embeds 512 seeded uint8 224x224 images through the squarepad eval
   transform into a ``GalleryIndex``, which then takes 99,488 seeded unit
   rows (G = 100,000 x 1536 f32 on the device).
3. Requests: ``RetrievalEngine.embed_batch`` -> ``query_class_dedup(k=150,
   num_unique=3)`` for two batches of 64 (fused kernel) and one of 8 (dense
   path), a cold round then a warm one; per-request latency; the kernels'
   launch counts over phases 2-3; one more request under torch.profiler.
4. Each kernel against its plain version on the card, at the main path's
   shapes: bitwise on ±1 data, near-tie rule on the float gallery (served
   queries, and seeded unit rows with wider top-k gaps); kernel,
   plain and library times (CUDA events) and the kernel's bound.
5. One JSON line of kernels, the nvidia-smi line, and the result line.

Imports nothing of JAX. Needs one CUDA card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device; nothing was run")

from imageretrievalresearch_tpu_torch.models import create_model  # noqa: E402
from imageretrievalresearch_tpu_torch.ops import _cuda  # noqa: E402
from imageretrievalresearch_tpu_torch.ops import retrieval as R  # noqa: E402
from imageretrievalresearch_tpu_torch.ops.preprocess import (  # noqa: E402
    build_eval_transform,
)
from imageretrievalresearch_tpu_torch.retrieval import (  # noqa: E402
    GalleryIndex,
    RetrievalEngine,
)

SEED = 0
G_TOTAL, N_IMAGES, DIM, K, SIZE = 100_000, 512, 1536, 150, 224
DEV = torch.device("cuda")
# published peaks of the H100 (NVIDIA data sheets), at full power:
# (memory bytes/s, non-tensor-core f32 FLOP/s)
PEAKS = {"sxm": (3.35e12, 67e12), "pcie": (2.0e12, 51e12)}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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
    entries, products and partial sums are exact in f32, so scores are
    bitwise-equal under any accumulation order."""
    pos = torch.rand((n, d), generator=gen, device=DEV).argsort(dim=1)
    sign = torch.randint(0, 2, (n, nnz), generator=gen, device=DEV) * 2 - 1
    out = torch.zeros((n, d), device=DEV)
    out.scatter_(1, pos[:, :nnz], sign.float())
    return out


def main() -> None:
    card = torch.cuda.get_device_name(0)
    # 1. build
    log(f"card: {smi()}")
    t0 = time.perf_counter()
    out = _cuda.build()
    log(f"build fused_topk: {time.perf_counter() - t0:.1f} s")
    for line in out.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  {line.strip()}")

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

    # 3. requests: one cold round (first calls at each batch size), one warm
    requests = []
    for n in (64, 64, 8) * 2:
        batch = images(gen, n)

        emb, embed_ms = sync_time(lambda: engine.embed_batch(batch))
        (vals, inds, cls), query_ms = sync_time(
            lambda: index.query_class_dedup(emb, k=K, num_unique=3))
        ms = embed_ms + query_ms
        assert vals.shape == inds.shape == cls.shape == (n, 3)
        assert np.isfinite(vals).all() and (inds >= 0).all()
        np.testing.assert_array_equal(cls, index.classes[inds])
        assert (np.diff(vals, axis=1) <= 0).all(), "dedup order"
        requests.append((emb, ms))
        log(f"request Q={n}: {ms:.1f} ms end to end = embed "
            f"{embed_ms:.1f} + k={K} top-k and class dedup {query_ms:.1f}"
            f"{' (includes the gallery upload)' if len(requests) == 1 else ''}"
            f"{'; cold' if len(requests) <= 3 else '; warm'}"
            f"; fused launches so far "
            f"{R.KERNEL_LAUNCHES['fused_cosine_topk']}")
    launches = dict(R.KERNEL_LAUNCHES)
    assert launches["fused_cosine_topk"] == 4, launches   # Q=8 is dense
    for name, n in launches.items():
        assert n > 0, f"kernel {name} never ran on the main path"

    # device time of one warm Q=64 request, by kernel
    batch = images(gen, 64)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, wall_ms = sync_time(lambda: index.query_class_dedup(
            engine.embed_batch(batch), k=K, num_unique=3))
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"profiled Q=64 request: {wall_ms:.1f} ms wall, {busy_ms:.1f} ms "
        "device busy; top kernels by device time:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} "
            f"{e.key[:90]}")

    # the served ranking against the dense path on the card
    gal, norms = index._gallery_on_device()
    q64 = requests[1][0]
    fv, fi = R.cosine_topk(q64, gal, K, gallery_norms=norms)
    dv, di = R.cosine_topk(q64, gal, K, gallery_norms=norms, method="dense")
    # random weights map every image near one direction, so the served
    # top-k is dense with near-ties: positions may swap, values may not
    mism = (fi != di).float().mean().item()
    assert (fv - dv).abs().max().item() <= 1e-5
    log(f"fused vs dense on the served gallery: {mism:.5f} of positions "
        "differ, all at near-ties (values agree within 1e-5)")

    # 4. kernel against plain version, at the main path's shapes
    q_hat = R.l2_normalize(q64)
    splits = R.fused_splits(64, G_TOTAL, K, DEV)
    log(f"kernel geometry: bins={R.FUSED_BINS}, t_depth={R.FUSED_T_DEPTH}, "
        f"splits={splits}")

    def compare(qh, g, gn):
        R.reset_launch_counts()   # comparison launches are not counted
        kv, ki, kok = R.fused_cosine_topk(qh, g, K, gallery_norms=gn)
        rv, ri, rok = R.fused_cosine_topk_reference(
            qh, g, K, gallery_norms=gn, splits=splits)
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
    kv, ki, kok, rv, ri, rok = compare(pqh, pg, pn)
    assert torch.equal(kv, rv) and torch.equal(ki, ri) and torch.equal(
        kok, rok), "kernel != plain version on ±1 data"
    assert kok[0].item() == 0 and kok.any(), kok
    wv, wi = R.cosine_topk(pq, pg, K, gallery_norms=pn)
    ev, ei = R.cosine_topk(pq, pg, K, gallery_norms=pn, method="dense")
    assert torch.equal(wi, ei) and torch.equal(wv, ev), "repair"
    log("±1 data: vals/inds/ok bitwise equal; the planted bin overflow "
        "fails its certificate and cosine_topk repairs it exactly")
    del pq, pg, pqh, pn

    # the float gallery: the served queries (random weights put them near
    # one direction, so their top-k is dense with near-ties) and seeded
    # unit rows, whose top-k gaps are far wider
    g_hat = R._normalized_gallery(gal, norms)
    unit_q = R.l2_normalize(torch.randn((64, DIM), generator=gen,
                                        device=DEV))
    err = 0.0
    for what, qh in (("served queries", q_hat), ("seeded unit rows", unit_q)):
        kv, ki, kok, rv, ri, rok = compare(qh, gal, norms)
        e = (kv - rv).abs().max().item()
        assert e <= 1e-5, (what, e)
        err = max(err, e)
        scores = torch.matmul(qh, g_hat.t())
        kth = rv[:, K - 1:K]
        n_diff = 0
        for r in range(kv.shape[0]):
            diff = set(ki[r].tolist()) ^ set(ri[r].tolist())
            if diff:
                n_diff += 1
                d = torch.tensor(sorted(diff), device=DEV)
                assert (scores[r, d] - kth[r]).abs().max().item() <= 1e-5, (
                    what, r)
        n_ok, n_rok = int(kok.sum()), int(rok.sum())
        assert torch.equal(kok, rok), (what, n_ok, n_rok,
                                       (kok != rok).nonzero())
        log(f"float gallery, {what}: max |vals - plain| = {e:.3g}; "
            f"{n_diff} of {kv.shape[0]} rows have index sets that differ, "
            f"only at near-ties of the k-th value; {n_ok} rows certified "
            "by the kernel and its plain version alike")
    del scores

    # timings at the main path's shapes
    ms = event_ms(lambda: R.fused_cosine_topk(q_hat, gal, K,
                                              gallery_norms=norms), reps=20)
    plain_ms = event_ms(lambda: R.fused_cosine_topk_reference(
        q_hat, gal, K, gallery_norms=norms, splits=splits), reps=5, warmup=1)
    library_ms = event_ms(lambda: torch.topk(torch.matmul(q_hat, g_hat.t()),
                                             K), reps=20)
    del g_hat
    peak_bw, peak_flops = PEAKS["pcie" if "PCIe" in card else "sxm"]
    q, g = q_hat.shape[0], gal.shape[0]
    nbytes = 4 * (q * DIM + g * DIM + g + q * K * 2 + q)
    flops = 2 * q * g * DIM
    bound_bytes, bound_ops = nbytes / peak_bw * 1e3, flops / peak_flops * 1e3
    log(f"fused_cosine_topk Q={q} G={g} D={DIM} k={K}: {ms:.3f} ms "
        f"(bound {max(bound_bytes, bound_ops):.3f} ms: bytes "
        f"{bound_bytes:.3f}, operations {bound_ops:.3f}); plain "
        f"{plain_ms:.3f} ms; torch.topk(matmul) {library_ms:.3f} ms")

    # 5. result
    kernels = [{
        "name": "fused_cosine_topk",
        "route": "cuda",
        "source": "imageretrievalresearch_tpu_torch/csrc/fused_topk.cu",
        "replaces": "imageretrievalresearch_tpu/ops/retrieval.py:259",
        "launches": launches["fused_cosine_topk"],
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
        "library_ms": library_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
