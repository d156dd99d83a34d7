"""Serving cells: callers in a closed loop, each request a batch of
decoded photos held on the host, embedded by ``RetrievalEngine.embed_batch``
(the eval transform, then the backbone) and ranked by
``GalleryIndex.query_class_dedup`` (exact cosine top-k over the gallery,
then the first unique classes).

End-to-end: ``serve_qps`` (queries answered in the window over its
seconds), ``serve_p95_ms`` (95th percentile of every request's latency,
host clock, each request ending when its answer is on the host) and
``setup_s``. A traced run adds the spans ``embed`` and ``index`` (a
synchronisation between them) and a profiled slice after the window.

``correct``: once the window has closed and the program is freed, a
sample of the finished requests, drawn from the seed, is answered again by
the plain reference (``reference/``: the eval transform, the net in float32
with TF32 off, exact scores, the class dedup) on the same images, weights
and gallery, and compared:

- ``emb_rel``: the largest ||e - e_ref|| / ||e_ref|| over the sampled
  queries' embeddings;
- ``score_gap``: the largest gap between a returned score and the
  reference's score of the returned row;
- ``rank_gap``: the largest amount by which the reference's score of a
  returned row lies below the reference's own answer in that slot;
- ``class_faults``: returned classes that are not their row's class, or
  repeat within a query's answer, or are missing.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import generator as gen
from port_bench.kinds import common
from port_bench.reference import models as ref_models
from port_bench.reference import retrieval as ref_retrieval
from port_bench.reference import transforms as ref_transforms
from port_bench.trace import Profiled, Reading
from port_bench.work import counts


class Program:
    """The system under test, built from the seed: the engine over the
    configuration's backbone and the index over the traffic's gallery."""

    def __init__(self, cell, s: dict, device):
        from imageretrievalresearch_tpu_torch.models.backbone import (
            create_model,
        )
        from imageretrievalresearch_tpu_torch.ops.preprocess import (
            build_eval_transform,
        )
        from imageretrievalresearch_tpu_torch.retrieval.engine import (
            RetrievalEngine,
        )
        from imageretrievalresearch_tpu_torch.retrieval.index import (
            GalleryIndex,
        )
        cfg, t = cell.config, cell.traffic
        t0 = time.perf_counter()
        model = create_model(cfg["model_name"],
                             num_classes=cfg["num_classes"], device=device,
                             seed=None)
        model.load_timm_state_dict(gen.weights(cfg, s["weights"],
                                               device))
        self.engine = RetrievalEngine(
            model, device=device, transform=build_eval_transform(
                "squarepad", cfg["image_size"], device=device))
        common.phase("program.model", t0)
        rows, classes = gen.gallery(t["gallery"], s["gallery"], device)
        self.index = GalleryIndex(t["gallery"]["dim"], device=device)
        self.index.add(rows.cpu().numpy(), classes.cpu().numpy())
        self.t = t

    def serve(self, images, spans: dict | None = None):
        """One request: (embeddings on the device, (scores, rows,
        classes) on the host)."""
        t = self.t
        t0 = time.perf_counter()
        emb = self.engine.embed_batch(images)
        if spans is not None:
            common.sync(emb.device)
            t1 = time.perf_counter()
        answer = self.index.query_class_dedup(
            emb, k=t["k"], num_unique=t["num_unique"], method=t["method"],
            matmul_dtype=t["matmul_dtype"])
        if spans is not None:
            spans.setdefault("embed", []).append(t1 - t0)
            spans.setdefault("index", []).append(time.perf_counter() - t1)
        return emb, answer


def _keep_mask(seed: int, one_in: int, n: int = 1 << 20) -> np.ndarray:
    return np.random.default_rng(seed).random(n) < 1.0 / one_in


def run(cell, args, start: float, device="cuda", fault=None):
    """One run; ``fault`` (tests only) alters each answer as it is
    produced: ``fault(emb, answer) -> (emb, answer)``."""
    t, cfg = cell.traffic, cell.config
    if t["gallery"]["dim"] != cfg["num_features"]:
        raise ValueError("the gallery's width is not the backbone's")
    if (t["loop"], t["callers"]) != ("closed", 1):
        raise ValueError("this kind drives one caller in a closed loop")
    s = gen.seeds(args.seed)
    common.phase("imports", start)
    prog = Program(cell, s, device)
    common.phase("program", start)
    pool = gen.request_pool(t, s["requests"], device)
    common.phase("requests", start)
    serve = prog.serve
    if fault is not None:
        def serve(x, spans=None, _serve=prog.serve):
            return fault(*_serve(x, spans))
    for i in range(t["warmup_requests"]):
        serve(pool[i % len(pool)])
        common.phase(f"warmup.{i}", start)
    common.sync(device)
    setup_s = time.perf_counter() - start

    keep = _keep_mask(s["sample"], t["keep_one_in"])
    spans = {} if args.trace else None
    latencies, kept, n = [], {}, 0
    w0 = time.perf_counter()
    end = w0 + args.seconds
    while True:
        r0 = time.perf_counter()
        emb, answer = serve(pool[n % len(pool)], spans)
        r1 = time.perf_counter()
        latencies.append(r1 - r0)
        if keep[n % len(keep)]:
            kept[n] = (emb, answer)
        n += 1
        if r1 >= end:
            break
    window_s = r1 - w0
    trace = None
    if args.trace:
        m = t["trace_requests"]
        with Profiled(torch, m) as prof:
            for j in range(m):
                serve(pool[(n + j) % len(pool)])
        trace = prof.trace
    peak = common.peak_bytes(device)
    del prog, serve, emb
    common.release()

    values = check(cell, s, pool, kept, device)
    q = t["queries"]
    reading = Reading(trace, spans=spans or {},
                      counts={"requests": n, "queries": n * q},
                      work=work(cell), peaks=counts.peaks())
    return common.Outcome(
        attempted=n, failed=0,
        end_to_end={"setup_s": setup_s,
                    "serve_qps": n * q / window_s,
                    "serve_p95_ms": 1e3 * float(np.percentile(latencies,
                                                              95))},
        checks=common.checks(values, cell.workload), readings=values,
        device=common.device_info(device, cell.chips, peak, trace),
        reading=reading)


def work(cell) -> dict:
    """Per request: the embed's FLOPs, the scoring product's and kernel
    1's bound."""
    t, cfg = cell.traffic, cell.config
    g = t["gallery"]
    k1 = counts.kernel1(t["queries"], g["rows"], g["dim"], t["k"])
    return {"embed_flops": t["queries"] * counts.forward_flops(
                cfg, cfg["image_size"]),
            "score_flops": k1["ops"], "kernel1_bound_s": k1["bound_s"]}


class Reference:
    """The plain reference's answers, from the same seed: ``tf32`` runs it
    one precision below the configuration's (the control)."""

    def __init__(self, cell, s: dict, device, tf32: bool = False):
        cfg, t = cell.config, cell.traffic
        self.cell, self.device, self.tf32 = cell, device, tf32
        self.net = ref_models.build(cfg, device=device)
        self.net.load_timm_state_dict(gen.weights(cfg, s["weights"],
                                                  device))
        self.net.eval()
        rows, classes = gen.gallery(t["gallery"], s["gallery"], device)
        self.ghat = ref_retrieval.normalize(rows)
        self.classes = classes.cpu().numpy()

    @torch.no_grad()
    def answer(self, images: np.ndarray):
        t = self.cell.traffic
        common.precise(not self.tf32)
        try:
            x = ref_transforms.eval_transform(
                torch.as_tensor(images, device=self.device),
                self.cell.config["image_size"])
            emb, _ = self.net(x)
            s = ref_retrieval.scores(emb, self.ghat)
            rows, vals, cls = ref_retrieval.class_dedup(
                s, self.classes, t["k"], t["num_unique"])
        finally:
            common.precise(True)
        return emb, (vals, rows, cls)

    @torch.no_grad()
    def scores(self, emb: torch.Tensor) -> torch.Tensor:
        common.precise(True)
        return ref_retrieval.scores(emb, self.ghat)


def sample(s: dict, kept: dict, m: int) -> list:
    keys = sorted(kept)
    rng = np.random.default_rng(s["sample"] + 1)
    return sorted(rng.choice(keys, size=min(m, len(keys)), replace=False)
                  .tolist())


def compare(ref: Reference, answers: list, images: list) -> dict:
    """The compared numbers of ``answers`` ((emb, (scores, rows,
    classes)) per request) against the reference on ``images``."""
    emb_rel = score_gap = rank_gap = 0.0
    faults = 0
    for (emb, (vals, rows, cls)), x in zip(answers, images):
        e_ref, (v_ref, _, _) = ref.answer(x)
        e = emb.float().to(e_ref.device)
        emb_rel = max(emb_rel, float((torch.linalg.vector_norm(
            e - e_ref, dim=1) / torch.linalg.vector_norm(e_ref, dim=1)
            ).max()))
        s_ref = ref.scores(e_ref).cpu().numpy().astype(np.float64)
        rows = np.asarray(rows)
        cls = np.asarray(cls)
        # a slot is empty where the top-k holds fewer distinct classes
        bad = rows < 0
        faults += int((bad != np.isneginf(v_ref)).sum())
        r = np.where(bad, 0, rows)
        at = np.take_along_axis(s_ref, r, axis=1)
        ok = ~bad
        score_gap = max(score_gap, float(np.abs(
            np.asarray(vals, np.float64) - at)[ok].max(initial=0.0)))
        rank_gap = max(rank_gap, float((v_ref - at)[ok].max(initial=0.0)))
        faults += int((ok & (cls != ref.classes[r])).sum())
        for row, fine in zip(cls, ok):
            kept = row[fine].tolist()
            faults += len(kept) - len(set(kept))
    return {"emb_rel": emb_rel, "score_gap": score_gap,
            "rank_gap": rank_gap, "class_faults": float(faults)}


def check(cell, s: dict, pool: list, kept: dict, device) -> dict:
    ids = sample(s, kept, cell.traffic["check_requests"])
    ref = Reference(cell, s, device)
    return compare(ref, [kept[i] for i in ids],
                   [pool[i % len(pool)] for i in ids])
