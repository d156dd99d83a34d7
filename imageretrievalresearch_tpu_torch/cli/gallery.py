"""Gallery serving CLI — build, describe, query and serve a saved
:class:`GalleryIndex` artifact.

Counterpart of ``imageretrievalresearch_tpu/cli/gallery.py``, with the
same subcommands, flags, defaults and outputs:

- ``build``  — embed a class-per-subfolder image directory into a new
  artifact (classes = subfolder names, per-item paths recorded, compact
  ``--gallery_dtype`` storage).
- ``info``   — print an artifact's size / dim / metadata.
- ``query``  — embed image files (or a directory) with the artifact's
  recorded model + transform and print per-query rankings as JSON lines.
- ``serve``  — keep the model + gallery resident and answer rankings over
  HTTP (stdlib ``http.server``): POST a raw image body to ``/search``
  (`?k=&num_unique=`) for a JSON ranking; GET ``/healthz`` for liveness.

Ranking semantics follow the reference notebook (``topk(cos, k)`` +
optional unique-class dedup); ``--matmul_dtype bfloat16|int8|int8_rerank``
selects the compact serving modes. A query of 32 or more images against a
gallery of at least 256 rows takes the fused CUDA top-k kernel of its mode
on the card (``ops.retrieval.cosine_topk``); serve's micro-batches (at
most ``--max_batch``) take the dense path, as JAX's serve does.

The port's own choices: ``--device`` (``cuda`` by default; with no card it
raises unless ``--device cpu``) stands for JAX's ``JAX_PLATFORMS``;
images are decoded by ``data.decode`` (PNG only: the card's machine has no
PIL and the port no JPEG decoder yet); ``serve`` also takes
``--precision`` and ``--shortlist``, which JAX's serve lacks
(``--precision`` is only validated: both values compute the same f32).
Stdout holds only the JSON output; every other message goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Callable, NamedTuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from imageretrievalresearch_tpu_torch import metrics as M
from imageretrievalresearch_tpu_torch import models
from imageretrievalresearch_tpu_torch._device import resolve_device
from imageretrievalresearch_tpu_torch.data.decode import (
    decode_image,
    resize_bilinear_host,
    square_pad_host,
)
from imageretrievalresearch_tpu_torch.data.splits import IMG_EXTS
from imageretrievalresearch_tpu_torch.models.convert import load_checkpoint
from imageretrievalresearch_tpu_torch.ops.preprocess import (
    build_eval_transform,
)
from imageretrievalresearch_tpu_torch.retrieval import GalleryIndex

# reject absurd /search bodies before buffering them (a single huge POST
# would otherwise exhaust host memory); 32 MB comfortably fits any real
# query image
_MAX_BODY_BYTES = 32 * 1024 * 1024

# serve decodes one upload at a time (see _make_server)
_DECODE_LOCK = threading.Lock()

_DEVICE_HELP = ("torch device (default: cuda; raises without a GPU unless "
                "'cpu' is given)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GalleryIndex serving CLI")
    sub = p.add_subparsers(dest="cmd", required=True)

    pb = sub.add_parser("build", help="embed an image tree into an artifact")
    pb.add_argument("gallery", type=str, help="output .npz path")
    pb.add_argument("images", type=str,
                    help="directory of class subfolders of images")
    pb.add_argument("-cp", "--checkpoint_path", type=str, default="")
    pb.add_argument("-mn", "--model_name", type=str,
                    default="efficientnet_b3a")
    pb.add_argument("-is", "--input_size", type=int, default=224)
    pb.add_argument("-bs", "--batch_size", type=int, default=64)
    pb.add_argument("--transform", type=str, default="squarepad",
                    choices=["squarepad", "plain"])
    pb.add_argument("--num_classes", type=int, default=None,
                    help="classifier width for checkpoint loading "
                         "(default: the number of subfolders)")
    pb.add_argument("--conv_input", action=argparse.BooleanOptionalAction,
                    default=False)
    pb.add_argument("--host_size", type=int, default=None)
    pb.add_argument("--gallery_dtype", type=str, default="float32",
                    choices=["float32", "bfloat16", "int8"])
    pb.add_argument("--device", type=str, default=None, help=_DEVICE_HELP)

    pi = sub.add_parser("info", help="describe a gallery artifact")
    pi.add_argument("gallery", type=str, help="GalleryIndex .npz path")

    pq = sub.add_parser("query", help="rank the gallery for query images")
    pq.add_argument("gallery", type=str, help="GalleryIndex .npz path")
    pq.add_argument("images", nargs="+", type=str,
                    help="query image files and/or directories")
    pq.add_argument("-cp", "--checkpoint_path", type=str, default="",
                    help="model checkpoint (default: the artifact's "
                         "recorded checkpoint)")
    pq.add_argument("-mn", "--model_name", type=str, default=None,
                    help="backbone (default: the artifact's recorded model)")
    pq.add_argument("-is", "--input_size", type=int, default=None)
    pq.add_argument("-bs", "--batch_size", type=int, default=64)
    _add_ranking_args(pq)
    pq.add_argument("--transform", type=str, default=None,
                    choices=["squarepad", "plain"],
                    help="eval transform (default: the artifact's recorded "
                         "transform)")
    pq.add_argument("--num_classes", type=int, default=None,
                    help="classifier width for checkpoint loading "
                         "(default: the artifact's recorded value)")
    pq.add_argument("--conv_input", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="model has the 3x3 conv+SiLU stem; --no-conv_input "
                         "overrides a recorded True (default: the "
                         "artifact's recorded value)")
    pq.add_argument("--host_size", type=int, default=None,
                    help="host-side decode resize; required when query "
                         "images have mixed source resolutions (applied "
                         "after an aspect-preserving square pad when the "
                         "transform is squarepad)")
    pq.add_argument("--device", type=str, default=None, help=_DEVICE_HELP)

    ps = sub.add_parser("serve", help="HTTP retrieval endpoint")
    ps.add_argument("gallery", type=str, help="GalleryIndex .npz path")
    ps.add_argument("-cp", "--checkpoint_path", type=str, default="")
    ps.add_argument("-mn", "--model_name", type=str, default=None)
    ps.add_argument("-is", "--input_size", type=int, default=None)
    _add_ranking_args(ps)
    ps.add_argument("--transform", type=str, default=None,
                    choices=["squarepad", "plain"])
    ps.add_argument("--num_classes", type=int, default=None)
    ps.add_argument("--conv_input", action=argparse.BooleanOptionalAction,
                    default=None)
    ps.add_argument("--host", type=str, default="127.0.0.1")
    ps.add_argument("--port", type=int, default=8321)
    ps.add_argument("--max_batch", type=int, default=8,
                    help="micro-batch cap for coalescing concurrent "
                         "requests (batches are padded to a power of 2 up "
                         "to this)")
    ps.add_argument("--device", type=str, default=None, help=_DEVICE_HELP)
    return p


def _add_ranking_args(p: argparse.ArgumentParser) -> None:
    """The ranking flags query and serve share (JAX's serve has all but
    --shortlist and --precision)."""
    p.add_argument("-k", "--topk", type=int, default=150)
    p.add_argument("--num_unique", type=int, default=3,
                   help="unique classes reported after dedup (notebook "
                        "cell 2 semantics); 0 disables dedup")
    p.add_argument("--method", type=str, default="exact",
                   choices=["exact", "approx"],
                   help="'approx' is not ported yet and raises")
    p.add_argument("--matmul_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16", "int8", "int8_rerank"],
                   help="bfloat16/int8 = half/quarter gallery bytes, "
                        "exact top-k of the rounded/quantized scores; "
                        "int8_rerank = certified two-stage capacity mode "
                        "(int8 shortlist + f32 re-rank, bf16 memory)")
    p.add_argument("--shortlist", type=int, default=256,
                   help="int8_rerank only: stage-1 quantized shortlist "
                        "size (>= k)")
    p.add_argument("--precision", type=str, default="default",
                   choices=["default", "highest"],
                   help="JAX's float32 matmul precision; on the port the "
                        "value is only validated: both compute the same f32 "
                        "arithmetic (true f32 on the dense path, 3xTF32 in "
                        "the fused kernel)")


def _collect_images(specs: list[str]) -> list[Path]:
    out: list[Path] = []
    for spec in specs:
        path = Path(spec)
        if path.is_dir():
            out.extend(sorted(q for q in path.rglob("*")
                              if q.suffix.lower() in IMG_EXTS))
        elif path.is_file():
            out.append(path)
        else:
            raise FileNotFoundError(spec)
    if not out:
        raise ValueError(f"no images found under {specs}")
    return out


def _decode(paths: list[Path], host_size: int | None,
            squarepad: bool = False) -> np.ndarray:
    arrs = []
    for p in paths:
        im = decode_image(p)
        if host_size:
            # squarepad: pad at source aspect FIRST so the host resize
            # doesn't distort (the device SquarePad then no-ops)
            if squarepad:
                im = square_pad_host(im)
            im = resize_bilinear_host(im, (host_size, host_size))
        arrs.append(im)
    shapes = {a.shape for a in arrs}
    if len(shapes) > 1:
        raise SystemExit(
            f"query images have mixed resolutions {sorted(shapes)}; pass "
            "--host_size to resize on host before stacking")
    return np.stack(arrs)


def _pad_batch(x: np.ndarray, n: int) -> np.ndarray:
    """Repeat the last image up to ``n`` rows: one batch shape for every
    dispatch, so cuDNN runs one algorithm and a gallery image and the same
    image as a query embed identically."""
    if x.shape[0] < n:
        x = np.concatenate([x, np.repeat(x[-1:], n - x.shape[0], 0)])
    return x


class _ModelStack(NamedTuple):
    """A resident model + its eval transform, as resolved by
    :func:`_load_stack`. ``embed_fn(uint8_batch) -> (N, dim)`` numpy is
    the convenience path; serve runs the pieces (backbone, tfm) itself to
    keep the whole search on the device."""

    embed_fn: Callable[[np.ndarray], np.ndarray]
    transform: str
    input_size: int
    backbone: torch.nn.Module
    tfm: Callable


def _load_stack(args, idx=None) -> _ModelStack:
    """Resolve model/transform from args + (optionally) an artifact's
    recorded meta and return a :class:`_ModelStack` with the model
    resident on ``args.device``."""
    meta = idx.meta if idx is not None else {}
    model_name = args.model_name or meta.get("model") or "efficientnet_b3a"
    ckpt = args.checkpoint_path or meta.get("checkpoint") or ""
    transform = args.transform or meta.get("transform") or "squarepad"
    input_size = args.input_size or meta.get("input_size") or 224
    # checkpoint loading needs the TRAINED architecture (classifier width,
    # optional conv stem) — recorded in the artifact at build time; 125 =
    # the reference's Sketchy class count as a last resort
    num_classes = (args.num_classes if args.num_classes is not None
                   else meta.get("num_classes") or 125)
    conv_input = (args.conv_input if args.conv_input is not None
                  else bool(meta.get("conv_input")))
    device = resolve_device(args.device)

    backbone = models.create_model(model_name, num_classes=num_classes,
                                   conv_input=conv_input, device=device)
    load_checkpoint(ckpt, backbone)      # its messages go to stderr
    tfm = build_eval_transform(transform, input_size, device=device)

    # fail fast on a model/artifact dim mismatch — otherwise every request
    # dies in an opaque matmul shape error
    if idx is not None and backbone.num_features != idx.dim:
        raise SystemExit(
            f"model {model_name} embeds dim {backbone.num_features} but the "
            f"gallery artifact was built with dim {idx.dim} — pass the "
            "matching -mn/--model_name")

    def embed_fn(batch_u8: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            return backbone.embed(tfm(batch_u8)).float().cpu().numpy()

    tag = (f"gallery: {len(idx)} items, dim {idx.dim}, "
           if idx is not None else "")
    print(f"{tag}model {model_name}, transform {transform}@{input_size}, "
          f"device {device}", file=sys.stderr)
    return _ModelStack(embed_fn, transform, input_size, backbone, tfm)


def _build(args) -> None:
    """Embed a class-per-subfolder image tree into a serving artifact."""
    root = Path(args.images)
    class_dirs = sorted(d for d in root.iterdir() if d.is_dir())
    if not class_dirs:
        raise SystemExit(f"no class subfolders under {root}")
    if args.num_classes is None:
        args.num_classes = len(class_dirs)
    embed_fn, transform, input_size = _load_stack(args)[:3]

    idx = None
    for ci, cdir in enumerate(class_dirs):
        paths = [p for p in sorted(cdir.rglob("*"))
                 if p.suffix.lower() in IMG_EXTS]
        for i in range(0, len(paths), args.batch_size):
            chunk = paths[i:i + args.batch_size]
            x = _decode(chunk, args.host_size,
                        squarepad=transform == "squarepad")
            emb = embed_fn(_pad_batch(x, args.batch_size))[:x.shape[0]]
            if idx is None:
                # record the host decode recipe so query/serve can replay
                # the exact embed path later: host resizes are Pillow's
                # bilinear, device resizes the transform's — close but not
                # bit-identical, and near-tied gallery scores can flip
                # ranks if queries take a different resampler than the
                # gallery did
                decode_hw = [int(x.shape[1]), int(x.shape[2])]
                idx = GalleryIndex(emb.shape[1], device=args.device, meta={
                    "model": args.model_name,
                    "checkpoint": args.checkpoint_path,
                    "transform": transform, "input_size": input_size,
                    "num_classes": args.num_classes,
                    "conv_input": bool(args.conv_input),
                    "host_size": args.host_size,
                    "decode_hw": decode_hw,
                    "class_names": [d.name for d in class_dirs]})
            elif (idx.meta.get("decode_hw") is not None
                  and list(idx.meta["decode_hw"]) != [int(x.shape[1]),
                                                      int(x.shape[2])]):
                # mixed native resolutions across classes (only possible
                # without --host_size): no single replayable decode shape
                idx.meta["decode_hw"] = None
            idx.add(emb, np.full(len(chunk), ci, np.int32),
                    paths=[str(p) for p in chunk])
    if idx is None:
        raise SystemExit(f"no images found under {root}")
    idx.save(args.gallery, store_dtype=args.gallery_dtype)
    print(f"built {len(idx)}-item gallery ({len(class_dirs)} classes, "
          f"dim {idx.dim}, {args.gallery_dtype}) -> {args.gallery}",
          file=sys.stderr)


def _records(vals, inds, classes, gpaths):
    """JSON-able per-query records from ranking arrays (query + serve)."""
    has_paths = any(gpaths)      # hoisted: O(G) scan once, not per record
    records = []
    for qi in range(len(vals)):
        # dedup pads with -1/-inf when fewer than num_unique classes exist
        # within the top-k candidates — drop the filler from served output
        keep = [int(x) >= 0 for x in inds[qi]]
        ginds = [int(x) for x, m in zip(inds[qi], keep) if m]
        records.append({
            "indices": ginds,
            "scores": [round(float(v), 5)
                       for v, m in zip(vals[qi], keep) if m],
            "classes": [int(c) for c, m in zip(classes[qi], keep) if m],
            "paths": [gpaths[g] for g in ginds] if has_paths else None,
        })
    return records


def _rank(idx, queries, args):
    """Shared ranking + record building for query."""
    kw = dict(method=args.method, matmul_dtype=args.matmul_dtype,
              precision=args.precision, shortlist=args.shortlist)
    k = min(args.topk, len(idx))
    if args.num_unique:
        vals, inds, classes = idx.query_class_dedup(
            queries, k=k, num_unique=args.num_unique, **kw)
    else:
        vals, inds, classes = idx.query(queries, k=k, **kw)
    return _records(vals, inds, classes, idx.paths)


class _MicroBatcher:
    """Coalesce concurrent /search requests into one device dispatch.

    ThreadingHTTPServer gives every POST its own thread; instead of a
    global lock serializing one search per request, request threads
    enqueue their decoded image and a single worker drains up to
    ``max_batch`` waiting requests into ONE ``search_fn(images,
    num_unique)`` call per distinct requested num_unique (images padded
    to the next power of two, so at most log2(max_batch)+1 batch shapes
    ever reach the model). Under concurrency this turns N device round
    trips into ceil(N/max_batch). The worker is the only device user — no
    lock needed.
    """

    def __init__(self, search_fn, max_batch: int = 8,
                 window_s: float = 0.010):
        self.search_fn = search_fn
        self.max_batch = max_batch
        # after the first request arrives, wait up to this long for
        # stragglers before dispatching: a small collection window buys
        # up to max_batch x amortization for a few ms of added p50
        self.window_s = window_s
        self._q: queue.Queue = queue.Queue()
        self.requests = 0
        self.dispatches = 0
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-microbatch")
        self._thread.start()

    def submit(self, x, num_unique: int):
        """Block until the worker has ranked this request's image.
        ``x`` is one decoded (1, H, W, 3) uint8 image."""
        if self._stopped:
            raise RuntimeError("micro-batcher stopped (server closed)")
        slot = {"x": x, "nu": num_unique, "ev": threading.Event()}
        self._q.put(slot)
        if self._stopped:
            # stop() may have completed between the check above and the
            # put — the worker's final drain would then never see this
            # slot and we'd block forever; error-out whatever is queued
            # (including, possibly, our own slot)
            self._release_pending()
        slot["ev"].wait()
        if "err" in slot:
            raise slot["err"]
        return slot["rec"]

    def stop(self) -> None:
        """Terminate the worker thread (idempotent). Without this every
        discarded server would leak a thread blocked in ``Queue.get``
        pinning the model and the device gallery for the process
        lifetime; wired into the server's ``server_close``."""
        if self._stopped:
            return
        self._stopped = True
        self._q.put(None)                      # wake + exit sentinel
        self._thread.join(timeout=30)
        # catch submits that enqueued after the worker's final drain but
        # before their own _stopped re-check ran
        self._release_pending()

    def _release_pending(self) -> None:
        """Error-out every queued slot (idempotent, queue-atomic: each slot
        is dequeued exactly once across worker/stop/submit callers).

        The stop() sentinel (None) must be PRESERVED, not swallowed: when
        this runs from a racing submit (or from stop() after its join
        timed out on a long search_fn) while the worker is still alive and
        busy, eating the sentinel would leave the worker blocked in
        ``Queue.get`` forever — exactly the leak stop() exists to prevent.
        Re-put one sentinel at the end (never inside the drain loop, which
        would spin) iff the worker still needs the wake-up."""
        saw_sentinel = False
        while True:
            try:
                it = self._q.get_nowait()
            except queue.Empty:
                break
            if it is None:
                saw_sentinel = True
                continue
            it["err"] = RuntimeError(
                "micro-batcher stopped (server closed)")
            it["ev"].set()
        if (saw_sentinel and self._thread.is_alive()
                and threading.current_thread() is not self._thread):
            self._q.put(None)

    @staticmethod
    def _pad_pow2(arr):
        n = arr.shape[0]
        return _pad_batch(arr, 1 << (n - 1).bit_length()), n

    def _loop(self):
        try:
            self._loop_body()
        finally:
            # reached on the stop() sentinel, but ALSO when the worker
            # dies unexpectedly (a BaseException escaping search_fn):
            # without this, _stopped stays False and every in-flight and
            # future submit() blocks forever on a dead worker
            self._stopped = True
            self._release_pending()

    def _loop_body(self):
        stopping = False
        while not stopping:
            first = self._q.get()
            if first is None:                  # stop() sentinel
                break
            items = [first]
            deadline = time.monotonic() + self.window_s
            while len(items) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    it = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if it is None:                 # finish this drain, then exit
                    stopping = True
                    break
                items.append(it)
            self.requests += len(items)
            try:
                by_nu: dict[int, list[int]] = {}
                for i, it in enumerate(items):
                    by_nu.setdefault(it["nu"], []).append(i)
                for nu, idxs in by_nu.items():
                    # failures are scoped to the group that dispatched
                    # them: a raise here must not clobber results other
                    # num_unique groups in the same drain already computed
                    try:
                        xs = np.concatenate([items[i]["x"] for i in idxs])
                        xs, m = self._pad_pow2(xs)
                        self.dispatches += 1
                        recs = self.search_fn(xs, nu)[:m]
                        for i, rec in zip(idxs, recs):
                            items[i]["rec"] = rec
                    except Exception as e:  # noqa: BLE001 — per request
                        for i in idxs:
                            items[i]["err"] = e
            except BaseException:
                # a non-Exception escaping (SystemExit etc.) kills the
                # worker; the CURRENT drain's items are already out of the
                # queue, so _release_pending can't reach them — error them
                # here or their submit() threads block forever
                for it in items:
                    it.setdefault("err", RuntimeError(
                        "micro-batcher worker died"))
                    it["ev"].set()
                raise
            for it in items:
                it["ev"].set()


def _serve(args) -> None:
    srv = _make_server(args)
    print(f"serving on http://{srv.server_address[0]}:"
          f"{srv.server_address[1]} (POST /search?k=&num_unique=, "
          f"GET /healthz)", file=sys.stderr)
    srv.serve_forever()


def _make_server(args):
    """Resident HTTP retrieval endpoint (stdlib only); returns the bound
    server (``serve_forever`` left to the caller/tests)."""
    device = resolve_device(args.device)
    idx = GalleryIndex.load(args.gallery, device=device)
    if not len(idx):
        # fail fast: every request would otherwise rank an empty gallery
        raise SystemExit(
            f"gallery artifact {args.gallery} is empty; build it first")
    if args.method == "approx":
        raise NotImplementedError("method='approx' is not ported yet")
    stack = _load_stack(args, idx)
    transform, input_size = stack.transform, stack.input_size

    # Canonical upload shape: REPLAY the artifact's build-time decode
    # recipe (meta host_size/decode_hw) so a served query and a
    # `gallery query` of the same image take the same host-resize +
    # device-resize chain as the gallery items did: the two resamplers
    # differ at the last-ULP level, enough to flip near-tied ranks if
    # query and gallery mix them. Legacy artifacts without the recorded
    # recipe fall back to input_size.
    decode_hw = idx.meta.get("decode_hw") or (input_size, input_size)
    if transform == "squarepad":
        # build fed the device SquarePad square inputs (host pre-pad with
        # --host_size, native squares otherwise); uploads pad on host at
        # source aspect, then resize to the square the device path expects
        decode_side = max(int(decode_hw[0]), int(decode_hw[1]))
        decode_hw = (decode_side, decode_side)

    # one decode at a time: the decoder is many short numpy calls that
    # hold the GIL, which the batcher's worker needs between its launches
    def decode_canonical(body: bytes) -> np.ndarray:
        """'squarepad' pads to square with 255 on host (same arithmetic as
        the device SquarePad at source aspect) then resizes; 'plain'
        resizes directly."""
        with _DECODE_LOCK:
            im = decode_image(body)
            if transform == "squarepad":
                im = square_pad_host(im)
            im = resize_bilinear_host(im, (int(decode_hw[0]),
                                           int(decode_hw[1])))
        return im[None]

    backbone, tfm = stack.backbone, stack.tfm
    k = min(args.topk, len(idx))
    classes = idx._classes_on_device()
    idx._gallery_on_device(args.matmul_dtype)   # resident before requests

    def search_fn(xs, nu):
        """Transform, embed, rank and dedup on the device, then one copy
        of the results to the host. Runs in the batcher's worker thread,
        which enters inference mode itself (grad mode is per thread)."""
        with torch.inference_mode():
            q = backbone.embed(tfm(xs)).float()
            vals, inds = idx._query_tensors(
                q, k, args.method, args.matmul_dtype, None, args.precision,
                args.shortlist)
            if nu:
                inds, vals, cls = M.unique_class_dedup(inds, vals, classes,
                                                       num_unique=nu)
            else:
                cls = classes[inds]
            host = torch.cat([vals.double(), inds.double(), cls.double()],
                             dim=1).cpu().numpy()
        n = vals.shape[1]
        return _records(host[:, :n], host[:, n:2 * n].astype(np.int64),
                        host[:, 2 * n:].astype(np.int64), idx.paths)

    batcher = _MicroBatcher(search_fn, max_batch=args.max_batch)

    class Handler(BaseHTTPRequestHandler):
        # socket timeout: a client that declares a Content-Length but
        # trickles (or withholds) the body must not pin a handler thread
        # and its buffers forever — the slow-body variant of the
        # unbounded-buffering DoS _MAX_BODY_BYTES caps
        timeout = 30

        def log_message(self, fmt, *a):       # stderr, not stdout
            sys.stderr.write("serve: " + fmt % a + "\n")

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._json(200, {"ok": True, "items": len(idx),
                                 "dim": idx.dim})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if not self.path.startswith("/search"):
                self._json(404, {"error": "unknown path"})
                return
            try:
                qs = parse_qs(urlparse(self.path).query)
                # the search always runs at the server-configured k; a
                # client k only truncates the response. num_unique is
                # clamped to [1, server default], bounding the batch
                # groups the worker splits a drain into.
                k_req = max(1, min(int(qs.get("k", [args.topk])[0]),
                                   args.topk))
                # num_unique=0 from the client selects the raw (non-dedup)
                # ranking even when the server default dedups; nonzero
                # values are clamped to [1, server default]
                nu_req = min(int(qs.get("num_unique",
                                        [args.num_unique])[0]),
                             args.num_unique)
                nu_req = max(0, nu_req)
                n = int(self.headers.get("Content-Length", 0))
                if n > _MAX_BODY_BYTES:
                    self._json(413, {"error": "body too large "
                               f"({n} > {_MAX_BODY_BYTES} bytes)"})
                    return
                if n <= 0:
                    # a negative Content-Length would turn rfile.read(n)
                    # into read-until-EOF — exactly the unbounded buffering
                    # the size cap exists to prevent
                    self._json(400, {"error": "missing or invalid "
                                              "Content-Length"})
                    return
                x = decode_canonical(self.rfile.read(n))
                # concurrent requests coalesce into one device dispatch
                rec = batcher.submit(x, nu_req)
                if not nu_req:         # raw ranking: honor client k by cut
                    rec = {key: (v[:k_req] if isinstance(v, list) else v)
                           for key, v in rec.items()}
                self._json(200, rec)
            except RuntimeError as e:
                # server-side faults (CUDA errors surface as RuntimeError;
                # a stopped micro-batcher too): 503 so monitors and
                # retry-on-5xx clients see a sick server, not a client
                # mistake
                self._json(503, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:     # noqa: BLE001 — report, keep serving
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

    class _Server(ThreadingHTTPServer):
        def server_close(self):
            super().server_close()
            batcher.stop()         # don't leak the worker thread (and the
            #                        model/gallery it pins) per server

    srv = _Server((args.host, args.port), Handler)
    srv.batcher = batcher          # observability: requests vs dispatches
    return srv


def run(args: argparse.Namespace) -> None:
    if args.cmd == "info":
        # a description of the host arrays: no device involved
        idx = GalleryIndex.load(args.gallery, device="cpu")
        print(json.dumps({"items": len(idx), "dim": idx.dim,
                          "classes": int(idx.classes.max()) + 1
                          if len(idx) else 0,
                          "meta": idx.meta}, indent=2))
        return
    if args.cmd == "build":
        _build(args)
        return
    if args.cmd == "serve":
        _serve(args)
        return

    idx = GalleryIndex.load(args.gallery, device=resolve_device(args.device))
    paths = _collect_images(args.images)
    print(f"{len(paths)} query images", file=sys.stderr)
    embed_fn, transform = _load_stack(args, idx)[:2]
    if args.host_size is None:
        # replay the artifact's build-time host resize so query embeddings
        # take the same resampler chain as the gallery's (see _build meta)
        args.host_size = idx.meta.get("host_size")

    embeds = []
    for i in range(0, len(paths), args.batch_size):
        x = _decode(paths[i:i + args.batch_size], args.host_size,
                    squarepad=transform == "squarepad")
        # pad the final partial batch to the full batch size (same trick
        # as _build): one batch shape, one cuDNN algorithm
        embeds.append(embed_fn(_pad_batch(x, args.batch_size))[:x.shape[0]])
    queries = np.concatenate(embeds)

    for qpath, rec in zip(paths, _rank(idx, queries, args)):
        print(json.dumps({"query": str(qpath), **rec}))


def main() -> None:
    run(build_parser().parse_args())


if __name__ == "__main__":
    main()
