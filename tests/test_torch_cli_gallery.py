"""The port's gallery CLI (``cli/gallery.py``) on the CPU (``--device
cpu``), held against the JAX CLI on one tiny PNG tree, and the JAX CLI's
own tests (``tests/test_cli_gallery.py``) carried over to the port.

Parity: 3 classes x 8 seeded 32 px PNGs; both CLIs get ``-mn
efficientnet_b0 -is 32 -bs 8`` and the same ``-cp`` file, a seeded port
model's ``net.state_dict()`` saved with ``torch.save`` (JAX reads it
through its own converter). The JAX CLI runs once, in a module-scoped
fixture: build, then query of its own artifact (deduplicated and raw) and
of the port's. Rankings agree except at near-ties (``assert_rankings``)."""

import contextlib
import functools
import http.client
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from imageretrievalresearch_tpu.cli.gallery import build_parser as jax_parser
from imageretrievalresearch_tpu.cli.gallery import run as jax_run
from imageretrievalresearch_tpu.models.backbone import Backbone as JaxBackbone
from imageretrievalresearch_tpu_torch import models as port_models
from imageretrievalresearch_tpu_torch.cli import gallery as G
from imageretrievalresearch_tpu_torch.cli.gallery import (
    _MicroBatcher,
    _make_server,
    build_parser,
    run,
)
from imageretrievalresearch_tpu_torch.models import create_model
from imageretrievalresearch_tpu_torch.retrieval import GalleryIndex
from test_torch_decode import bomb_pngs

CPU = ["--device", "cpu"]
MODEL = ["-mn", "efficientnet_b0", "-is", "32", "-bs", "8"]
# records round scores to 5 decimals (5e-6 each way); the two packages'
# embeddings of one image differ by ~1e-5 in cosine, so scores agree
# within 5e-5, and a ranked pair may swap only where the reference ranks
# two scores within 1e-4 of each other (a near-tie); at most 2 positions
# of the 72 ranked (raw: 240) may swap
SCORE_ATOL, TIE_ATOL, MAX_SWAPS = 5e-5, 1e-4, 2


def _image(rng, c, h=32, w=32):
    """Noise with one strong channel per class and a bright square, so the
    classes embed apart."""
    im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    im[..., c % 3] = 200
    y, x = rng.integers(0, h // 2), rng.integers(0, w // 2)
    im[y:y + h // 3, x:x + w // 3] = 255
    return im


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(21)
    for c in range(3):
        (root / "tree" / f"cat{c}").mkdir(parents=True)
        for i in range(8):
            Image.fromarray(_image(rng, c)).save(
                root / "tree" / f"cat{c}" / f"{i}.png")
    ckpt = root / "b0.pt"
    torch.save(create_model("efficientnet_b0", num_classes=3, device="cpu",
                            seed=3).net.state_dict(), ckpt)
    return {"root": root, "tree": str(root / "tree"), "ckpt": str(ckpt)}


def _lines(fn, argv) -> list[dict]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def port(*argv):
    return _lines(lambda a: run(build_parser().parse_args(a)), list(argv))


def info(npz) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(build_parser().parse_args(["info", npz]))
    return json.loads(buf.getvalue())


def jax_cli(*argv):
    return _lines(lambda a: jax_run(jax_parser().parse_args(a)), list(argv))


@pytest.fixture(scope="module")
def artifact(tree):
    """The port's float32 artifact of the tree, built once with the
    checkpoint (its meta records it, so queries load it too)."""
    gt = str(tree["root"] / "port.npz")
    port("build", gt, tree["tree"], *MODEL, "-cp", tree["ckpt"], *CPU)
    return gt


def _jitted_init(init):
    """JAX's loader runs ``Backbone.init`` eagerly (hundreds of one-op
    compiles, most of a minute for b0 on a CPU) before its strict
    conversion replaces every value the init made. The same init under
    jit, compiled once per model name, gives the CLI the same variables
    (the artifact is bit-identical) in a fraction of the time."""
    compiled = {}

    def wrapper(self, rng, sample):
        if self.name not in compiled:
            compiled[self.name] = jax.jit(functools.partial(init, self))
        return compiled[self.name](rng, sample)

    return wrapper


@pytest.fixture(scope="module")
def parity(tree, artifact):
    """The JAX CLI once: build, query its artifact (dedup and raw) and the
    port's artifact; the port queries the same."""
    root, images, ck = tree["root"], tree["tree"], tree["ckpt"]
    gj, gt = str(root / "jax.npz"), artifact
    dedup = ["-k", "24", "--num_unique", "3", "-bs", "8"]
    raw = ["-k", "10", "--num_unique", "0", "-bs", "8"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBackbone, "init", _jitted_init(JaxBackbone.init))
        jax_cli("build", gj, images, *MODEL, "-cp", ck)
        runs = {"jax_on_jax": jax_cli("query", gj, images, *dedup),
                "jax_on_jax_raw": jax_cli("query", gj, images, *raw),
                "jax_on_port": jax_cli("query", gt, images, *dedup)}
    return {"gj": gj, "gt": gt, **runs,
            "port_on_jax": port("query", gj, images, *dedup, *CPU),
            "port_on_jax_raw": port("query", gj, images, *raw, *CPU)}


def assert_rankings(recs, refs):
    """Same queries; scores within SCORE_ATOL position by position;
    indices, classes and paths equal except where the reference ranks a
    neighbour within TIE_ATOL (a near-tie), at most MAX_SWAPS times."""
    assert [r["query"] for r in recs] == [r["query"] for r in refs]
    swaps = 0
    for rec, ref in zip(recs, refs):
        s, rs = np.array(rec["scores"]), np.array(ref["scores"])
        assert s.shape == rs.shape
        np.testing.assert_allclose(s, rs, rtol=0, atol=SCORE_ATOL)
        for j, (i, ri) in enumerate(zip(rec["indices"], ref["indices"])):
            if i == ri:
                assert rec["classes"][j] == ref["classes"][j]
                assert rec["paths"][j] == ref["paths"][j]
                continue
            swaps += 1
            assert any(abs(rs[j] - rs[m]) <= TIE_ATOL for m in (j - 1, j + 1)
                       if 0 <= m < len(rs)), (rec["query"], j)
    assert swaps <= MAX_SWAPS, swaps


def test_port_query_of_jax_artifact_matches_jax(parity):
    assert len(parity["jax_on_jax"]) == 24
    assert all(len(r["indices"]) == 3 for r in parity["jax_on_jax"])
    assert_rankings(parity["port_on_jax"], parity["jax_on_jax"])
    assert all(len(r["indices"]) == 10 for r in parity["jax_on_jax_raw"])
    assert_rankings(parity["port_on_jax_raw"], parity["jax_on_jax_raw"])


def test_jax_query_of_port_artifact_matches_jax(parity):
    assert_rankings(parity["jax_on_port"], parity["jax_on_jax"])


def test_artifacts_of_both_clis_agree(parity):
    gj = GalleryIndex.load(parity["gj"], device="cpu")
    gt = GalleryIndex.load(parity["gt"], device="cpu")
    assert gt.meta == gj.meta
    assert list(gt.meta) == list(gj.meta)
    assert gt.paths == gj.paths
    np.testing.assert_array_equal(gt.classes, gj.classes)
    np.testing.assert_allclose(gt.embeddings, gj.embeddings, rtol=0,
                               atol=1e-4)


def _build(tree, out, *extra):
    port("build", out, tree["tree"], *MODEL, *CPU, *extra)
    return out


def test_build_info_query_roundtrip(tree, artifact):
    npz = artifact
    desc = info(npz)
    assert desc["items"] == 24 and desc["meta"]["model"] == "efficientnet_b0"

    photos = [f"{tree['tree']}/cat{c}/0.png" for c in range(3)]
    lines = port("query", npz, *photos, "-bs", "4", "-k", "24",
                 "--num_unique", "2", "--matmul_dtype", "bfloat16", *CPU)
    assert len(lines) == 3
    for rec in lines:
        assert len(rec["indices"]) == 2          # num_unique dedup
        assert len(set(rec["classes"])) == 2     # distinct classes
        assert all(0 <= i < desc["items"] for i in rec["indices"])
        assert all(np.isfinite(rec["scores"]))

    # the certified capacity mode + its knobs through the same CLI
    rr = port("query", npz, *photos, "-bs", "4", "-k", "8", "--num_unique",
              "2", "--matmul_dtype", "int8_rerank", "--shortlist", "12",
              *CPU)
    hi = port("query", npz, *photos, "-bs", "4", "-k", "8", "--num_unique",
              "2", "--precision", "highest", *CPU)
    assert len(rr) == 3 and len(hi) == 3
    for rec_r, rec_h in zip(rr, hi):
        assert len(rec_r["indices"]) == 2
        assert all(np.isfinite(rec_r["scores"]))
        # the re-rank and the true-f32 ranking agree on the top hit
        assert rec_r["indices"][0] == rec_h["indices"][0]


def test_artifact_records_architecture_and_load_stack_uses_it(
        artifact, monkeypatch):
    npz = artifact
    idx = GalleryIndex.load(npz, device="cpu")
    assert idx.meta["num_classes"] == 3
    assert idx.meta["conv_input"] is False
    real_create = port_models.create_model
    captured = {}

    def spy(name, **kw):
        captured.update(kw, model=name)
        return real_create(name, **kw)

    monkeypatch.setattr(port_models, "create_model", spy)
    args = build_parser().parse_args(["query", npz, "x.png", "-bs", "4",
                                      *CPU])
    stack = G._load_stack(args, idx)
    assert captured["num_classes"] == 3
    assert captured["conv_input"] is False
    assert captured["model"] == "efficientnet_b0"
    assert stack.transform == "squarepad" and stack.input_size == 32
    # an artifact of another width than the model's is refused up front
    other = GalleryIndex(64, device="cpu", meta=dict(idx.meta,
                                                     checkpoint=""))
    other.add(np.ones((2, 64), np.float32), [0, 1])
    with pytest.raises(SystemExit, match="embeds dim 1280"):
        G._load_stack(args, other)


def test_build_from_image_tree_records_paths_and_classes(tree, tmp_path):
    npz = _build(tree, str(tmp_path / "built.npz"), "--gallery_dtype",
                 "bfloat16")
    desc = info(npz)
    assert desc["items"] == 24 and desc["classes"] == 3
    assert desc["meta"]["class_names"] == ["cat0", "cat1", "cat2"]
    assert desc["meta"]["num_classes"] == 3
    photos = [f"{tree['tree']}/cat1/{i}.png" for i in range(2)]
    lines = port("query", npz, *photos, "-bs", "4", "-k", "24",
                 "--num_unique", "2", *CPU)
    assert len(lines) == 2
    for rec in lines:
        assert rec["paths"] is not None
        assert all(p.startswith(tree["tree"]) for p in rec["paths"])


def _post(base, body, query="", timeout=60):
    req = urllib.request.Request(base + "/search" + query, data=body,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _status(port_, method, path, length):
    conn = http.client.HTTPConnection("127.0.0.1", port_, timeout=30)
    conn.putrequest(method, path, skip_accept_encoding=True)
    if length is not None:
        conn.putheader("Content-Length", str(length))
    conn.endheaders()
    status = conn.getresponse().status
    conn.close()
    return status


def test_serve_endpoint(tree, tmp_path):
    """build -> serve -> /healthz -> POST /search with a raw PNG body; the
    clamps, 404, 413 and 400 (decompression bombs too); then the float32
    form on a fresh server.
    A served record equals the query CLI's for the same file."""
    npz = _build(tree, str(tmp_path / "gal.npz"), "--gallery_dtype", "int8")
    srv = _make_server(build_parser().parse_args(
        ["serve", npz, "--port", "0", "-k", "24", "--num_unique", "2",
         "--matmul_dtype", "int8", *CPU]))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    photo = f"{tree['tree']}/cat2/3.png"
    body = open(photo, "rb").read()
    try:
        port_ = srv.server_address[1]
        base = f"http://127.0.0.1:{port_}"
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health == {"ok": True, "items": 24, "dim": 1280}

        rec = _post(base, body, "?num_unique=2")
        assert len(rec["indices"]) == 2
        assert len(set(rec["classes"])) == 2
        # one image in a batch of one, as serve embeds it
        queried = port("query", npz, photo, "-k", "24", "--num_unique", "2",
                       "--matmul_dtype", "int8", "-bs", "1", *CPU)[0]
        assert rec == {key: queried[key] for key in rec}

        # client k/num_unique are CLAMPED to the server config
        assert len(_post(base, body, "?k=9999&num_unique=50")["indices"]) <= 2
        # num_unique=0 selects the raw ranking; client k truncates it
        raw = _post(base, body, "?num_unique=0&k=3")
        assert len(raw["indices"]) == 3
        assert raw["scores"] == sorted(raw["scores"], reverse=True)

        assert _status(port_, "GET", "/nope", None) == 404
        assert _status(port_, "POST", "/nope", 0) == 404
        # oversized Content-Length -> 413 before the body is buffered
        assert _status(port_, "POST", "/search", 64 * 1024 * 1024) == 413
        # negative Content-Length -> 400, not read-until-EOF
        assert _status(port_, "POST", "/search", -1) == 400
        # a malformed body, a JPEG and decompression bombs -> structured
        # 400, server stays up
        jpeg = io.BytesIO()
        Image.open(photo).convert("RGB").save(jpeg, format="JPEG")
        bombs = bomb_pngs()
        for bad, why in ((b"not-an-img", "not a PNG"),
                         (jpeg.getvalue(), "no JPEG decoder"),
                         (bombs["inflates_past_ihdr"], "inflates past"),
                         (bombs["too_many_pixels"], "decompression bomb")):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base, bad)
            assert e.value.code == 400
            assert why in json.loads(e.value.read())["error"]
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["ok"]
    finally:
        srv.shutdown()
        srv.server_close()

    # the default float32 form, with serve's --precision and --shortlist
    srv2 = _make_server(build_parser().parse_args(
        ["serve", npz, "--port", "0", "-k", "8", "--num_unique", "2",
         "--precision", "highest", *CPU]))
    threading.Thread(target=srv2.serve_forever, daemon=True).start()
    try:
        rec = _post(f"http://127.0.0.1:{srv2.server_address[1]}", body)
        assert len(rec["indices"]) == 2
        assert all(np.isfinite(rec["scores"]))
    finally:
        srv2.shutdown()
        srv2.server_close()
    args = build_parser().parse_args(["serve", npz, "--matmul_dtype",
                                      "int8_rerank", "--shortlist", "12"])
    assert (args.shortlist, args.precision) == (12, "default")


def test_serve_rejects_empty_gallery(tmp_path):
    art = str(tmp_path / "empty.npz")
    GalleryIndex(8, device="cpu").save(art)
    with pytest.raises(SystemExit, match="empty"):
        _make_server(build_parser().parse_args(
            ["serve", art, "--port", "0", *CPU]))


def test_microbatcher_coalesces_concurrent_requests():
    def slow_search(xs, nu):
        time.sleep(0.15)           # hold the worker so requests pile up
        return [{"marker": float(x[0, 0, 0]), "nu": nu} for x in xs]

    b = _MicroBatcher(slow_search, max_batch=8)
    results = {}

    def post(i):
        x = np.full((1, 2, 2, 3), i, np.uint8)
        results[i] = b.submit(x, 1 if i % 2 else 0)

    threads = [threading.Thread(target=post, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(results) == 6
    for i, rec in results.items():
        assert rec["marker"] == float(i)
        assert rec["nu"] == (1 if i % 2 else 0)
    assert b.requests == 6
    assert b.dispatches < 6
    b.stop()
    assert not b._thread.is_alive()
    with pytest.raises(RuntimeError, match="stopped"):
        b.submit(np.zeros((1, 2, 2, 3), np.uint8), 0)


def test_submit_relays_worker_errors():
    def bad_search(xs, nu):
        raise RuntimeError("boom")

    b = _MicroBatcher(bad_search, max_batch=4)
    with pytest.raises(RuntimeError, match="boom"):
        b.submit(np.zeros((1, 2, 2, 3), np.uint8), 0)
    b.stop()


def test_worker_death_releases_inflight_and_future_submits():
    def dying_search(xs, nu):
        raise SystemExit(3)

    b = _MicroBatcher(dying_search, max_batch=4)
    with pytest.raises(RuntimeError, match="died"):
        b.submit(np.zeros((1, 2, 2, 3), np.uint8), 0)
    b._thread.join(timeout=10)
    assert not b._thread.is_alive()
    with pytest.raises(RuntimeError, match="stopped"):
        b.submit(np.zeros((1, 2, 2, 3), np.uint8), 0)


def test_release_pending_preserves_stop_sentinel():
    gate = threading.Event()

    def gated_search(xs, nu):
        gate.wait(timeout=30)
        return [{"ok": True} for _ in xs]

    b = _MicroBatcher(gated_search, max_batch=4)
    t = threading.Thread(
        target=lambda: b.submit(np.zeros((1, 2, 2, 3), np.uint8), 0))
    t.start()
    deadline = time.time() + 5.0
    while not b._q.empty() and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.05)
    b._stopped = True
    b._q.put(None)
    slot = {"x": np.zeros((1, 2, 2, 3), np.uint8), "nu": 0,
            "ev": threading.Event()}
    b._q.put(slot)
    b._release_pending()
    assert isinstance(slot.get("err"), RuntimeError)
    assert slot["ev"].is_set()
    gate.set()
    t.join(timeout=10)
    b._thread.join(timeout=10)
    assert not b._thread.is_alive(), "worker leaked: sentinel swallowed"
    b.stop()


def test_concurrent_posts_all_answered(tree, artifact):
    npz = artifact
    srv = _make_server(build_parser().parse_args(
        ["serve", npz, "--port", "0", "-k", "24", "--num_unique", "2",
         *CPU]))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        body = open(f"{tree['tree']}/cat0/1.png", "rb").read()
        out, errs = {}, []

        def post(i):
            try:
                out[i] = _post(base, body, timeout=120)
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errs, errs
        assert len(out) == 5
        for rec in out.values():
            assert rec == out[0] and len(rec["indices"]) == 2
        assert srv.batcher.requests == 5
    finally:
        srv.shutdown()
        srv.server_close()
        assert not srv.batcher._thread.is_alive()


def test_query_rejects_mixed_resolutions(tree, tmp_path):
    big = tmp_path / "big.png"
    Image.fromarray(np.zeros((64, 48, 3), np.uint8)).save(big)
    paths = G._collect_images([f"{tree['tree']}/cat0/0.png", str(big)])
    with pytest.raises(SystemExit, match="mixed resolutions"):
        G._decode(paths, None)
    assert G._decode(paths, 32).shape == (2, 32, 32, 3)


def test_query_refuses_jpeg_and_approx(tree, artifact, tmp_path):
    npz = artifact
    jpg = tmp_path / "q.jpg"
    Image.open(f"{tree['tree']}/cat0/0.png").convert("RGB").save(jpg)
    with pytest.raises(ValueError, match="no JPEG decoder"):
        port("query", npz, str(jpg), *CPU)
    with pytest.raises(NotImplementedError, match="approx"):
        port("query", npz, f"{tree['tree']}/cat0/0.png", "--method",
             "approx", *CPU)


@pytest.mark.parametrize("cmd", ["build", "query", "serve"])
def test_cli_defaults_to_the_card(cmd, tree, artifact, tmp_path,
                                  monkeypatch):
    """Without a GPU and without --device cpu the CLI raises; it never
    carries on quietly on the CPU."""
    npz = artifact
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"build": ["build", str(tmp_path / "b.npz"), tree["tree"],
                      *MODEL],
            "query": ["query", npz, f"{tree['tree']}/cat0/0.png"],
            "serve": ["serve", npz, "--port", "0"]}[cmd]
    call = (_make_server if cmd == "serve" else run)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(build_parser().parse_args(argv))
    out = call(build_parser().parse_args(argv + CPU))
    if cmd == "serve":
        out.server_close()
