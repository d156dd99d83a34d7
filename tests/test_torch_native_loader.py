"""The port's decode pool (``data/native_loader.py``) and
``TripletLoader(use_native=True)`` on the CPU; the spec is
tests/test_native_loader.py. One pool of 2 processes serves the module's
direct calls; each loader pass starts its own pool of ``num_workers`` (2).

Tolerances: none. The pool runs the in-process decoders (``decode_image``
+ ``resize_bilinear_host``), so its batches are compared bitwise."""

import glob
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from imageretrievalresearch_tpu_torch.cli import data_split as split_cli
from imageretrievalresearch_tpu_torch.cli import find_lr as find_lr_cli
from imageretrievalresearch_tpu_torch.cli import train as train_cli
from imageretrievalresearch_tpu_torch.data import (
    SketchyImageDataset,
    TripletLoader,
    decode_image,
    native_loader,
    resize_bilinear_host,
)
from imageretrievalresearch_tpu_torch.data.synthetic import make_sketchy_tree

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_sketchy_tree(str(tmp_path_factory.mktemp("sk")), n_cats=3,
                             n_prods=2, n_photos=4, n_sketches=4, size=48)


@pytest.fixture(scope="module")
def pool():
    with native_loader.DecodePool(2) as p:
        yield p.start()


def _files(tree, ext):
    return sorted(glob.glob(os.path.join(tree, f"**/*.{ext}"),
                            recursive=True))


def _interlaced_png(path, img):
    """An Adam7-interlaced RGB PNG (filter None), written by hand: Pillow
    reads such files but does not write them."""
    h, w = img.shape[:2]
    raw = bytearray()
    for xs, ys, xt, yt in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                           (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        for row in img[ys::yt, xs::xt]:
            if row.size:
                raw += b"\0" + row.tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1))
                + chunk(b"IDAT", zlib.compress(bytes(raw)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("size", [48, 32])
def test_pool_batch_is_the_in_process_decode(tree, pool, tmp_path, size):
    """JPEG photos and PNG sketches at their size (48) and resized (32),
    and an Adam7-interlaced PNG (decoded as PIL decodes it)."""
    img = np.random.default_rng(7).integers(0, 256, (48, 40, 3),
                                            dtype=np.uint8)
    inter = str(tmp_path / "interlaced.png")
    _interlaced_png(inter, img)
    with Image.open(inter) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), img)
    np.testing.assert_array_equal(decode_image(inter), img)
    paths = _files(tree, "jpg")[:4] + _files(tree, "png")[:4] + [inter]
    out = native_loader.decode_resize_batch(paths, size, size, pool=pool)
    ref = np.stack([resize_bilinear_host(decode_image(p), (size, size))
                    for p in paths])
    assert out.shape == (9, size, size, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)
    assert pool.pids and os.getpid() not in pool.pids
    assert len(pool.pids) <= 2


def test_missing_file_fills_gray_and_strict_names_it(tree, pool):
    good = _files(tree, "jpg")[0]
    out = native_loader.decode_resize_batch(["/nonexistent/x.jpg", good],
                                            16, 16, pool=pool)
    assert (out[0] == native_loader.FILL).all()
    np.testing.assert_array_equal(
        out[1], resize_bilinear_host(decode_image(good), (16, 16)))
    with pytest.raises(IOError, match="1 of 2 images failed to decode: "
                                      "/nonexistent/x.jpg"):
        native_loader.decode_resize_batch(["/nonexistent/x.jpg", good], 16,
                                          16, strict=True, pool=pool)


def test_calls_without_a_pool(tree, monkeypatch):
    """A call without a pool starts one of ``num_threads`` processes; with
    no pool at all it decodes in this process (``allow_fallback``) or
    raises, as JAX's binding does without its .so."""
    paths = _files(tree, "png")[:3]
    ref = np.stack([resize_bilinear_host(decode_image(p), (24, 24))
                    for p in paths])
    np.testing.assert_array_equal(
        native_loader.decode_resize_batch(paths, 24, 24, num_threads=2), ref)
    monkeypatch.setattr(native_loader, "native_available", lambda: False)
    np.testing.assert_array_equal(
        native_loader.decode_resize_batch(paths, 24, 24), ref)
    with pytest.raises(RuntimeError, match="decode pool unavailable"):
        native_loader.decode_resize_batch(paths, 24, 24,
                                          allow_fallback=False)


def _pools(monkeypatch):
    """Record every DecodePool the loader starts (native_available's probe
    pool is made first, outside the record)."""
    assert native_loader.native_available()
    made = []

    class Recorded(native_loader.DecodePool):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(native_loader, "DecodePool", Recorded)
    return made


def test_native_batches_match_the_python_path(tree, monkeypatch):
    """Same seed and epoch: the same triplets (labels), and, the dataset
    doing nothing beyond decode and resize, the same pixels bit for bit;
    one pool of num_workers processes per pass, closed at its end."""
    made = _pools(monkeypatch)
    ds = SketchyImageDataset(data_dir=tree)
    kw = dict(batch_size=8, num_workers=2, seed=3, host_size=32)
    nat = TripletLoader(ds, use_native=True, **kw)
    py = TripletLoader(ds, use_native=False, **kw)
    assert nat.use_native
    for loader in (nat, py):
        loader.set_epoch(1)
    bn, bp = list(nat), list(py)
    assert len(bn) == len(bp) == len(nat) == 3
    for a, b in zip(bn, bp):
        assert a["qry"].shape == (8, 32, 32, 3) and a["qry"].dtype == np.uint8
        assert len(a["pos"]) == len(a["neg"]) == 1
        assert a["pos"][0].shape == a["neg"][0].shape == (8, 32, 32, 3)
        for key in ("cat_idx", "prod_idx", "qry"):
            np.testing.assert_array_equal(a[key], b[key])
        for key in ("pos", "neg"):
            np.testing.assert_array_equal(a[key][0], b[key][0])
    assert len(made) == 1 and made[0].size == 2
    assert 1 <= len(made[0].pids) <= 2 and not made[0]._procs


def test_falls_back_without_host_size(tree, capsys):
    ds = SketchyImageDataset(data_dir=tree)
    dl = TripletLoader(ds, batch_size=4, use_native=True)
    assert not dl.use_native
    assert ("use_native requested but falling back to the threaded decode "
            "path: host_size not set") in capsys.readouterr().out
    assert next(iter(dl))["qry"].shape[0] == 4


@pytest.fixture(scope="module")
def cli_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("clisk"))
    make_sketchy_tree(root, n_cats=3, n_prods=1, n_photos=8, n_sketches=4,
                      size=32)
    split = os.path.join(root, "split.json")
    split_cli.run(split_cli.build_parser().parse_args([
        "--data_dir", root, "--out_path", split, "--layout", "sketchy",
        "--policy", "cat", "--no-hard_split",
        "--split", "0.5", "0.25", "0.25"]))
    return {"root": root, "split": split}


@pytest.mark.parametrize("cli", [train_cli, find_lr_cli],
                         ids=["train", "find_lr"])
def test_cli_runs_with_use_native_loader(cli, cli_tree, tmp_path,
                                         monkeypatch):
    """``--use_native_loader`` reaches the loader, as in JAX: a tiny epoch
    (find_lr: a 3-step sweep) whose batches come from the decode pool."""
    made = _pools(monkeypatch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # a small model beside other test workers
    argv = ["--ims_path", cli_tree["root"], "--split_json", cli_tree["split"],
            "--model_name", "efficientnet_b0", "--batch_size", "4",
            "--image_size", "32", "--compute_dtype", "float32",
            "--num_workers", "2", "--max_epochs", "1", "-sp",
            str(tmp_path / "models"), "--use_native_loader", *CPU]
    if cli is find_lr_cli:
        argv += ["--num_lr_steps", "3"]
    try:
        out = cli.run(cli.build_parser().parse_args(argv))
    finally:
        torch.set_num_threads(threads)
    assert made and all(not p._procs for p in made)
    assert all(len(p.pids) >= 1 for p in made)
    if cli is train_cli:
        state, history = out
        assert state.step == 3 and len(history["epochs"]) == 1
        assert np.isfinite(history["epochs"][0]["train_loss"])
    else:
        assert len(out["losses"]) >= 1
