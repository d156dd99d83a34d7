"""Synthetic on-disk mini-datasets in each reference layout, for tests/benches.

Counterpart of ``imageretrievalresearch_tpu/data/synthetic.py``: the same
paths, the same draws from the same seeds and the same pixels, written
without PIL — PNG through ``data.decode.encode_png`` (``zlib``), JPEG
through ``data.jpeg.encode_jpeg`` at PIL's ``save`` defaults, so each file
decodes to the array PIL's file of the JAX tree decodes to.

Generates tiny valid directory trees so the data layer, loaders, trainers and
CLI are exercised end-to-end without the real Sketchy DB
(SURVEY.md Stage 0: "fake on-disk mini-dataset generating the Sketchy
directory layout").
"""

from __future__ import annotations

import os

import numpy as np

from imageretrievalresearch_tpu_torch.data.decode import (
    encode_png,
    resize_bilinear_host,
)
from imageretrievalresearch_tpu_torch.data.jpeg import encode_jpeg


def _save(path: str, arr: np.ndarray) -> None:
    """``Image.fromarray(arr).save(path)``: the format by the suffix."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jpg", ".jpeg"):
        data = encode_jpeg(arr)
    elif ext == ".png":
        data = encode_png(arr)
    else:
        raise ValueError(f"no writer for {ext!r} (PNG and JPEG only)")
    with open(path, "wb") as f:
        f.write(data)


def _write_im(path: str, rng: np.random.Generator, size: int = 64) -> None:
    arr = rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
    _save(path, arr)


def _class_base(cat: int, prod: int, size: int) -> np.ndarray:
    """Deterministic low-frequency class pattern: a 4x4 random field per
    (cat, prod) upsampled to (size, size, 3). Gives synthetic trees a
    LEARNABLE class signal (pure-noise trees make any two frameworks agree
    trivially at chance on held-out data)."""
    rng = np.random.default_rng(991 + 1000 * cat + prod)
    low = rng.integers(30, 226, size=(4, 4, 3), dtype=np.uint8)
    return resize_bilinear_host(low, (size, size)).astype(np.float32)


def _write_structured(path: str, rng: np.random.Generator, size: int,
                      cat: int, prod: int, *, sketch: bool) -> None:
    base = _class_base(cat, prod, size)
    if sketch:
        # the sketch domain shares the class structure through a global
        # transform (inversion) — retrieval across domains is learnable
        # but not an identity shortcut
        base = 255.0 - base
    noise = rng.normal(0.0, 28.0, size=(size, size, 3))
    arr = np.clip(base + noise, 0, 255).astype(np.uint8)
    _save(path, arr)


def make_sketchy_tree(root: str, *, n_cats: int = 3, n_prods: int = 2,
                      n_photos: int = 3, n_sketches: int = 3,
                      size: int = 64, seed: int = 0,
                      structured: bool = False) -> str:
    """Sketchy layout: photo|sketch/tx_000000000000/<cat>/<prod>-N.{jpg,png}.

    (reference data/sketch_dataset.py:36-38, :140-142)

    ``structured=True`` draws each image from a per-(cat, prod) low-frequency
    pattern + noise (sketches inverted) so held-out retrieval metrics are
    learnable above chance — the convergence-parity harness needs a live
    quality signal, not noise memorization.
    """
    rng = np.random.default_rng(seed)
    for c in range(n_cats):
        cat = f"cat{c}"
        for p in range(n_prods):
            prod = f"n{c:02d}{p:02d}"
            for i in range(n_photos):
                path = os.path.join(root, "photo", "tx_000000000000",
                                    cat, f"{prod}-{i}.jpg")
                if structured:
                    _write_structured(path, rng, size, c, p, sketch=False)
                else:
                    _write_im(path, rng, size)
            for i in range(n_sketches):
                path = os.path.join(root, "sketch", "tx_000000000000",
                                    cat, f"{prod}-{i}.png")
                if structured:
                    _write_structured(path, rng, size, c, p, sketch=True)
                else:
                    _write_im(path, rng, size)
    return root


def make_original_tree(root: str, *, n_cats: int = 2, n_prods: int = 2,
                       n_photos: int = 2, n_sketches: int = 2,
                       size: int = 64, seed: int = 0) -> str:
    """Original/spec layout: <cat>/<prod_dir>/... + <cat>/pdf_detail/<sketch>.

    Photo prod parse: dir ``split('_')[-2]`` (original_dataset.py:64,:273);
    sketch prod parse: file ``split('_')[-2]`` of third component (:281).
    """
    rng = np.random.default_rng(seed)
    for c in range(n_cats):
        cat = f"spec{c}"
        for p in range(n_prods):
            prod_dir = f"item_{c}{p}_v1"   # prod id = {c}{p}
            for i in range(n_photos):
                _write_im(os.path.join(root, cat, prod_dir, f"im{i}.jpg"),
                          rng, size)
            for i in range(n_sketches):
                _write_im(os.path.join(root, cat, "pdf_detail",
                                       f"sk_{c}{p}_{i}.png"), rng, size)
    return root


def make_soft_tree(root: str, *, n_cats: int = 2, n_prods: int = 2,
                   n_imgs: int = 3, size: int = 64, seed: int = 0) -> str:
    """Soft layout: real|sketch/<cat>/<name>_<prod>_N.ext (softdataset.py:142-146)."""
    rng = np.random.default_rng(seed)
    for kind in ("real", "sketch"):
        for c in range(n_cats):
            cat = f"c{c}"
            for p in range(n_prods):
                for i in range(n_imgs):
                    _write_im(os.path.join(root, kind, cat,
                                           f"x_{c}{p}_{i}.png"), rng, size)
    return root


def make_classfolder_tree(root: str, *, n_classes: int = 3, n_photos: int = 3,
                          n_sketches: int = 3, size: int = 64,
                          seed: int = 0) -> tuple[str, str]:
    """Class-folder layout for TripleDataset: photo|sketch roots with class dirs."""
    rng = np.random.default_rng(seed)
    photo_root = os.path.join(root, "photo")
    sketch_root = os.path.join(root, "sketch")
    for c in range(n_classes):
        cls = f"class{c}"
        for i in range(n_photos):
            _write_im(os.path.join(photo_root, cls, f"p{i}.jpg"), rng, size)
        for i in range(n_sketches):
            _write_im(os.path.join(sketch_root, cls, f"s{i}.png"), rng, size)
    return photo_root, sketch_root


def make_imagefolder_tree(root: str, *, n_classes: int = 3,
                          n_images: int = 4, size: int = 64, seed: int = 0,
                          structured: bool = False) -> str:
    """torchvision-ImageFolder layout for the T5 classifier: one subfolder
    per class (reference train/train_vit_crossentropy.py:50).

    ``structured=True`` gives each class a learnable low-frequency pattern
    (same generator as :func:`make_sketchy_tree`) so held-out top-1 is a
    live quality signal for the convergence-parity harness.
    """
    rng = np.random.default_rng(seed)
    for c in range(n_classes):
        cls = f"class{c}"
        for i in range(n_images):
            path = os.path.join(root, cls, f"im{i}.jpg")
            if structured:
                _write_structured(path, rng, size, c, 0, sketch=False)
            else:
                _write_im(path, rng, size)
    return root
