"""Simple class-folder triple dataset — parity with the reference.

Counterpart of ``imageretrievalresearch_tpu/data/triple.py`` (decoding on
the port's ``data.decode``).

Layout (reference data/triplet_dataset.py:31-91)::

    <photo_root>/<class>/<image files>
    <sketch_root>/<class>/<sketch files>

``__getitem__`` returns ``{'P': photo, 'S': random same-class sketch,
'N': random other-class sketch, 'L': class index}`` — the dataset behind the
Swin triplet recipe (train/train_vit_triplet.py:47-48).
"""

from __future__ import annotations

import os

import numpy as np

from imageretrievalresearch_tpu_torch.data.decode import DecodeCacheMixin
from imageretrievalresearch_tpu_torch.data.splits import IMG_EXTS, seeded_holdout


def _is_image(path: str) -> bool:
    return (os.path.isfile(path)
            and os.path.splitext(path)[1].lower() in IMG_EXTS)


def find_classes(root: str) -> tuple[list[str], dict[str, int]]:
    """Sorted class-dir discovery (reference data/triplet_dataset.py:9-13)."""
    classes = [d for d in os.listdir(root)
               if os.path.isdir(os.path.join(root, d))]
    classes.sort()
    class_to_idx = {classes[i]: i for i in range(len(classes))}
    return classes, class_to_idx


def make_dataset(root: str) -> list[str]:
    """Image files under class dirs (reference data/triplet_dataset.py:16-28;
    filtered to the shared IMG_EXTS so a stray .DS_Store or nested directory
    doesn't crash decoding mid-epoch)."""
    images = []
    for cname in sorted(os.listdir(root)):
        c_path = os.path.join(root, cname)
        if os.path.isdir(c_path):
            for fname in sorted(os.listdir(c_path)):
                path = os.path.join(c_path, fname)
                if _is_image(path):
                    images.append(path)
    return images


class TripleDataset(DecodeCacheMixin):
    """Reference data/triplet_dataset.py:31-91 with an explicit PRNG.

    The reference's negative pick has a quirk: it samples from
    ``set(listdir(sketch_root)) - set(cname)`` — subtracting the *characters*
    of the class name, not the class itself, so the same class can be drawn
    as a negative. We implement the intent (exclude the query class).
    """

    def __init__(self, photo_root: str, sketch_root: str,
                 transform=None, seed: int = 0, split: str = "all",
                 val_fraction: float = 0.2, load_images: bool = False,
                 cache_size: int | None = None,
                 cache_store: dict | None = None):
        """``split='train'|'val'`` holds out a seeded ``val_fraction`` of
        the photo queries (the reference T4 flow splits its TripleDataset
        with a fixed ``random_split([5000, 474])``,
        train/train_vit_triplet.py:52 — we generalize the ratio and pin
        the seed)."""
        if split not in ("all", "train", "val"):
            raise ValueError(f"split must be all|train|val, got {split!r}")
        self.transform = transform
        classes, class_to_idx = find_classes(photo_root)
        self.photo_root = photo_root
        self.sketch_root = sketch_root
        self.photo_paths = seeded_holdout(
            sorted(make_dataset(self.photo_root)), split,
            val_fraction=val_fraction, seed=seed)
        self.classes = classes
        self.class_to_idx = class_to_idx
        self.len = len(self.photo_paths)
        self._rng = np.random.default_rng(seed)
        # precompute per-class sketch lists (image files only)
        self._sketches = {
            c: sorted(f for f in os.listdir(os.path.join(sketch_root, c))
                      if _is_image(os.path.join(sketch_root, c, f)))
            for c in os.listdir(sketch_root)
            if os.path.isdir(os.path.join(sketch_root, c))
        }
        self._sketches = {c: fs for c, fs in self._sketches.items() if fs}
        self._sketch_classes = sorted(self._sketches)
        # fail at construction, not mid-epoch deep inside a training step:
        # every photo class needs same-class positives, and a negative
        # needs at least one OTHER sketch class to draw from
        photo_classes = {os.path.basename(os.path.dirname(p))
                         for p in self.photo_paths}
        missing = sorted(photo_classes - set(self._sketch_classes))
        if missing:
            raise ValueError(
                f"photo classes with no sketches under {sketch_root}: "
                f"{missing}")
        if photo_classes and len(self._sketch_classes) < 2:
            raise ValueError(
                "TripleDataset needs >= 2 sketch classes (negatives are "
                "drawn from a different class than the query)")
        # decode-once RAM cache (same -c / --cache surface as the other
        # dataset families): image_lst/sketch_lst are the path universes
        # the mixin eagerly decodes. The sketch universe is the WHOLE tree
        # regardless of split (positives/negatives are drawn by class, not
        # by holdout), so sibling train/val instances should share one
        # ``cache_store`` to avoid decoding + holding it twice.
        self.image_lst = list(self.photo_paths)
        self.sketch_lst = [os.path.join(sketch_root, c, f)
                           for c, files in self._sketches.items()
                           for f in files]
        self._init_decode_cache(load_images, cache_size, cache_store)

    def __len__(self) -> int:
        return self.len

    def get_cat_length(self) -> int:
        """Number of classes (name parity with the other datasets so the
        train CLI sizes the classifier head uniformly)."""
        return len(self.classes)

    def _getrelate_sketch(self, photo_path: str,
                          rng: np.random.Generator) -> tuple[str, str, int]:
        cname = os.path.basename(os.path.dirname(photo_path))
        label = self.class_to_idx[cname]
        # random negative class != query class, then random file within it —
        # from the precomputed per-class lists (the reference re-lists the
        # directory per sample, data/triplet_dataset.py:75-79; a per-sample
        # disk scan on the training hot path buys nothing)
        items = [c for c in self._sketch_classes if c != cname]
        neg_cls = items[rng.integers(0, len(items))]
        files = self._sketches[neg_cls]
        neg = os.path.join(self.sketch_root, neg_cls,
                           files[rng.integers(0, len(files))])
        # random positive sketch from the same class folder
        sketchs = self._sketches[cname]
        sketch = sketchs[rng.integers(0, len(sketchs))]
        return os.path.join(self.sketch_root, cname, sketch), neg, label

    def __getitem__(self, index: int,
                    rng: np.random.Generator | None = None) -> dict:
        rng = rng or self._rng
        photo_path = self.photo_paths[index]
        sketch_path, neg_path, label = self._getrelate_sketch(photo_path, rng)
        photo = self._decode(photo_path)
        sketch = self._decode(sketch_path)
        neg = self._decode(neg_path)
        if self.transform is not None:
            photo, sketch, neg = (self.transform(photo), self.transform(sketch),
                                  self.transform(neg))
        return {"P": photo, "S": sketch, "N": neg, "L": label}
