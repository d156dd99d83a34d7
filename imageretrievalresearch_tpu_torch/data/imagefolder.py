"""ImageFolder-style single-image classification dataset (T5 recipe).

Counterpart of ``imageretrievalresearch_tpu/data/imagefolder.py`` (decoding on
the port's ``data.decode``).

The reference's classification recipe trains on any class-per-subfolder
image tree via torchvision ``ImageFolder`` + an unseeded 80/20
``random_split`` (train/train_vit_crossentropy.py:18,50,59). This is that
capability, reshaped:

- classes = sorted subfolder names, samples sorted within each class
  (torchvision ImageFolder ordering);
- a SEEDED 80/20 permutation split (the reference's ``random_split`` draws
  from the global torch RNG before ``seed_everything`` runs, so its split
  is irreproducible — we pin it);
- items are raw uint8 HWC arrays + integer labels; all float conversion /
  resize happens fused on device (ops/preprocess.py), not per-sample on
  host.
"""

from __future__ import annotations

from pathlib import Path

from imageretrievalresearch_tpu_torch.data.decode import DecodeCacheMixin
from imageretrievalresearch_tpu_torch.data.splits import IMG_EXTS, seeded_holdout


class ImageFolderDataset(DecodeCacheMixin):
    """Single-image classification over a class-per-subfolder tree.

    Yields ``{'image': uint8 HWC, 'label': int}`` items; feed through
    :class:`~imageretrievalresearch_tpu_torch.data.loader.TripletLoader` (which
    collates single-image items into ``{'image': (B,H,W,3) u8,
    'label': (B,) i32}`` batches).

    Args:
      data_dir: root with one subfolder per class
        (reference train/train_vit_crossentropy.py:50 ``ImageFolder(path)``).
      split: ``'all'`` | ``'train'`` | ``'val'`` — train/val are a seeded
        ``val_fraction`` holdout of the same tree (reference :59
        ``random_split(ds, [int(0.8 n), rest])``).
      val_fraction: holdout fraction (reference: 0.2).
      seed: split permutation seed.
      load_images: decode-once RAM cache (the reference inference cache
        flag applied to training data).
      cache_size: host resize applied when caching (pairs with the
        loader's ``host_size``).
    """

    def __init__(self, data_dir: str, *, split: str = "all",
                 val_fraction: float = 0.2, seed: int = 42,
                 load_images: bool = False, cache_size: int | None = None):
        if split not in ("all", "train", "val"):
            raise ValueError(f"split must be all|train|val, got {split!r}")
        root = Path(data_dir)
        class_dirs = sorted(d for d in root.iterdir() if d.is_dir())
        if not class_dirs:
            raise ValueError(f"no class subfolders under {root}")
        self.classes = [d.name for d in class_dirs]
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        samples: list[tuple[str, int]] = []
        for ci, cdir in enumerate(class_dirs):
            for p in sorted(cdir.rglob("*")):
                if p.suffix.lower() in IMG_EXTS:
                    samples.append((str(p), ci))
        if not samples:
            raise ValueError(f"no images under {root}")

        self.samples = seeded_holdout(samples, split,
                                      val_fraction=val_fraction, seed=seed)
        self.split = split

        # decode + RAM cache shared with every other dataset family
        # (DecodeCacheMixin): image_lst is the eager-decode universe
        self.image_lst = [p for p, _ in self.samples]
        self.sketch_lst: list[str] = []
        self._init_decode_cache(load_images, cache_size)

    def __len__(self) -> int:
        return len(self.samples)

    def get_cat_length(self) -> int:
        """Number of classes (name parity with the triplet datasets so the
        train CLI sizes the classifier head uniformly)."""
        return len(self.classes)

    def __getitem__(self, idx: int, rng=None) -> dict:
        path, label = self.samples[idx]
        return {"image": self._decode(path), "label": label}
