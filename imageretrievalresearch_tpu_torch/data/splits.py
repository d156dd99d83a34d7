"""Train/val/test split policies — parity with the reference's ``data_split``s.

Counterpart of ``imageretrievalresearch_tpu/data/splits.py``: for the same
tree and seed it writes the same JSON.

Three layout-specific entry points, each writing a
``{"train": [paths], "val": [...], "test": [...]}`` json:

- :func:`data_split_sketchy`  — reference data/sketch_dataset.py:6-97
- :func:`data_split_original` — reference data/original_dataset.py:7-116
  (the "soft" branch there has a typo ``+ =``; we implement the intent)
- :func:`data_split_soft`     — reference data/softdataset.py:10-42

Policies:
- ``policy='cat'``: bucket by category (parent dir name); ``policy='prod'``:
  bucket by product id (basename before '-'/'_' depending on layout).
- ``hard_split=True``: split the *bucket keys* 80/10/10 so val/test classes
  are unseen at train time (sketch_dataset.py:57-77).
- ``hard_split=False`` ("soft"): split *within* each bucket, guaranteeing at
  least one sample in val and test per bucket; buckets too small to split are
  replicated into all three sets (sketch_dataset.py:79-97).

Determinism: the reference relies on the global ``random`` module state; we
take an explicit ``seed`` argument instead (default 42 — the reference's
``pl.seed_everything(42)``, train/train.py:468).
"""

from __future__ import annotations

import csv
import glob
import json
import os
import random as _random

import numpy as np

#: image suffixes recognized when walking class-per-subfolder trees
#: (ImageFolderDataset, the gallery-build CLI)
IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def strip_root(path: str, data_dir: str) -> str:
    """Remove the leading ``data_dir/`` prefix — and only the LEADING one.

    ``str.replace`` (the reference's idiom, sketch_dataset.py:227) removes
    every occurrence, mis-parsing cat/prod when the root name recurs inside
    the path (e.g. a product directory named like the data dir)."""
    prefix = os.path.join(data_dir, "")
    return path[len(prefix):] if path.startswith(prefix) else path


def seeded_holdout(items: list, split: str, *, val_fraction: float = 0.2,
                   seed: int = 42) -> list:
    """Seeded train/val permutation holdout, original order preserved.

    The shared replacement for the reference's unseeded torch
    ``random_split`` (train/train_vit_crossentropy.py:59,
    train/train_vit_triplet.py:52 — both draw from the global torch RNG
    before ``seed_everything`` runs, so their splits are irreproducible;
    we pin the permutation). ``split='all'`` returns ``items`` unchanged;
    ``'train'``/``'val'`` return the complementary seeded subsets.
    """
    if split == "all":
        return items
    if split not in ("train", "val"):
        raise ValueError(f"split must be all|train|val, got {split!r}")
    n = len(items)
    n_train = int(n * (1.0 - val_fraction))
    perm = np.random.default_rng(seed).permutation(n)
    keep = perm[:n_train] if split == "train" else perm[n_train:]
    return [items[i] for i in np.sort(keep)]


def _read_train_essentials(train_essentials: str) -> list[str]:
    """Read essential-class names from a csv (reference sketch_dataset.py:30-34)."""
    out: list[str] = []
    if train_essentials:
        with open(train_essentials, "r") as f:
            for row in csv.reader(f):
                out += row
    return out


def _split_buckets(dic: dict[str, list[str]], split: list[float],
                   hard_split: bool, train_essential: list[str],
                   rng: _random.Random) -> dict[str, list[str]]:
    """Shared hard/soft bucket splitting (sketch_dataset.py:57-97)."""
    rslt: dict[str, list[str]] = {"train": [], "val": []}
    if len(split) == 3:
        rslt["test"] = []

    if hard_split:
        keys = list(dic.keys())
        # sorted: set-intersection iteration order is hash-randomization-
        # dependent per process, which would break the seeded byte-identical
        # reproducibility this module promises
        train_essential = sorted(set(keys) & set(train_essential))
        keys = list(set(keys) - set(train_essential))
        keys.sort()  # set() order is unstable; sort before shuffling for determinism
        rng.shuffle(keys)
        train_idx, val_idx = int(len(keys) * split[0]), int(len(keys) * split[1])
        train_keys = keys[:train_idx] + train_essential
        val_keys = keys[train_idx:train_idx + val_idx]
        # 2-way splits drop the int()-rounding leftover keys, exactly like
        # the reference (sketch_dataset.py:63-65 computes test_keys only
        # for 3-way splits; the remainder belongs to no split)
        test_keys = keys[train_idx + val_idx:] if len(split) == 3 else []
        for key in train_keys:
            rslt["train"] += dic[key]
        for key in val_keys:
            rslt["val"] += dic[key]
        for key in test_keys:
            rslt["test"] += dic[key]
    else:
        for key, value in dic.items():
            if key in train_essential:
                rslt["train"] += value
                continue
            val_len = max(int(len(value) * split[1]), 1)
            test_len = max(int(len(value) * split[2]), 1) if len(split) == 3 else 0
            train_len = len(value) - val_len - test_len
            # a 2-way split has no test slice to gate on (the reference's
            # soft branch would IndexError on split[2]; intent per SURVEY
            # §0): split the bucket whenever train AND val get items —
            # gating on test_len>0 here sent EVERY 2-way bucket to the
            # replicate-everywhere branch, making train == val == all
            if (val_len > 0 and train_len > 0
                    and (len(split) == 2 or test_len > 0)):
                rslt["val"] += value[:val_len]
                if test_len:
                    rslt["test"] += value[val_len:val_len + test_len]
                rslt["train"] += value[val_len + test_len:]
            else:
                # bucket too small to split: replicate everywhere
                # (sketch_dataset.py:92-95)
                rslt["val"] += value
                if "test" in rslt:
                    rslt["test"] += value
                rslt["train"] += value
    return rslt


def data_split_sketchy(data_dir: str, out_path: str, policy: str = "cat",
                       hard_split: bool = True, train_essentials: str = "",
                       split: list[float] | None = None, sketch_qry: bool = False,
                       seed: int = 42) -> str:
    """Split the Sketchy-DB-256 layout (photo|sketch/tx_000000000000/<cat>/<prod>-N.*).

    Parity with reference data/sketch_dataset.py:6-97: cat = parent dir name,
    prod = basename before '-' with '.jpg' stripped (:47).
    """
    split = split or [0.8, 0.1, 0.1]
    if abs(sum(split) - 1) >= 1e-9:
        # a raise, not assert: python -O would strip it and the slice
        # arithmetic would silently produce overlapping/short partitions
        raise ValueError("sum of split should be 1")
    rng = _random.Random(seed)
    train_essential = _read_train_essentials(train_essentials)

    lst = glob.glob(os.path.join(data_dir, "photo/tx_000000000000/*/*"))
    if sketch_qry:
        lst += glob.glob(os.path.join(data_dir, "sketch/tx_000000000000/*/*"))
    lst = sorted(i for i in lst if os.path.isfile(i))
    rng.shuffle(lst)

    dic: dict[str, list[str]] = {}
    for i in lst:
        basename = os.path.basename(i)
        cat = os.path.basename(os.path.dirname(i))
        prod = basename.split("-")[0].replace(".jpg", "")
        pol = {"cat": cat, "prod": prod}.get(policy)
        if pol is None:
            raise ValueError("policy must be one of [cat, prod]")
        dic.setdefault(pol, []).append(i)

    rslt = _split_buckets(dic, split, hard_split, train_essential, rng)
    with open(out_path, "w") as f:
        json.dump(rslt, f)
    return out_path


def data_split_original(data_dir: str, out_path: str, policy: str = "prod",
                        hard_split: bool = True, train_essentials: str = "",
                        split: list[float] | None = None, seed: int = 42) -> str:
    """Split the "original"/spec layout (<cat>/<prod_dir>/..., sketches in */pdf_detail/*).

    Parity with reference data/original_dataset.py:7-116: photos are all files
    except ``*/pdf_detail/*``; cat = first path component, prod = second path
    component's ``split('_')[-2]`` (:64).
    """
    split = split or [0.8, 0.1, 0.1]
    if abs(sum(split) - 1) >= 1e-9:
        # a raise, not assert: python -O would strip it and the slice
        # arithmetic would silently produce overlapping/short partitions
        raise ValueError("sum of split should be 1")
    rng = _random.Random(seed)
    train_essential = _read_train_essentials(train_essentials)

    lst = glob.glob(os.path.join(data_dir, "**/*"), recursive=True)
    lst = list(set(lst) - set(glob.glob(os.path.join(data_dir, "*/pdf_detail/*"))))
    lst = sorted(i for i in lst if os.path.isfile(i))
    rng.shuffle(lst)

    if policy not in ("cat", "prod"):
        raise ValueError("policy must be one of [cat, prod]")
    dic: dict[str, list[str]] = {}
    skipped = 0
    for i in lst:
        # parse lazily and skip malformed entries: the recursive glob can
        # pick up stray files (a README at the root, the out_path json from
        # a previous run) whose paths don't carry the <cat>/<prod_dir>/
        # structure — one stray must not crash the whole split
        split_path = strip_root(i, data_dir).split("/")
        if len(split_path) < 2:
            skipped += 1
            continue
        if policy == "cat":
            pol = split_path[0]
        else:
            toks = split_path[1].split("_")
            if len(toks) < 2:
                skipped += 1
                continue
            pol = toks[-2]
        dic.setdefault(pol, []).append(i)
    if skipped:
        print(f"[data_split_original] skipped {skipped} file(s) not "
              "matching the <cat>/<prod_dir>/... layout")

    rslt = _split_buckets(dic, split, hard_split, train_essential, rng)
    with open(out_path, "w") as f:
        json.dump(rslt, f)
    return out_path


def data_split_soft(data_dir: str, out_path: str, policy: str = "prod",
                    split: list[float] | None = None, seed: int = 42) -> str:
    """Split the real/+sketch/ layout — per-bucket proportional split only.

    Parity with reference data/softdataset.py:10-42. Note the reference's
    slicing quirk: with 3-way splits, ``train`` receives ``value[idx:]`` where
    ``idx`` is the *cumulative* val+test length — preserved here.
    """
    split = split or [0.8, 0.1, 0.1]
    if abs(sum(split) - 1) >= 1e-9:
        # a raise, not assert: python -O would strip it and the slice
        # arithmetic would silently produce overlapping/short partitions
        raise ValueError("sum of split should be 1")
    rng = _random.Random(seed)

    lst = glob.glob(os.path.join(data_dir, "real/**/*"), recursive=True)
    lst = sorted(i for i in lst if os.path.isfile(i))
    rng.shuffle(lst)

    if policy not in ("cat", "prod"):
        raise ValueError("policy must be one of [cat, prod]")
    dic: dict[str, list[str]] = {}
    skipped = 0
    for i in lst:
        basepath = strip_root(i, data_dir)
        parts = basepath.split("/")
        if policy == "cat":
            # a stray file directly under real/ has parts
            # ['real', '<file>'] — its filename must not become a category
            if len(parts) < 3:
                skipped += 1
                continue
            pol = parts[1]
        else:
            toks = os.path.dirname(basepath).split("_")
            if len(toks) < 2:
                skipped += 1
                continue
            pol = toks[1]
        dic.setdefault(pol, []).append(i)
    if skipped:
        print(f"[data_split_soft] skipped {skipped} file(s) not matching "
              "the real/<cat>/... layout")

    rslt: dict[str, list[str]] = {"train": [], "val": []}
    if len(split) == 3:
        rslt["test"] = []
    for value in dic.values():
        idx = max(int(len(value) * split[1]), 1)
        rslt["val"] += value[:idx]
        if len(split) == 3:
            prev_idx = idx
            idx = max(int(len(value) * split[2]), 1) + prev_idx
            rslt["test"] += value[prev_idx:idx]
        rslt["train"] += value[idx:]
    with open(out_path, "w") as f:
        json.dump(rslt, f)
    return out_path
