"""Sketchy DB-256 triplet dataset — API parity with the reference.

Counterpart of ``imageretrievalresearch_tpu/data/sketchy.py`` (decoding on
the port's ``data.decode``).

Layout (reference data/sketch_dataset.py:140-142)::

    <data_dir>/photo/tx_000000000000/<cat>/<prod>-N.jpg
    <data_dir>/sketch/tx_000000000000/<cat>/<prod>-N.png

:class:`SketchyDataset` indexes paths + candidate lists;
:class:`SketchyImageDataset` additionally decodes images and applies the
per-role transform dict — but here transforms run batched on the device
(see ops/preprocess.py), so the image dataset just yields decoded
uint8 arrays by default.
"""

from __future__ import annotations

import glob
import json
import os

from imageretrievalresearch_tpu_torch.data.decode import TripletImageMixin
from imageretrievalresearch_tpu_torch.data.index import TripletIndex, build_triplet_index


class SketchyDataset:
    """Path-level triplet dataset (reference data/sketch_dataset.py:99-243).

    Parameters mirror the reference: ``random=False`` loads a fully
    materialized data json (with ``meta``/``data`` keys,
    sketch_dataset.py:123-130); ``random=True`` globs the tree (optionally
    restricted to a train/val/test split json) and builds candidate lists.
    """

    def __init__(self, data_dir: str, random: bool = True,
                 pos_policy: str = "cat", neg_policy: str = "except_cat",
                 trainval_json: str | None = None, trainval: str | None = None,
                 data_json: str | None = None, sketch_qry: bool = False):
        self.pos_policy, self.neg_policy = pos_policy, neg_policy
        self.random, self.data_dir = random, data_dir
        self.index: TripletIndex | None = None

        if not self.random:
            assert data_json is not None, "data_json is required if not random"
            assert trainval_json is None and trainval is None, \
                "random false mode doesn't support trainval mode"
            with open(data_json, "r") as f:
                json_data = json.loads(f.read())
            self.cat_idx = json_data["meta"]["cat_idx"]
            self.prod_idx = json_data["meta"]["prod_idx"]
            self.sketch_lst = json_data["meta"]["sketch_lst"]
            self.image_lst = json_data["meta"]["image_lst"]
            self.data = json_data["data"]
            return

        if trainval_json:
            assert trainval is not None, \
                "you should declare whether this is train or val dataset"
            with open(trainval_json, "r") as f:
                trainval_data = json.loads(f.read())
            image_lst = trainval_data[trainval]
        else:
            image_lst = glob.glob(
                os.path.join(self.data_dir, "photo/tx_000000000000/*/*"))
        sketch_lst = glob.glob(
            os.path.join(self.data_dir, "sketch/tx_000000000000/*/*"))
        image_lst = sorted(i for i in image_lst if os.path.isfile(i))
        sketch_lst = sorted(i for i in sketch_lst if os.path.isfile(i))
        # label enumeration and the cat/prod -> sketch dicts walk
        # sketches + PRE-append photos: the reference builds cat_dic/
        # prod_dic BEFORE the sketch_qry append (sketch_dataset.py:146-158),
        # so each sketch contributes to its candidate lists exactly once —
        # walking the post-append list would duplicate every sketch in the
        # positive lists and break without-replacement sampling
        label_walk = sketch_lst + image_lst
        if sketch_qry:
            # sketches become queries too (sketch_dataset.py:157-158)
            image_lst = image_lst + sketch_lst

        self.index = build_triplet_index(
            image_lst, sketch_lst, self._classify_full,
            pos_policy=pos_policy, neg_policy=neg_policy,
            label_walk=label_walk)
        self.cat_idx = self.index.cat_idx
        self.prod_idx = self.index.prod_idx
        self.sketch_lst = self.index.sketch_lst
        self.image_lst = self.index.image_lst

    # --- path parsing (sketch_dataset.py:227-232) ---
    def get_basepath(self, path: str) -> str:
        from imageretrievalresearch_tpu_torch.data.splits import strip_root
        return strip_root(path, self.data_dir)

    def classify(self, path: str) -> tuple[str, str]:
        basename = os.path.basename(path)
        cat = os.path.basename(os.path.dirname(path))
        prod = basename.split("-")[0].replace(".jpg", "")
        return cat, prod

    def _classify_full(self, path: str) -> tuple[str, str]:
        return self.classify(self.get_basepath(path))

    def get_cat_length(self) -> int:
        return len(self.cat_idx)

    def get_prod_length(self) -> int:
        return len(self.prod_idx)

    def __len__(self) -> int:
        if not self.random:
            return len(self.data)
        return len(self.image_lst)

    def __getitem__(self, idx: int) -> dict:
        if not self.random:
            return self.data[idx]
        assert self.index is not None
        return {
            "qry": self.image_lst[idx],
            "pos": [self.sketch_lst[i] for i in self.index.pos_candidates[idx]],
            "neg": [self.sketch_lst[i] for i in self.index.neg_candidates[idx]],
            "pos_policy": self.index.pos_policy_key[idx],
            "neg_policy": self.index.neg_policy_key[idx],
        }


class SketchyImageDataset(TripletImageMixin, SketchyDataset):
    """Image-level dataset (reference data/sketch_dataset.py:245-309).

    Differences from the reference, by design:

    - Sampling uses an explicit ``np.random.Generator`` (constructor ``seed``,
      or per-call rng) instead of global ``random`` state.
    - Decoded images are returned as uint8 HWC numpy arrays; transforms are
      applied batched on device by the loader (ops/preprocess.py) unless a
      callable ``transform_dic`` is given, which is applied per-image on host
      for reference-compatible usage.
    """

    # construction, sampling, decode-cache, and transform handling live in
    # the shared TripletImageMixin (data/decode.py)
