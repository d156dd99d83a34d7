""""Original" (spec72/spec69) triplet dataset — parity with the reference.

Counterpart of ``imageretrievalresearch_tpu/data/original.py`` (decoding on
the port's ``data.decode``).

Layout (reference data/original_dataset.py:171-177)::

    <data_dir>/<cat>/<prod_dir>/<photo files>
    <data_dir>/<cat>/pdf_detail/<sketch files>     (sketches)

cat = first path component; prod = ``split('_')[-2]`` of the second path
component for photos (:269-275) and of the *third* component for sketches
(:277-283). Label enumeration walks photos first, then sketches
(original_dataset.py:182-193) — preserved via ``label_walk``.
"""

from __future__ import annotations

import glob
import json
import os

from imageretrievalresearch_tpu_torch.data.decode import TripletImageMixin
from imageretrievalresearch_tpu_torch.data.index import TripletIndex, build_triplet_index


class OriginalDataset:
    """Path-level dataset (reference data/original_dataset.py:118-292)."""

    def __init__(self, data_dir: str, random: bool = True,
                 pos_policy: str = "prod", neg_policy: str = "except_cat",
                 trainval_json: str | None = None, trainval: str | None = None,
                 data_json: str | None = None):
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
                "Please declare whether this is train or val dataset"
            with open(trainval_json, "r") as f:
                trainval_data = json.loads(f.read())
            image_lst = trainval_data[trainval]
        else:
            image_lst = glob.glob(os.path.join(self.data_dir, "**/*"),
                                  recursive=True)
        sketch_lst = glob.glob(os.path.join(self.data_dir, "*/pdf_detail/*"))
        image_lst = list(set(image_lst) - set(sketch_lst))
        image_lst = sorted(i for i in image_lst if os.path.isfile(i))
        sketch_lst = sorted(i for i in sketch_lst if os.path.isfile(i))
        # skip stray files the recursive glob picks up (a split json from a
        # previous data_split_original run, a root README): their paths
        # don't carry <cat>/<prod_dir>/ and would IndexError in
        # image_classify — same guard data_split_original applies
        # (splits.py) to the identical scan
        kept = []
        skipped = 0
        for p in image_lst:
            parts = self.get_basepath(p).split("/")
            if len(parts) < 2 or len(parts[1].split("_")) < 2:
                skipped += 1
                continue
            kept.append(p)
        image_lst = kept
        kept = []
        for p in sketch_lst:           # prod token lives in the filename
            parts = self.get_basepath(p).split("/")
            if len(parts) < 3 or len(parts[2].split("_")) < 2:
                skipped += 1
                continue
            kept.append(p)
        sketch_lst = kept
        if skipped:
            print(f"[OriginalDataset] skipped {skipped} file(s) not "
                  "matching the <cat>/<prod_dir>/... layout")

        def classify(path: str) -> tuple[str, str]:
            if path in sketch_set:
                return self.sketch_classify(path)
            return self.image_classify(path)

        sketch_set = set(sketch_lst)
        # label_files=image_lst: the reference freezes cat_idx/prod_idx
        # after walking photos only (original_dataset.py:182-189) — sketches
        # feed the candidate dicts but never grow the label space the
        # classifier head is sized by
        self.index = build_triplet_index(
            image_lst, sketch_lst, classify,
            pos_policy=pos_policy, neg_policy=neg_policy,
            label_walk=image_lst + sketch_lst, label_files=image_lst)
        self.cat_idx = self.index.cat_idx
        self.prod_idx = self.index.prod_idx
        self.sketch_lst = self.index.sketch_lst
        self.image_lst = self.index.image_lst

    def get_basepath(self, path: str) -> str:
        from imageretrievalresearch_tpu_torch.data.splits import strip_root
        return strip_root(path, self.data_dir)

    def image_classify(self, path: str) -> tuple[str, str]:
        split_path = self.get_basepath(path).split("/")
        return split_path[0], split_path[1].split("_")[-2]

    def sketch_classify(self, path: str) -> tuple[str, str]:
        split_path = self.get_basepath(path).split("/")
        return split_path[0], split_path[2].split("_")[-2]

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


class OriginalImageDataset(TripletImageMixin, OriginalDataset):
    """Image-level dataset (reference data/original_dataset.py:294-380)."""

    # construction, sampling, decode-cache, and transform handling live in
    # the shared TripletImageMixin (data/decode.py)
