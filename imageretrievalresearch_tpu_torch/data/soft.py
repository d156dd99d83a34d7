"""Soft (real/+sketch/) triplet dataset — parity with the reference.

Counterpart of ``imageretrievalresearch_tpu/data/soft.py`` (decoding on
the port's ``data.decode``).

Layout (reference data/softdataset.py:72-75)::

    <data_dir>/real/<cat>/<name>_<prod>_*.ext
    <data_dir>/sketch/<cat>/<name>_<prod>_*.ext

classify (softdataset.py:142-146): cat = second path component,
sketch_name = stem of third component, prod = ``sketch_name.split('_')[1]``.
Label walk is ``sketch_lst + image_lst`` (softdataset.py:78).
"""

from __future__ import annotations

import glob
import json
import os

from imageretrievalresearch_tpu_torch.data.decode import TripletImageMixin
from imageretrievalresearch_tpu_torch.data.index import TripletIndex, build_triplet_index


class TripletDataset:
    """Path-level dataset (reference data/softdataset.py:44-157)."""

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
                "you should declare whether this is train or val dataset"
            with open(trainval_json, "r") as f:
                trainval_data = json.loads(f.read())
            image_lst = trainval_data[trainval]
        else:
            image_lst = glob.glob(os.path.join(self.data_dir, "real/**/*"),
                                  recursive=True)
        sketch_lst = glob.glob(os.path.join(self.data_dir, "sketch/**/*"),
                               recursive=True)
        image_lst = sorted(i for i in image_lst if os.path.isfile(i))
        sketch_lst = sorted(i for i in sketch_lst if os.path.isfile(i))
        # skip files classify cannot parse (a stray file directly under
        # real//sketch/, or a stem without the <name>_<prod>_ underscore):
        # they would IndexError the whole index build — same guard
        # data_split_soft applies to the identical scan (splits.py)
        skipped = 0

        def parseable(paths):
            nonlocal skipped
            kept = []
            for p in paths:
                parts = self.get_basepath(p).split("/")
                if (len(parts) < 3 or len(
                        os.path.splitext(parts[2])[0].split("_")) < 2):
                    skipped += 1
                    continue
                kept.append(p)
            return kept

        image_lst, sketch_lst = parseable(image_lst), parseable(sketch_lst)
        if skipped:
            print(f"[TripletDataset] skipped {skipped} file(s) not matching "
                  "the real|sketch/<cat>/<name>_<prod>_... layout")

        self.index = build_triplet_index(
            image_lst, sketch_lst, self._classify_full,
            pos_policy=pos_policy, neg_policy=neg_policy,
            label_walk=sketch_lst + image_lst)
        self.cat_idx = self.index.cat_idx
        self.prod_idx = self.index.prod_idx
        self.sketch_lst = self.index.sketch_lst
        self.image_lst = self.index.image_lst

    def get_basepath(self, path: str) -> str:
        from imageretrievalresearch_tpu_torch.data.splits import strip_root
        return strip_root(path, self.data_dir)

    def classify(self, path: str) -> tuple[str, str, str]:
        split = path.split("/")
        cat, sketch_name = split[1], os.path.splitext(split[2])[0]
        prod = sketch_name.split("_")[1]
        return cat, sketch_name, prod

    def _classify_full(self, path: str) -> tuple[str, str]:
        cat, _, prod = self.classify(self.get_basepath(path))
        return cat, prod

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


class TripletImageDataset(TripletImageMixin, TripletDataset):
    """Image-level dataset (reference data/softdataset.py:159-200)."""

    # construction, sampling, decode-cache, and transform handling live in
    # the shared TripletImageMixin (data/decode.py)
