"""Generic triplet index: pos/neg candidate construction shared by all layouts.

Counterpart of ``imageretrievalresearch_tpu/data/index.py`` (the same
index for the same file lists).

The reference repeats the same candidate machinery in three dataset classes
(data/sketch_dataset.py:159-197, data/original_dataset.py:194-233,
data/softdataset.py:88-127). We factor it once; each layout supplies its own
file lists and a ``classify(path) -> (cat, prod)`` function.

Semantics preserved exactly:

- ``pos_policy``: 'cat' -> all sketches of the query's category; 'prod' ->
  all sketches of the query's product.
- ``neg_policy``: 'except_cat' -> all sketches minus the query category's;
  'except_prod' -> all sketches minus the query product's;
  'in_cat_except_prod' -> the query category's sketches minus the product's.
  Negative lists are memoized per policy key (sketch_dataset.py:170-194).
- Queries whose pos or neg list is empty are dropped
  (sketch_dataset.py:195-197).
- ``cat_idx`` / ``prod_idx`` enumerate categories/products in first-seen
  order over the combined file walk (sketch_dataset.py:152-155). The
  reference's walk order is glob order (filesystem-dependent); we sort file
  lists first, so indices are deterministic across machines.

Difference from the reference: candidates are stored as int32 numpy arrays of indices
into ``sketch_lst`` (not python lists of paths), so per-sample choice is an
O(1) PRNG draw and the whole index pickles compactly for multi-host loaders.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

POS_POLICIES = ("cat", "prod")
NEG_POLICIES = ("except_cat", "except_prod", "in_cat_except_prod")


@dataclasses.dataclass
class TripletIndex:
    """Immutable triplet sampling index over a photo/sketch corpus."""

    image_lst: list[str]                 # query paths (only those with candidates)
    sketch_lst: list[str]                # gallery sketch paths
    cat_idx: dict[str, int]              # category name -> label id
    prod_idx: dict[str, int]             # product name -> label id
    query_cat: np.ndarray                # (Q,) int32 cat label per query
    query_prod: np.ndarray               # (Q,) int32 prod label per query
    pos_candidates: list[np.ndarray]     # per query: int32 indices into sketch_lst
    neg_candidates: list[np.ndarray]     # per query: int32 indices into sketch_lst
    pos_policy_key: list[str]            # policy key per query (for parity/debug)
    neg_policy_key: list[str]

    def __len__(self) -> int:
        return len(self.image_lst)

    def get_cat_length(self) -> int:
        return len(self.cat_idx)

    def get_prod_length(self) -> int:
        return len(self.prod_idx)

    def sample(self, idx: int, rng: np.random.Generator,
               pos_return_num: int = 1, neg_return_num: int = 1) -> dict:
        """Draw a triplet sample: ``random.sample``-equivalent without replacement.

        Parity with SketchyImageDataset.__getitem__
        (data/sketch_dataset.py:294-297) but with an explicit threaded PRNG
        instead of global ``random`` state.
        """
        pos_cands = self.pos_candidates[idx]
        neg_cands = self.neg_candidates[idx]
        if pos_return_num > len(pos_cands):
            raise ValueError("pos_return_num should be smaller than length of positive list")
        if neg_return_num > len(neg_cands):
            raise ValueError("neg_return_num should be smaller than length of negative list")
        pos = rng.choice(pos_cands, size=pos_return_num, replace=False)
        neg = rng.choice(neg_cands, size=neg_return_num, replace=False)
        return {
            "qry": self.image_lst[idx],
            "pos": [self.sketch_lst[i] for i in pos],
            "neg": [self.sketch_lst[i] for i in neg],
            "cat_idx": int(self.query_cat[idx]),
            "prod_idx": int(self.query_prod[idx]),
        }


def build_triplet_index(
    image_lst: Sequence[str],
    sketch_lst: Sequence[str],
    classify: Callable[[str], tuple[str, str]],
    *,
    pos_policy: str = "cat",
    neg_policy: str = "except_cat",
    label_walk: Sequence[str] | None = None,
    label_files: Sequence[str] | None = None,
) -> TripletIndex:
    """Build the index. ``classify`` maps a *full path* to (cat, prod).

    ``label_walk`` controls the file order that defines cat_idx/prod_idx
    first-seen enumeration (the reference walks ``sketch_lst + image_lst`` for
    Sketchy but images-then-sketches for Original); defaults to
    ``sketch_lst + image_lst``.

    ``label_files`` (optional) restricts which walk files may INTRODUCE new
    cat_idx/prod_idx entries: the Original layout freezes both dicts after
    walking photos only (original_dataset.py:182-189, before the sketch
    walk), so sketch-only categories/products must feed the candidate dicts
    without growing the label space the classifier head is sized by.
    """
    if pos_policy not in POS_POLICIES:
        raise ValueError("positive policy must be one of [cat, prod]")
    if neg_policy not in NEG_POLICIES:
        raise ValueError(
            "negative policy must be one of [except_cat, except_prod, in_cat_except_prod]")

    image_lst = list(image_lst)
    sketch_lst = list(sketch_lst)
    sketch_pos = {p: i for i, p in enumerate(sketch_lst)}

    # cat/prod -> sketch index lists, and label enumeration in first-seen order
    cat_sketches: dict[str, list[int]] = {}
    prod_sketches: dict[str, list[int]] = {}
    cat_idx: dict[str, int] = {}
    prod_idx: dict[str, int] = {}
    walk = list(label_walk) if label_walk is not None else sketch_lst + image_lst
    label_set = set(label_files) if label_files is not None else None
    for path in walk:
        cat, prod = classify(path)
        may_label = label_set is None or path in label_set
        if cat not in cat_sketches:
            cat_sketches[cat] = []
        if prod not in prod_sketches:
            prod_sketches[prod] = []
        if may_label and cat not in cat_idx:
            cat_idx[cat] = len(cat_idx)
        if may_label and prod not in prod_idx:
            prod_idx[prod] = len(prod_idx)
        si = sketch_pos.get(path)
        if si is not None:
            cat_sketches[cat].append(si)
            prod_sketches[prod].append(si)

    all_sketches = np.arange(len(sketch_lst), dtype=np.int32)
    cat_arr = {k: np.asarray(v, dtype=np.int32) for k, v in cat_sketches.items()}
    prod_arr = {k: np.asarray(v, dtype=np.int32) for k, v in prod_sketches.items()}

    neg_memo: dict[str, np.ndarray] = {}

    def neg_for(cat: str, prod: str) -> tuple[str, np.ndarray]:
        if neg_policy == "except_cat":
            key = cat
            if key not in neg_memo:
                neg_memo[key] = np.setdiff1d(all_sketches, cat_arr.get(cat, []),
                                             assume_unique=False)
        elif neg_policy == "except_prod":
            key = prod
            if key not in neg_memo:
                neg_memo[key] = np.setdiff1d(all_sketches, prod_arr.get(prod, []),
                                             assume_unique=False)
        else:  # in_cat_except_prod
            key = f"{cat}/{prod}"
            if key not in neg_memo:
                neg_memo[key] = np.setdiff1d(cat_arr.get(cat, np.empty(0, np.int32)),
                                             prod_arr.get(prod, []),
                                             assume_unique=False)
        return key, neg_memo[key]

    kept_queries: list[str] = []
    query_cat: list[int] = []
    query_prod: list[int] = []
    pos_cands: list[np.ndarray] = []
    neg_cands: list[np.ndarray] = []
    pos_keys: list[str] = []
    neg_keys: list[str] = []

    # the reference's final query list is `list(pos_neg_dic.keys())`
    # (sketch_dataset.py:197, original_dataset.py:233, softdataset.py:127):
    # dict keys DEDUPE queries in first-seen order — a sketch_qry split
    # whose json already contains sketches must not double-count them
    image_lst = list(dict.fromkeys(image_lst))
    for qry in image_lst:
        cat, prod = classify(qry)
        if pos_policy == "cat":
            pos_key, pos_lst = cat, cat_arr.get(cat, np.empty(0, np.int32))
        else:
            pos_key, pos_lst = prod, prod_arr.get(prod, np.empty(0, np.int32))
        neg_key, neg_lst = neg_for(cat, prod)
        # drop queries with empty candidate lists (sketch_dataset.py:195-197)
        if len(pos_lst) and len(neg_lst):
            kept_queries.append(qry)
            query_cat.append(cat_idx[cat])
            query_prod.append(prod_idx[prod])
            pos_cands.append(pos_lst)
            neg_cands.append(neg_lst)
            pos_keys.append(pos_key)
            neg_keys.append(neg_key)

    return TripletIndex(
        image_lst=kept_queries,
        sketch_lst=sketch_lst,
        cat_idx=cat_idx,
        prod_idx=prod_idx,
        query_cat=np.asarray(query_cat, dtype=np.int32),
        query_prod=np.asarray(query_prod, dtype=np.int32),
        pos_candidates=pos_cands,
        neg_candidates=neg_cands,
        pos_policy_key=pos_keys,
        neg_policy_key=neg_keys,
    )
