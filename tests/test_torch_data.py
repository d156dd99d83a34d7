"""The port's data layer (``data/``) on the CPU, held against the JAX
package's: the synthetic trees, the split policies, the triplet index,
every dataset family, ``TripletLoader`` and the decode cache.

JAX's trees are written by PIL, the port's by its own PNG and JPEG
writers; each comparison runs the JAX class on JAX's tree and the port's
class on the port's tree (same seeds), so paths are compared relative to
their roots and images as arrays. Everything is exact: no tolerance."""

import io
import json
import os
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from imageretrievalresearch_tpu.data import loader as jax_loader_mod
from imageretrievalresearch_tpu.data import splits as jax_splits
from imageretrievalresearch_tpu.data import synthetic as jax_syn
from imageretrievalresearch_tpu.data.imagefolder import (
    ImageFolderDataset as JaxImageFolder,
)
from imageretrievalresearch_tpu.data.original import (
    OriginalDataset as JaxOriginal,
)
from imageretrievalresearch_tpu.data.original import (
    OriginalImageDataset as JaxOriginalImage,
)
from imageretrievalresearch_tpu.data.sketchy import (
    SketchyDataset as JaxSketchy,
)
from imageretrievalresearch_tpu.data.sketchy import (
    SketchyImageDataset as JaxSketchyImage,
)
from imageretrievalresearch_tpu.data.soft import TripletDataset as JaxSoft
from imageretrievalresearch_tpu.data.soft import (
    TripletImageDataset as JaxSoftImage,
)
from imageretrievalresearch_tpu.data.triple import (
    TripleDataset as JaxTriple,
)
from imageretrievalresearch_tpu.data.triple import (
    find_classes as jax_find_classes,
)
from imageretrievalresearch_tpu_torch.data import (
    ImageFolderDataset,
    OriginalDataset,
    OriginalImageDataset,
    SketchyDataset,
    SketchyImageDataset,
    TripleDataset,
    TripletDataset,
    TripletImageDataset,
    TripletLoader,
    decode_image,
)
from imageretrievalresearch_tpu_torch.data import splits
from imageretrievalresearch_tpu_torch.data import synthetic as syn
from imageretrievalresearch_tpu_torch.data.index import build_triplet_index
from imageretrievalresearch_tpu_torch.data.triple import find_classes

SIZE = 32
# (builder name, kwargs): each tree small, at 32 px
TREES = {
    "sketchy": ("make_sketchy_tree",
                dict(n_cats=3, n_prods=2, n_photos=3, n_sketches=2,
                     size=SIZE)),
    "sketchy_structured": ("make_sketchy_tree",
                           dict(n_cats=2, n_prods=2, n_photos=2,
                                n_sketches=2, size=SIZE, structured=True,
                                seed=3)),
    "original": ("make_original_tree",
                 dict(n_cats=2, n_prods=2, n_photos=2, n_sketches=2,
                      size=SIZE)),
    "soft": ("make_soft_tree", dict(n_cats=2, n_prods=2, n_imgs=3,
                                    size=SIZE)),
    "classfolder": ("make_classfolder_tree",
                    dict(n_classes=3, n_photos=3, n_sketches=2, size=SIZE)),
    "imagefolder": ("make_imagefolder_tree",
                    dict(n_classes=3, n_images=5, size=SIZE,
                         structured=True)),
}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Every tree twice: JAX's (PIL) and the port's, the same seeds."""
    out = {}
    for name, (fn, kw) in TREES.items():
        roots = {}
        for side, mod in (("jax", jax_syn), ("port", syn)):
            root = str(tmp_path_factory.mktemp(f"{side}_{name}"))
            getattr(mod, fn)(root, **kw)
            roots[side] = root
        out[name] = roots
    return out


def _files(root: str) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


def _pil(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _rel(paths, root) -> list[str]:
    return [os.path.relpath(p, root) for p in paths]


@pytest.mark.parametrize("name", sorted(TREES))
def test_synthetic_trees_equal_jax(trees, name):
    """Same files; each of the port's files decodes (by PIL and by the
    port) to the array PIL decodes JAX's file to."""
    jr, pr = trees[name]["jax"], trees[name]["port"]
    files = _files(jr)
    assert files and files == _files(pr)
    for f in files:
        ref = _pil(os.path.join(jr, f))
        np.testing.assert_array_equal(_pil(os.path.join(pr, f)), ref)
        np.testing.assert_array_equal(decode_image(os.path.join(pr, f)),
                                      ref)


def test_structured_base_equals_jax():
    for cat, prod, size in ((0, 0, 32), (3, 1, 64), (7, 9, 256)):
        np.testing.assert_array_equal(syn._class_base(cat, prod, size),
                                      jax_syn._class_base(cat, prod, size))


# ------------------------------------------------------------------ splits

SPLIT_CASES = [
    ("sketchy", dict(policy="cat", hard_split=True)),
    ("sketchy", dict(policy="prod", hard_split=True)),
    ("sketchy", dict(policy="prod", hard_split=False)),
    ("sketchy", dict(policy="cat", hard_split=False, sketch_qry=True)),
    ("sketchy", dict(policy="prod", split=[0.5, 0.5], seed=7)),
    ("original", dict(policy="prod", hard_split=True)),
    ("original", dict(policy="cat", hard_split=False)),
    ("soft", dict(policy="prod")),
    ("soft", dict(policy="cat", split=[0.6, 0.4])),
]


@pytest.mark.parametrize("layout,kw", SPLIT_CASES)
def test_data_split_json_equals_jax(trees, tmp_path, layout, kw):
    jr, pr = trees[layout]["jax"], trees[layout]["port"]
    fn = f"data_split_{layout}"
    jo = getattr(jax_splits, fn)(jr, str(tmp_path / "j.json"), **kw)
    po = getattr(splits, fn)(pr, str(tmp_path / "p.json"), **kw)
    with open(jo) as f:
        ref = json.load(f)
    with open(po) as f:
        got = json.load(f)
    assert list(got) == list(ref)
    for key in ref:
        assert _rel(got[key], pr) == _rel(ref[key], jr), key


def test_split_helpers_equal_jax():
    assert splits.strip_root("/d/x/d/y", "/d") == jax_splits.strip_root(
        "/d/x/d/y", "/d") == "x/d/y"
    items = list(range(23))
    for split in ("all", "train", "val"):
        for seed in (0, 42):
            assert (splits.seeded_holdout(items, split, seed=seed)
                    == jax_splits.seeded_holdout(items, split, seed=seed))
    with pytest.raises(ValueError, match="split must be"):
        splits.seeded_holdout(items, "test")
    with pytest.raises(ValueError, match="sum of split"):
        splits.data_split_sketchy("/nonexistent", "/dev/null",
                                  split=[0.5, 0.6])


# ---------------------------------------------------- the triplet datasets

def _dump_index(ds, root) -> dict:
    idx = ds.index
    return {
        "image_lst": _rel(idx.image_lst, root),
        "sketch_lst": _rel(idx.sketch_lst, root),
        "cat_idx": idx.cat_idx, "prod_idx": idx.prod_idx,
        "query_cat": idx.query_cat.tolist(),
        "query_prod": idx.query_prod.tolist(),
        "pos": [c.tolist() for c in idx.pos_candidates],
        "neg": [c.tolist() for c in idx.neg_candidates],
        "pos_key": idx.pos_policy_key, "neg_key": idx.neg_policy_key,
    }


FAMILIES = {
    "sketchy": (JaxSketchy, SketchyDataset, JaxSketchyImage,
                SketchyImageDataset),
    "original": (JaxOriginal, OriginalDataset, JaxOriginalImage,
                 OriginalImageDataset),
    "soft": (JaxSoft, TripletDataset, JaxSoftImage, TripletImageDataset),
}
POLICIES = [("cat", "except_cat"), ("prod", "except_prod"),
            ("cat", "in_cat_except_prod")]


def _rng(epoch, idx):
    return np.random.default_rng(np.random.SeedSequence(
        entropy=42, spawn_key=(epoch, idx)))


def _assert_sample(got: dict, ref: dict, pr: str, jr: str):
    for key in ("cat_idx", "prod_idx"):
        assert got[key] == ref[key]
    np.testing.assert_array_equal(got["qry"], ref["qry"])
    for role in ("pos", "neg"):
        assert len(got[role]) == len(ref[role])
        for a, b in zip(got[role], ref[role]):
            np.testing.assert_array_equal(a, b)
        assert _rel(got["paths"][role], pr) == _rel(ref["paths"][role], jr)
    assert (os.path.relpath(got["paths"]["qry"], pr)
            == os.path.relpath(ref["paths"]["qry"], jr))


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("pos,neg", POLICIES)
def test_triplet_dataset_equals_jax(trees, family, pos, neg):
    """Path level: lengths, label counts, the index and __getitem__;
    image level: samples for a few (epoch, idx), arrays equal."""
    jr, pr = trees[family]["jax"], trees[family]["port"]
    jcls, pcls, jimg, pimg = FAMILIES[family]
    ref = jcls(jr, pos_policy=pos, neg_policy=neg)
    got = pcls(pr, pos_policy=pos, neg_policy=neg)
    assert len(got) == len(ref) > 0
    assert got.get_cat_length() == ref.get_cat_length()
    assert got.get_prod_length() == ref.get_prod_length()
    assert _dump_index(got, pr) == _dump_index(ref, jr)
    for i in range(len(ref)):
        a, b = got[i], ref[i]
        assert os.path.relpath(a["qry"], pr) == os.path.relpath(b["qry"], jr)
        for role in ("pos", "neg"):
            assert _rel(a[role], pr) == _rel(b[role], jr)
    ref_i = jimg(data_dir=jr, pos_policy=pos, neg_policy=neg, seed=5)
    got_i = pimg(data_dir=pr, pos_policy=pos, neg_policy=neg, seed=5)
    for epoch, idx in ((0, 0), (1, len(ref) - 1), (3, len(ref) // 2)):
        _assert_sample(got_i.__getitem__(idx, rng=_rng(epoch, idx)),
                       ref_i.__getitem__(idx, rng=_rng(epoch, idx)), pr, jr)
    # the constructor's seeded default rng draws the same stream
    _assert_sample(got_i[1], ref_i[1], pr, jr)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_triplet_image_dataset_split_json_and_cache(trees, tmp_path,
                                                     family):
    """Restricted to a split json, two positives and negatives, and the
    decode cache at a host size: the same samples as JAX's."""
    jr, pr = trees[family]["jax"], trees[family]["port"]
    _, _, jimg, pimg = FAMILIES[family]
    fn = f"data_split_{family}"
    jj = getattr(jax_splits, fn)(jr, str(tmp_path / "j.json"), policy="cat",
                                 **({} if family == "soft"
                                    else dict(hard_split=False)))
    pj = getattr(splits, fn)(pr, str(tmp_path / "p.json"), policy="cat",
                             **({} if family == "soft"
                                else dict(hard_split=False)))
    kw = dict(trainval="train", pos_policy="cat", neg_policy="except_cat",
              neg_return_num=2, load_images=True, cache_size=24)
    ref = jimg(data_dir=jr, trainval_json=jj, **kw)
    got = pimg(data_dir=pr, trainval_json=pj, **kw)
    assert len(got) == len(ref) > 0
    assert len(got._cache) == len(ref._cache)
    for epoch, idx in ((0, 0), (2, len(ref) - 1)):
        s = got.__getitem__(idx, rng=_rng(epoch, idx))
        _assert_sample(s, ref.__getitem__(idx, rng=_rng(epoch, idx)), pr, jr)
        assert s["qry"].shape == (24, 24, 3)


def test_random_false_guard_and_materialized_json(trees, tmp_path):
    pr = trees["sketchy"]["port"]
    with pytest.raises(ValueError, match="requires random=True"):
        SketchyImageDataset(data_dir=pr, random=False,
                            data_json="unused.json")
    data = {"meta": {"cat_idx": {"a": 0}, "prod_idx": {"p": 0},
                     "sketch_lst": ["s"], "image_lst": ["i"]},
            "data": [{"qry": "i", "pos": ["s"], "neg": []}]}
    path = tmp_path / "data.json"
    path.write_text(json.dumps(data))
    for cls, jcls in ((SketchyDataset, JaxSketchy),
                      (OriginalDataset, JaxOriginal),
                      (TripletDataset, JaxSoft)):
        got = cls(pr, random=False, data_json=str(path))
        ref = jcls(pr, random=False, data_json=str(path))
        assert len(got) == len(ref) == 1 and got[0] == ref[0]
        assert got.get_cat_length() == ref.get_cat_length() == 1


def test_index_policies_and_label_files():
    """build_triplet_index on hand-made paths: policies validated, and
    label_files freezing the label space as JAX's does."""
    from imageretrievalresearch_tpu.data.index import (
        build_triplet_index as jax_build,
    )

    def classify(p):
        c, q = p.split("/")[:2]
        return c, q
    images = ["a/p1/x", "a/p2/y", "b/p3/z", "a/p1/x"]
    sketches = ["a/p1/s1", "a/p2/s2", "b/p3/s3", "c/p4/s4"]
    for pos, neg in POLICIES:
        for files in (None, images):
            kw = dict(pos_policy=pos, neg_policy=neg,
                      label_walk=images + sketches, label_files=files)
            got = build_triplet_index(images, sketches, classify, **kw)
            ref = jax_build(images, sketches, classify, **kw)
            assert got.image_lst == ref.image_lst
            assert got.cat_idx == ref.cat_idx
            assert got.prod_idx == ref.prod_idx
            for a, b in zip(got.pos_candidates + got.neg_candidates,
                            ref.pos_candidates + ref.neg_candidates):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="positive policy"):
        build_triplet_index(images, sketches, classify, pos_policy="x")
    with pytest.raises(ValueError, match="negative policy"):
        build_triplet_index(images, sketches, classify, neg_policy="x")


# ------------------------------------------- triple and imagefolder trees

@pytest.mark.parametrize("split", ["all", "train", "val"])
def test_triple_dataset_equals_jax(trees, split):
    jr, pr = trees["classfolder"]["jax"], trees["classfolder"]["port"]
    assert find_classes(os.path.join(pr, "photo")) == jax_find_classes(
        os.path.join(jr, "photo"))
    kw = dict(seed=3, split=split, val_fraction=0.3)
    ref = JaxTriple(os.path.join(jr, "photo"), os.path.join(jr, "sketch"),
                    **kw)
    got = TripleDataset(os.path.join(pr, "photo"),
                        os.path.join(pr, "sketch"), **kw)
    assert len(got) == len(ref) > 0
    assert got.get_cat_length() == ref.get_cat_length()
    assert _rel(got.photo_paths, pr) == _rel(ref.photo_paths, jr)
    assert _rel(got.sketch_lst, pr) == _rel(ref.sketch_lst, jr)
    for idx in range(len(ref)):
        a = got.__getitem__(idx, rng=_rng(1, idx))
        b = ref.__getitem__(idx, rng=_rng(1, idx))
        assert a["L"] == b["L"]
        for key in ("P", "S", "N"):
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("split", ["all", "train", "val"])
def test_imagefolder_dataset_equals_jax(trees, split):
    jr, pr = trees["imagefolder"]["jax"], trees["imagefolder"]["port"]
    ref = JaxImageFolder(jr, split=split, seed=4)
    got = ImageFolderDataset(pr, split=split, seed=4)
    assert len(got) == len(ref) > 0
    assert got.classes == ref.classes
    assert ([(os.path.relpath(p, pr), c) for p, c in got.samples]
            == [(os.path.relpath(p, jr), c) for p, c in ref.samples])
    for i in range(len(ref)):
        assert got[i]["label"] == ref[i]["label"]
        np.testing.assert_array_equal(got[i]["image"], ref[i]["image"])


def test_dataset_refusals(trees, tmp_path):
    pr = trees["classfolder"]["port"]
    lonely = tmp_path / "lonely"
    (lonely / "photo" / "a").mkdir(parents=True)
    (lonely / "sketch" / "a").mkdir(parents=True)
    Image.new("RGB", (4, 4)).save(lonely / "photo" / "a" / "p.png")
    Image.new("RGB", (4, 4)).save(lonely / "sketch" / "a" / "s.png")
    with pytest.raises(ValueError, match=">= 2 sketch classes"):
        TripleDataset(str(lonely / "photo"), str(lonely / "sketch"))
    with pytest.raises(ValueError, match="split must be"):
        TripleDataset(os.path.join(pr, "photo"),
                      os.path.join(pr, "sketch"), split="test")
    with pytest.raises(ValueError, match="no class subfolders"):
        ImageFolderDataset(str(tmp_path / "lonely" / "photo" / "a"))


# ------------------------------------------------------------------ loader

def _batches(loader) -> list:
    out = []
    for b in loader:
        out.append(b)
    return out


def _assert_batches(got: list, ref: list):
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert sorted(a) == sorted(b)
        for key in a:
            va, vb = a[key], b[key]
            if isinstance(vb, list):
                assert len(va) == len(vb)
                for x, y in zip(va, vb):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
            else:
                assert va.dtype == vb.dtype
                np.testing.assert_array_equal(va, vb)


LOADER_CASES = [
    # (family, host_size, cache, shuffle, drop_last, batch, process index)
    ("sketchy", None, False, True, True, 4, None),
    ("sketchy", 24, False, True, False, 5, None),
    ("sketchy", 24, True, False, False, 4, None),
    ("sketchy", None, False, True, True, 4, 1),
    ("triple", 20, False, True, True, 3, None),
    ("imagefolder", 40, False, False, False, 4, None),
]


@pytest.mark.parametrize("case", LOADER_CASES)
def test_triplet_loader_equals_jax(trees, case):
    """TripletLoader batches over one epoch (epoch 1), JAX's dataset in
    JAX's loader against the port's in the port's."""
    family, host, cache, shuffle, drop_last, bs, proc = case
    cache_kw = dict(load_images=True, cache_size=host) if cache else {}

    def build(side):
        if family == "sketchy":
            root = trees["sketchy"][side]
            cls = JaxSketchyImage if side == "jax" else SketchyImageDataset
            return cls(data_dir=root, **cache_kw)
        if family == "triple":
            root = trees["classfolder"][side]
            cls = JaxTriple if side == "jax" else TripleDataset
            return cls(os.path.join(root, "photo"),
                       os.path.join(root, "sketch"), **cache_kw)
        root = trees["imagefolder"][side]
        cls = JaxImageFolder if side == "jax" else ImageFolderDataset
        return cls(root, **cache_kw)

    kw = dict(shuffle=shuffle, drop_last=drop_last, num_workers=2, seed=9,
              host_size=host, prefetch=2)
    if proc is not None:
        kw.update(process_index=proc, process_count=2)
    ref = jax_loader_mod.TripletLoader(build("jax"), bs, **kw)
    got = TripletLoader(build("port"), bs, **kw)
    assert len(got) == len(ref)
    for loader in (ref, got):
        loader.set_epoch(1)
    _assert_batches(_batches(got), _batches(ref))


def test_loader_refuses_native_and_relays_errors(trees, capsys,
                                                monkeypatch):
    """Where JAX's gates fail, ``use_native`` falls back to the threaded
    path with JAX's warning, naming each failed gate (here the pool and
    the host size); a producer's error reaches the consumer."""
    from imageretrievalresearch_tpu_torch.data import native_loader
    monkeypatch.setattr(native_loader, "native_available", lambda: False)
    ds = SketchyImageDataset(data_dir=trees["sketchy"]["port"])
    dl = TripletLoader(ds, 4, use_native=True)
    assert not dl.use_native
    out = capsys.readouterr().out
    assert ("[loader] WARNING: use_native requested but falling back to "
            "the threaded decode path: decode pool unavailable; host_size "
            "not set") in out
    assert _batches(dl)[0]["qry"].shape[0] == 4

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, idx, rng=None):
            raise KeyError("broken item")

    with pytest.raises(KeyError, match="broken item"):
        _batches(TripletLoader(Broken(), 2))


def test_jpeg_photo_bytes_decode_like_pil(trees):
    """One of the port's tree photos through PIL's encoder again: the
    decode of bytes and of paths agree."""
    photo = next(Path(trees["sketchy"]["port"]).rglob("*.jpg"))
    arr = decode_image(photo)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    np.testing.assert_array_equal(decode_image(buf.getvalue()),
                                  _pil(io.BytesIO(buf.getvalue())))
