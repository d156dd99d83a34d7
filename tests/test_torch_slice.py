"""The whole slice on the CPU, held against the JAX package: seeded uint8
images -> eval transform -> shrunken EfficientNet embed -> GalleryIndex ->
query_class_dedup, and the inference evaluation (embed_triplet_loader ->
evaluate_class_dedup / evaluate_index_match) on the use_pallas path. Plus
the port's import hygiene and device default."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu.cli.inference import (
    build_eval_transform as jax_eval_transform,
)
from imageretrievalresearch_tpu.models import create_model as jax_create
from imageretrievalresearch_tpu.retrieval import GalleryIndex as JaxIndex
from imageretrievalresearch_tpu.retrieval import RetrievalEngine as JaxEngine
from imageretrievalresearch_tpu_torch.models import create_model
from imageretrievalresearch_tpu_torch.models.convert import params_from_jax
from imageretrievalresearch_tpu_torch.ops.preprocess import (
    build_eval_transform,
)
from imageretrievalresearch_tpu_torch.retrieval import (
    GalleryIndex,
    RetrievalEngine,
)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "imageretrievalresearch_tpu_torch"
# jax, flax, optax, orbax, ml_dtypes, PIL, yaml, and the JAX package —
# whose name is a prefix of the port's, hence the lookahead
FORBIDDEN = re.compile(
    r"^(jax|flax|optax|orbax|ml_dtypes|PIL|yaml"
    r"|imageretrievalresearch_tpu(?!_torch))(\.|$)")


def _near_tie_agreement(v, i, rv, ri, atol=1e-5):
    """Rankings agree except at near-ties: < 0.5% of positions differ,
    and values agree within ``atol`` (1e-5: ULP-level)."""
    mism = i != ri
    assert mism.mean() < 0.005, mism.mean()
    np.testing.assert_allclose(v, rv, rtol=0, atol=atol)


# bf16 against JAX: the two packages' l2_normalize may differ by an ulp,
# which can flip the bf16 rounding of a q̂ or ĝ element and so move a score
# by one bf16 ulp (2^-8 relative) of that element's product term
_ATOL = {"bfloat16": 1e-4}


@pytest.fixture(scope="module")
def slice_run():
    """Seeded images through the JAX and the port embedding paths (shared
    weights), and the gallery and queries built from the JAX embeddings;
    made once for the module's serving modes."""
    w, d, size = 0.5, 0.1, 32
    bb = jax_create("efficientnet_b0", num_classes=0, width_mult=w,
                    depth_mult=d)
    shapes = jax.eval_shape(bb.init, jax.random.key(0),
                            jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(7)

    def leaf(path, x):
        key = path[-1].key
        if key == "kernel":
            fan_in = int(np.prod(x.shape[:-1]))
            return rng.normal(0, np.sqrt(2.0 / fan_in), x.shape)
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape)
        return rng.normal(0, 0.1, x.shape)

    variables = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(leaf(p, x), jnp.float32), shapes)

    images = rng.integers(0, 256, (96, 40, 30, 3), dtype=np.uint8)
    jax_tf = jax_eval_transform("squarepad", size)
    jax_embed = jax.jit(lambda v, x: bb.embed(v, jax_tf(x)))
    ref = np.asarray(jax_embed(variables, jnp.asarray(images)))

    model = create_model("efficientnet_b0", num_classes=0, width_mult=w,
                         depth_mult=d, device="cpu")
    model.load_timm_state_dict(params_from_jax(variables, model))
    engine = RetrievalEngine(model, transform=build_eval_transform(
        "squarepad", size, device="cpu"), device="cpu")
    ours = engine.embed_batch(images).numpy()

    # gallery: 64 embedded items + 2,000 seeded rows (G >= 2048), 32
    # embedded queries; both indexes hold the SAME (JAX) embeddings,
    # centered: a random-weight network maps every image to nearly one
    # direction, which would make the whole top-k a near-tie
    dim = ref.shape[1]
    feats = ref - ref.mean(axis=0)
    extra = rng.normal(size=(2000, dim)).astype(np.float32) * np.std(feats)
    gallery = np.concatenate([feats[:64], extra])
    classes = rng.integers(0, 50, len(gallery)).astype(np.int32)
    return {"ref": ref, "ours": ours, "engine": engine, "dim": dim,
            "gallery": gallery, "classes": classes, "queries": feats[64:],
            "jax": (bb, variables, jax_tf), "images": images, "size": size}


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16", "int8",
                                          "int8_rerank"])
def test_slice_end_to_end_matches_jax(slice_run, matmul_dtype):
    ref, ours = slice_run["ref"], slice_run["ours"]
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)

    dim, queries = slice_run["dim"], slice_run["queries"]
    gallery, classes = slice_run["gallery"], slice_run["classes"]
    jidx = JaxIndex(dim).add(gallery, classes)
    tidx = GalleryIndex(dim, device="cpu").add(gallery, classes)
    # the fused path (JAX: Pallas interpret mode; port: the plain version
    # of the kernel); int8_rerank's stage 1 is fused in JAX, dense here
    kw = {"matmul_dtype": matmul_dtype}
    atol = _ATOL.get(matmul_dtype, 1e-5)
    if matmul_dtype != "int8_rerank":
        kw["method"] = "fused"
    jv, ji, _ = jidx.query(queries, k=150, interpret=True, **kw)
    tv, ti, _ = tidx.query(queries, k=150, **kw)
    _near_tie_agreement(tv, ti, jv, ji, atol)
    jd = jidx.query_class_dedup(queries, k=150, num_unique=3,
                                interpret=True, **kw)
    td = tidx.query_class_dedup(queries, k=150, num_unique=3, **kw)
    assert td[0].shape == (32, 3)
    _near_tie_agreement(td[0], td[1], jd[0], jd[1], atol)
    if matmul_dtype != "int8_rerank":
        # the engine's own search on the raw f32 gallery ranks the same way
        sv, si = slice_run["engine"].search(queries, gallery, k=150,
                                            matmul_dtype=matmul_dtype)
        _near_tie_agreement(sv, si, jv, ji, atol)


def test_engine_use_pallas_evaluation_matches_jax(slice_run):
    """RetrievalEngine(use_pallas=True): embed_triplet_loader over 2
    batches of 4 seeded triplets, then both evaluations, against the JAX
    engine with use_pallas=True in Pallas interpret mode, from shared
    weights."""
    bb, variables, jax_tf = slice_run["jax"]
    images, size = slice_run["images"], slice_run["size"]
    loader = [{"qry": images[8 * b:8 * b + 4],
               "pos": [images[8 * b + 4:8 * b + 8]],
               "neg": [images[48 + 4 * b:52 + 4 * b]],
               "cat_idx": np.array([0, 1, 2, 1]) + b}
              for b in range(2)]
    jeng = JaxEngine(bb, variables, transform=jax_tf, use_pallas=True,
                     interpret=True)
    teng = RetrievalEngine(slice_run["engine"].backbone,
                           transform=build_eval_transform(
                               "squarepad", size, device="cpu"),
                           device="cpu", use_pallas=True)
    jemb = jeng.embed_triplet_loader(loader, keep_images=True)
    temb = teng.embed_triplet_loader(loader, keep_images=True)
    assert sorted(temb) == sorted(jemb)
    for key in ("fms_ims_all", "fms_poss_all", "fms_negs_all"):
        assert temb[key].shape == (8, slice_run["dim"])
        np.testing.assert_allclose(temb[key], jemb[key], rtol=1e-4,
                                   atol=1e-4)
    for key in ("classes_all", "ims", "poss", "negs"):
        np.testing.assert_array_equal(temb[key], jemb[key])

    # both evaluations on the same (JAX) embeddings, shifted by the
    # gallery's mean: a random-weight network maps every image to nearly
    # one direction, which would make every ranking a near-tie
    shift = jemb["fms_poss_all"].mean(axis=0)
    embeds = {k: (v - shift if k.startswith("fms") else v)
              for k, v in jemb.items()}
    jd = jeng.evaluate_class_dedup(embeds, k=150, num_unique=3)
    td = teng.evaluate_class_dedup(embeds, k=150, num_unique=3)
    assert list(td) == list(jd)
    for key in ("top1", "top3"):
        assert td[key] == jd[key]
    np.testing.assert_array_equal(td["topk_inds"], jd["topk_inds"])
    np.testing.assert_array_equal(td["top_r_list"], jd["top_r_list"])
    for key in ("top_vals", "scores", "neg_scores"):
        np.testing.assert_allclose(td[key], jd[key], rtol=0, atol=1e-5)
    jm = jeng.evaluate_index_match(embeds)
    tm = teng.evaluate_index_match(embeds)
    assert list(tm) == list(jm)
    for key in ("top1", "top3"):
        assert tm[key] == jm[key]
    for key in ("loss", "scores", "normalized_embeddings"):
        np.testing.assert_allclose(tm[key], jm[key], rtol=0, atol=1e-5)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for module in ("tools/profile_fused_kernel.py", "utils/profiling.py",
                   "cli/gallery.py", "data/decode.py", "data/splits.py",
                   "data/jpeg.py", "data/index.py", "data/sketchy.py",
                   "data/original.py", "data/soft.py", "data/triple.py",
                   "data/imagefolder.py", "data/loader.py",
                   "data/synthetic.py", "train/lr_finder.py",
                   "utils/analysis.py", "cli/data_split.py", "cli/train.py",
                   "cli/find_lr.py", "cli/inference.py",
                   "retrieval/gradcam.py", "retrieval/visualize.py",
                   "checkpoints.py", "version.py",
                   "examples/serving_pipeline.py",
                   "examples/training_analysis.py",
                   "examples/score_booster_demo.py",
                   "parallel/mesh.py", "parallel/gallery.py",
                   "parallel/distributed.py", "parallel/fsdp.py",
                   "data/native_loader.py"):
        assert PORT / module in files
    bad = [(f.name, m) for f in files for m in _imports(f)
           if FORBIDDEN.match(m)]
    assert not bad, bad
    assert FORBIDDEN.match("imageretrievalresearch_tpu.ops")
    assert not FORBIDDEN.match("imageretrievalresearch_tpu_torch.ops")
    code = ("import sys, imageretrievalresearch_tpu_torch.retrieval, "
            "imageretrievalresearch_tpu_torch.models.convert, "
            "imageretrievalresearch_tpu_torch.ops.preprocess, "
            "imageretrievalresearch_tpu_torch.train, "
            "imageretrievalresearch_tpu_torch.recipes, "
            "imageretrievalresearch_tpu_torch.utils.profiling, "
            "imageretrievalresearch_tpu_torch.tools.profile_fused_kernel, "
            "imageretrievalresearch_tpu_torch.cli.gallery, "
            "imageretrievalresearch_tpu_torch.cli.train, "
            "imageretrievalresearch_tpu_torch.cli.find_lr, "
            "imageretrievalresearch_tpu_torch.cli.data_split, "
            "imageretrievalresearch_tpu_torch.data, "
            "imageretrievalresearch_tpu_torch.data.synthetic, "
            "imageretrievalresearch_tpu_torch.train.lr_finder, "
            "imageretrievalresearch_tpu_torch.utils.analysis, "
            "imageretrievalresearch_tpu_torch.data.decode, "
            "imageretrievalresearch_tpu_torch.cli.inference, "
            "imageretrievalresearch_tpu_torch.retrieval.gradcam, "
            "imageretrievalresearch_tpu_torch.retrieval.visualize, "
            "imageretrievalresearch_tpu_torch.checkpoints, "
            "imageretrievalresearch_tpu_torch.examples.serving_pipeline, "
            "imageretrievalresearch_tpu_torch.examples.training_analysis, "
            "imageretrievalresearch_tpu_torch.examples.score_booster_demo, "
            "imageretrievalresearch_tpu_torch.parallel, "
            "imageretrievalresearch_tpu_torch.parallel.distributed, "
            "imageretrievalresearch_tpu_torch.data.native_loader; "
            # matplotlib (and pandas) only inside the functions that draw
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'orbax', 'ml_dtypes', 'PIL', 'yaml', "
            "'matplotlib', 'pandas', 'imageretrievalresearch_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GalleryIndex(16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("efficientnet_b0", width_mult=0.25, depth_mult=0.1)
    model = create_model("efficientnet_b0", width_mult=0.25, depth_mult=0.1,
                         device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RetrievalEngine(model)
