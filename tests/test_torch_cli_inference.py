"""The port's inference CLI (``cli/inference.py``) on the CPU (``-d
cpu``), held against the JAX CLI on one tiny Sketchy tree.

Both CLIs get ``-mn efficientnet_b0 -is 32 -bs 8`` and the same ``-cp``
file, a seeded port model's ``net.state_dict()`` saved with
``torch.save`` (JAX reads it through its own converter), over one tree of
3 categories x 8 photos at 32 px (24 triplets). The JAX CLI runs twice in
a module fixture: class_dedup saving a float32 artifact, index_match
saving an int8 one; the port runs the same two.

Tolerances: the two packages' normalized embeddings of one image differ
by up to 2e-7 here (f32 sums in other orders); the artifact rows must
agree within 1e-5. The printed metrics (3 decimals, top-k over 24 items)
are equal lines on this tree. The int8 codes are equal here too; a code
whose value lies within that difference of a rounding boundary may differ
by 1, and at most 2 of the 30,720 may.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu.cli.inference import build_parser as jparser
from imageretrievalresearch_tpu.cli.inference import (
    build_eval_transform as jax_eval_transform,
)
from imageretrievalresearch_tpu.cli.inference import run as jrun
from imageretrievalresearch_tpu.models.backbone import Backbone as JaxBackbone
from imageretrievalresearch_tpu_torch.cli import inference as CLI
from imageretrievalresearch_tpu_torch.data.synthetic import make_sketchy_tree
from imageretrievalresearch_tpu_torch.models import create_model
from imageretrievalresearch_tpu_torch.retrieval import GalleryIndex
from test_torch_cli_gallery import _jitted_init

MODEL = ["-mn", "efficientnet_b0", "-is", "32", "-bs", "8"]
METRIC_LINES = ("Test loss:", "Test top1:", "Test top3:",
                "Test cos sim scores:")
EMB_ATOL, MAX_CODE_FLIPS = 1e-5, 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread keeps the CPU runs fast beside the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("inference")
    sk = make_sketchy_tree(str(root / "sk"), n_cats=3, n_prods=1,
                           n_photos=8, n_sketches=4, size=32)
    ckpt = root / "b0.pt"
    torch.save(create_model("efficientnet_b0", num_classes=3, device="cpu",
                            seed=3).net.state_dict(), ckpt)
    return {"root": root, "tree": sk, "ckpt": str(ckpt)}


def _stdout(fn) -> tuple[str, object]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return buf.getvalue(), out


def _argv(tree, variant, npz, dtype):
    return ["-ip", tree["tree"], *MODEL, "-cp", tree["ckpt"],
            "--topk_variant", variant, "--save_gallery",
            str(tree["root"] / npz), "--gallery_dtype", dtype]


RUNS = {"class_dedup": "float32", "index_match": "int8"}


@pytest.fixture(scope="module")
def runs(tree):
    """Each variant through both CLIs: (printed lines, artifact path)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBackbone, "init", _jitted_init(JaxBackbone.init))
        for variant, dtype in RUNS.items():
            argv = _argv(tree, variant, f"jax_{variant}.npz", dtype)
            text, _ = _stdout(lambda: jrun(jparser().parse_args(argv)))
            out["jax", variant] = (text, argv[-3])
    for variant, dtype in RUNS.items():
        argv = _argv(tree, variant, f"port_{variant}.npz", dtype)
        text, res = _stdout(lambda: CLI.run(CLI.build_parser().parse_args(
            [*argv, "-d", "cpu"])))
        out["port", variant] = (text, argv[-3])
        out["results", variant] = res
    return out


def _metrics(text: str) -> list[str]:
    return [line for line in text.splitlines()
            if line.startswith(METRIC_LINES)]


@pytest.mark.parametrize("kind", ["squarepad", "plain"])
def test_eval_transform_matches_jax(rng, kind):
    x = rng.integers(0, 256, (3, 40, 28, 3), dtype=np.uint8)
    ref = np.asarray(jax_eval_transform(kind, 32)(jnp.asarray(x)))
    ours = CLI.build_eval_transform(kind, 32, device="cpu")(x).numpy()
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_flags_and_defaults_match_jax():
    ours = vars(CLI.build_parser().parse_args([]))
    ref = vars(jparser().parse_args([]))
    assert ours.pop("device") == "cuda" and ref.pop("device") == "tpu"
    assert ours == ref
    a = CLI.build_parser().parse_args(["-c", "False", "--conv_input"])
    assert a.cache is False and a.conv_input is True


@pytest.mark.parametrize("variant", list(RUNS))
def test_printed_metrics_match_jax(runs, variant):
    jax_text, port_text = runs["jax", variant][0], runs["port", variant][0]
    want = 4 if variant == "index_match" else 3
    assert len(_metrics(jax_text)) == want
    assert _metrics(port_text) == _metrics(jax_text)
    res = runs["results", variant]
    assert f"Test top1: {res['top1']:.3f}" in port_text
    for line in ("The dataset has 3 classes", "Number of test samples: 24",
                 "Saved 24-item gallery index to "):
        assert line in port_text and line in jax_text
    # the argument print is yaml.dump's, with the port's device
    args = port_text.split("Inference Arguments:\n")[1].split("\n\n")[0]
    assert "device: cpu" in args and f"topk_variant: {variant}" in args


def test_saved_artifacts_match_jax(runs):
    for variant in RUNS:
        jg = GalleryIndex.load(runs["jax", variant][1], device="cpu")
        pg = GalleryIndex.load(runs["port", variant][1], device="cpu")
        assert pg.meta == jg.meta and list(pg.meta) == list(jg.meta)
        assert pg.meta["num_classes"] == 3 and pg.meta["conv_input"] is False
        np.testing.assert_array_equal(pg.classes, jg.classes)
        assert len(pg) == 24 and pg.dim == 1280
    jf = np.load(runs["jax", "class_dedup"][1])["embeddings"]
    pf = np.load(runs["port", "class_dedup"][1])["embeddings"]
    assert jf.dtype == pf.dtype == np.float32
    np.testing.assert_allclose(pf, jf, rtol=0, atol=EMB_ATOL)
    j8, p8 = (np.load(runs[w, "index_match"][1]) for w in ("jax", "port"))
    assert p8["embeddings"].dtype == np.int8
    np.testing.assert_allclose(p8["scales"], j8["scales"], rtol=1e-5)
    diff = np.abs(p8["embeddings"].astype(np.int16) - j8["embeddings"])
    assert diff.max() <= 1 and (diff > 0).sum() <= MAX_CODE_FLIPS


def test_viz_dir_writes_pngs(tree, tmp_path, runs):
    viz = tmp_path / "viz"
    argv = ["-ip", tree["tree"], *MODEL, "-cp", tree["ckpt"], "-d", "cpu",
            "--viz_dir", str(viz)]
    text, _ = _stdout(lambda: CLI.run(CLI.build_parser().parse_args(argv)))
    files = sorted(viz.glob("retrieval_*.png"))
    assert [f.name for f in files] == [f"retrieval_{i:03d}.png"
                                       for i in range(8)]
    assert all(f.stat().st_size > 0 for f in files)
    assert f"Wrote 8 visualization grids to {viz}" in text
    # the same lines as the run without --viz_dir
    assert _metrics(text) == _metrics(runs["port", "class_dedup"][0])
    text, _ = _stdout(lambda: CLI.run(CLI.build_parser().parse_args(
        [*argv, "--topk_variant", "index_match", "--viz_dir",
         str(tmp_path / "none")])))
    assert "--viz_dir requires --topk_variant class_dedup" in text
    assert not (tmp_path / "none").exists()


def test_device_unset_raises_without_a_gpu(tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = CLI.build_parser().parse_args(["-ip", tree["tree"], *MODEL])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLI.run(args)
