"""The port's published-checkpoint registry, version and examples on the
CPU: the registry against the JAX package's, ``load_published`` from a
torch file written here, and each example of
``imageretrievalresearch_tpu_torch/examples`` run in process on a tiny
synthetic tree (``--device cpu``)."""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

import imageretrievalresearch_tpu_torch as port_pkg
from imageretrievalresearch_tpu import checkpoints as JC
from imageretrievalresearch_tpu.version import __version__ as jax_version
from imageretrievalresearch_tpu_torch import checkpoints as TC
from imageretrievalresearch_tpu_torch.data.synthetic import make_sketchy_tree
from imageretrievalresearch_tpu_torch.examples import (
    score_booster_demo,
    serving_pipeline,
    training_analysis,
)
from imageretrievalresearch_tpu_torch.models import create_model


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stdout(fn) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def test_registry_and_version_equal_jax():
    assert port_pkg.__version__ == jax_version
    assert list(TC.REGISTRY) == list(JC.REGISTRY)
    assert len(TC.REGISTRY) == 6
    for name, entry in TC.REGISTRY.items():
        assert dataclasses.asdict(entry) == dataclasses.asdict(
            JC.REGISTRY[name])
        assert entry.name == name


def test_load_published_from_a_torch_file(tmp_path):
    """A Lightning-style file (``state_dict`` under ``model.``) of the
    registry's architecture loads into the backbone it builds."""
    src = create_model("rexnet_150", num_classes=125, device="cpu", seed=7)
    ckpt = tmp_path / "rexnet.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in
                               src.net.state_dict().items()}}, ckpt)
    model = TC.load_published("rexnet_150_base", str(ckpt), device="cpu",
                              num_classes=125, seed=None)
    assert model.name == "rexnet_150" and not model.training
    for k, v in src.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)
    with pytest.raises(KeyError):
        TC.load_published("no_such_checkpoint", str(ckpt), device="cpu")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_sketchy_tree(str(tmp_path_factory.mktemp("ex") / "sk"),
                             n_cats=3, n_prods=1, n_photos=8, n_sketches=4,
                             size=32)


def test_training_analysis_example(tree, tmp_path):
    res = training_analysis.main([
        "--ims_path", tree, "--model_name", "efficientnet_b0",
        "--input_size", "32", "--batch_size", "8", "--viz_dir",
        str(tmp_path / "viz"), "--gradcam", "--save_gallery",
        str(tmp_path / "g.npz"), "--device", "cpu"])
    assert len(res["fms_ims_all"]) == 24 and 0 <= res["top1"] <= 1
    assert len(list((tmp_path / "viz").glob("retrieval_*.png"))) == 8
    assert np.load(tmp_path / "g.npz")["embeddings"].shape == (24, 1280)


def test_serving_pipeline_example(tmp_path, capsys):
    serving_pipeline.main(["--workdir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr()
    # two queries of 2 photos, as JSON lines; the HTTP answer on stderr
    lines = [ln for ln in out.out.splitlines() if ln.startswith("{")]
    assert len(lines) == 4
    assert "HTTP /search -> {" in out.err
    assert (tmp_path / "gallery.npz").exists()


def test_score_booster_demo(tmp_path):
    text = _stdout(lambda: score_booster_demo.main(
        ["--plot", str(tmp_path / "roc.png")]))
    assert "AUC: " in text and (tmp_path / "roc.png").stat().st_size > 0
    assert len(text.splitlines()) >= 11 + 21
