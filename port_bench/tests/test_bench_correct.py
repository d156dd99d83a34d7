"""The comparison that decides ``correct``, on the CPU: each kind's run,
shrunk (``tiny.py``), comes out correct against its cell's limits, and
false with a fault planted underneath its timed path. The harness's look
for a card is skipped: the kinds' ``run`` is called with ``device='cpu'``.

The training cells run here at float32 compute: the CPU's bfloat16
autocast is not the card's, and at these tiny shapes its gap to the
float32 reference says nothing of the cell's. The reference's own pieces
are held against the program's CPU path below (same weights, inputs and
draws)."""

from __future__ import annotations

import time

import pytest
import torch

from port_bench import generator as gen
from port_bench import harness
from port_bench.kinds import serve, train
from port_bench.tests import faults
from port_bench.tests.tiny import args, tiny_cell

TRAIN_CELLS = ("rexnet150.train.t1", "b3a.train.t3")


def _train_cell(name):
    cell = tiny_cell(name)
    cell.traffic["compute_dtype"] = "float32"
    return cell


def test_serve_sound_run_is_correct():
    out = serve.run(tiny_cell("b3a.serve.q64"), args(), time.perf_counter(),
                    device="cpu")
    assert harness.judge(out.checks), out.checks
    assert out.attempted >= 1
    assert set(out.end_to_end) == {"setup_s", "serve_qps", "serve_p95_ms"}


def test_serve_altered_answer_is_not_correct():
    out = serve.run(tiny_cell("b3a.serve.q64"), args(), time.perf_counter(),
                    device="cpu", fault=faults.altered_answer)
    assert not harness.judge(out.checks), out.checks


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_train_sound_run_is_correct(name):
    out = train.run(_train_cell(name), args(), time.perf_counter(),
                    device="cpu")
    assert harness.judge(out.checks), out.checks
    assert out.checks["input_gap"]["value"] == 0.0
    assert out.readings["loss1_from_emb"] < 1e-5
    assert out.readings["head_grad_from_logits"] < 1e-5


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_train_state_unchanged_is_not_correct(name):
    out = train.run(_train_cell(name), args(), time.perf_counter(),
                    device="cpu", fault=faults.state_unchanged)
    assert not harness.judge(out.checks), out.checks


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_half_batch_fails_only_after_the_forward(name):
    """Half the batch left out after the forward: the forward and its
    input read as in a sound run, the loss and the head's gradient do
    not, and the fault is left planted in nothing after the run."""
    from imageretrievalresearch_tpu_torch.train import steps
    before = steps._losses_for_mode
    out = train.run(_train_cell(name), args(), time.perf_counter(),
                    device="cpu", fault=faults.half_batch)
    assert not harness.judge(out.checks), out.checks
    r = out.readings
    assert r["input_gap"] == 0.0 and r["emb_rel"] < 1e-4, r
    assert r["loss1_from_emb"] > 1e-3 and r["head_grad_from_logits"] > 0.1
    assert steps._losses_for_mode is before


def test_reference_net_matches_the_program_forward():
    """The reference nets, loaded with the benchmark's weights, give the
    program's embeddings and logits (eval mode, float32, CPU)."""
    from imageretrievalresearch_tpu_torch.models.backbone import create_model
    from port_bench.reference import models as ref_models
    s = torch.Generator().manual_seed(0)
    x = torch.rand((2, 64, 64, 3), generator=s)
    for name in ("efficientnet_b3a", "rexnet_150"):
        cfg = harness.read_json(harness.BENCH_DIR / "configs"
                                / f"{name}.json")
        w = gen.weights(cfg, 11, "cpu")
        ref = ref_models.build(cfg)
        ref.load_timm_state_dict(w)
        prog = create_model(name, num_classes=cfg["num_classes"],
                            device="cpu", seed=None)
        prog.load_timm_state_dict(w)
        with torch.no_grad():
            e_ref, l_ref = ref.eval()(x)
            e, l_ = prog.features_and_logits(x)
        torch.testing.assert_close(e, e_ref, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(l_, l_ref, rtol=1e-5, atol=1e-7)


def test_reference_eval_transform_matches_the_program():
    from imageretrievalresearch_tpu_torch.ops.preprocess import (
        build_eval_transform,
    )
    from port_bench.reference import transforms
    x = torch.randint(0, 256, (3, 40, 52, 3), dtype=torch.uint8)
    got = build_eval_transform("squarepad", 32, device="cpu")(x)
    torch.testing.assert_close(got, transforms.eval_transform(x, 32),
                               rtol=0, atol=0)


def test_reference_autoaugment_matches_the_program():
    """Every one of the 25 sub-policies' draws, on a CPU batch."""
    from imageretrievalresearch_tpu_torch.ops.autoaugment import (
        imagenet_policy_batch,
    )
    from port_bench.reference import transforms
    x = torch.randint(0, 256, (64, 24, 24, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(1))
    got = imagenet_policy_batch(x, torch.Generator().manual_seed(5))
    want = transforms.autoaugment(x, torch.Generator().manual_seed(5))
    assert torch.equal(got, want)


def test_reference_retrieval_matches_the_program():
    import numpy as np
    from imageretrievalresearch_tpu_torch.retrieval.index import (
        GalleryIndex,
    )
    from port_bench import generator as gen
    from port_bench.reference import retrieval
    rows, classes = gen.gallery({"rows": 500, "dim": 24, "classes": 9,
                                 "spread": 1.0}, 4, "cpu")
    q = torch.randn((6, 24), generator=torch.Generator().manual_seed(2))
    idx = GalleryIndex(24, device="cpu").add(rows.numpy(), classes.numpy())
    vals, inds, cls = idx.query_class_dedup(q, k=40, num_unique=3)
    r_rows, r_vals, r_cls = retrieval.class_dedup(
        retrieval.scores(q, retrieval.normalize(rows)), classes.numpy(), 40,
        3)
    assert np.array_equal(inds, r_rows) and np.array_equal(cls, r_cls)
    np.testing.assert_allclose(vals, r_vals, rtol=0, atol=1e-6)
