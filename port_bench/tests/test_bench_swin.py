"""The Swin serving cell (``swins3b.serve.q64``) on the CPU, and its
control on a card.

CPU: the cell shrunk to what the CPU runs in seconds (224 px, as the
cell, so every kind of block runs: shifted masked windows at 56² and 28²,
global attention at 14² and 7², patch merging; but embed 32 at depths
(2, 2, 2, 2) and Q = 2 over a small gallery) comes out correct through
``kinds/serve.py`` and not correct with an altered answer; the
configuration's FLOPs; the readers of the program's Swin spans and
counter. Card: the TF32 control at the cell's own size, which has to come
out not correct; each case prints its readings as a JSON line.

Run on a card from the checkout's root:
``python -m pytest port_bench/tests/test_bench_swin.py -m cuda -s``
"""

from __future__ import annotations

import copy
import json
import time

import pytest
import torch

from port_bench import generator as gen
from port_bench import harness
from port_bench.kinds import common, serve
from port_bench.tests import faults
from port_bench.tests.tiny import args
from port_bench.trace import Reading, Trace
from port_bench.work import counts

CELL = "swins3b.serve.q64"
SMALL = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
NEW = ("swin_attn_host_ms.serve", "swin_idle_ms.serve",
       "attn_softmax_roofline.serve")
SEEDS = (2147483701, 2147483723, 2147483789)


@pytest.fixture
def small_cell(monkeypatch):
    """The cell with the small widths, in the configuration the reference
    builds and in the program's registry entry alike."""
    from imageretrievalresearch_tpu_torch.models import backbone
    name = "swin_s3_base_224"
    ctor, published = backbone._REGISTRY[name]
    monkeypatch.setitem(backbone._REGISTRY, name,
                        (ctor, dict(published, **SMALL)))
    cell = copy.deepcopy(harness.load_cell(CELL))
    cell.config.update(SMALL, num_features=8 * SMALL["embed_dim"])
    t = cell.traffic
    t.update(queries=2, image_px=240, pool=2, warmup_requests=1,
             check_requests=2, keep_one_in=1, k=20)
    t["gallery"] = dict(t["gallery"], rows=600, classes=12,
                        dim=cell.config["num_features"])
    return cell


def test_swin_sound_run_is_correct(small_cell):
    out = serve.run(small_cell, args(seconds=0.5), time.perf_counter(),
                    device="cpu")
    assert harness.judge(out.checks), out.checks
    assert out.attempted >= 1


def test_swin_altered_answer_is_not_correct(small_cell):
    out = serve.run(small_cell, args(seconds=0.5), time.perf_counter(),
                    device="cpu", fault=faults.altered_answer)
    assert not harness.judge(out.checks), out.checks


def test_forward_flops_of_the_configuration():
    """timm's 12.67 G multiply-adds of convolutions and linear layers (the
    attention's two batched products, 1.07 G more, are not layers)."""
    cell = harness.load_cell(CELL)
    macs = counts.forward_flops(cell.config, 224) / 2e9
    assert 12.6 < macs < 12.8


def _trace(host_ops, kernels, units=2):
    activity = [(s, s + d) for _, s, d in kernels]
    return Trace(1e-4, units, kernels, activity, host_ops)


def test_new_readers_return_none_on_an_empty_reading(monkeypatch):
    from imageretrievalresearch_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "_COUNTS", {})
    bare = _trace([("aten::mm", 12.0, 28.0)],
                  [("softmax_warp_forward", 0.0, 10.0)])
    for r in (Reading(None), Reading(bare, peaks=counts.peaks())):
        for name in NEW:
            assert harness.load_reader(name)(r) is None, name


def test_new_readers_read_spans_kernels_and_the_counter(monkeypatch):
    from imageretrievalresearch_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "_COUNTS", {"swin.attn_scores": 10 ** 9})
    # device 0-10 (softmax), 30-40, 100-110; idle 10-30 and 40-100
    kernels = [("void softmax_warp_forward<float>", 0.0, 10.0),
               ("gemm", 30.0, 10.0), ("cunn_SoftMaxForward", 100.0, 10.0)]
    r = Reading(_trace([("swin.attention", 0.0, 25.0),
                        ("swin.mlp", 50.0, 90.0)], kernels),
                peaks=counts.peaks())
    read = {name: harness.load_reader(name)(r) for name in NEW}
    assert read["swin_attn_host_ms.serve"] == pytest.approx(0.025 / 2)
    assert read["swin_idle_ms.serve"] == pytest.approx(0.080 / 2)
    assert read["attn_softmax_roofline.serve"] == pytest.approx(
        100 * 8e9 / counts.peaks()["bytes_per_s"] / 20e-6)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's "
                    "own size")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_swin_tf32_control_is_not_correct(card, seed):
    cell = harness.load_cell(CELL)
    s = gen.seeds(seed)
    pool = gen.request_pool(cell.traffic, s["requests"], card)
    control = serve.Reference(cell, s, card, tf32=True)
    answers = [control.answer(x) for x in pool]
    del control
    common.release()
    values = serve.compare(serve.Reference(cell, s, card), answers, pool)
    print(json.dumps({"case": "tf32_control", "cell": CELL, "seed": seed,
                      "values": values}), flush=True)
    assert not harness.judge(common.checks(values, cell.workload))
