"""The controls and faults at each cell's own size, on the card: each has
to come out not correct against the cell's limits. The control is the
reference in the program's place one precision below the configuration's
(serving, float32 with TF32 off: TF32; training, bfloat16: float8
operands); the training faults run the program itself with the fault
planted. Beside them: sound training runs on a dozen seeds (the limits'
lower readings), and two witnesses of the forward's gap at bfloat16 (the
program at float32, the reference at bfloat16). Each case prints its
readings as a JSON line, which is where the limits' readings come from.

Run on a card from the checkout's root:
``python -m pytest port_bench/tests/test_bench_control.py -m cuda -s``
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import pytest
import torch

from port_bench import generator as gen
from port_bench import harness
from port_bench.kinds import common, serve, train
from port_bench.reference import train as ref_train
from port_bench.tests import faults

SEEDS = (2147483701, 2147483723, 2147483789)
# sound runs at the cells' own size, a dozen seeds: the lower readings
SOUND_SEEDS = tuple(3000000019 + 7919 * i for i in range(12))
TRAIN_CELLS = ("rexnet150.train.t1", "b3a.train.t3")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls run at the cells' "
                    "own sizes")
    return torch.device("cuda")


def _report(case: str, cell: str, seed: int, values: dict) -> None:
    print(json.dumps({"case": case, "cell": cell, "seed": seed,
                      "values": values}), flush=True)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_serve_tf32_control_is_not_correct(card, seed):
    cell = harness.load_cell("b3a.serve.q64")
    s = gen.seeds(seed)
    pool = gen.request_pool(cell.traffic, s["requests"], card)
    control = serve.Reference(cell, s, card, tf32=True)
    answers = [control.answer(x) for x in pool]
    del control
    common.release()
    values = serve.compare(serve.Reference(cell, s, card), answers, pool)
    _report("tf32_control", cell.name, seed, values)
    assert not harness.judge(common.checks(values, cell.workload))


def _reference_in_place(name: str, seed: int, card, precision: str):
    """The reference at ``precision`` in the program's place, read
    against the reference at float32, as a run reads the program."""
    cell = harness.load_cell(name)
    t, s = cell.traffic, gen.seeds(seed)
    pool = gen.triplet_pool(t, cell.config["num_classes"], s["batches"],
                            card)
    lower = train.reference_steps(cell, s, pool, card, precision)
    lower["x"] = lower["x"].to(torch.bfloat16)
    ref = train.reference_steps(cell, s, pool, card)
    ref["own"] = ref_train.first_step_from(
        t, lower["emb"], lower["logits"],
        torch.as_tensor(pool[0]["cat_idx"], device=card).long())
    values = train.compare(lower, ref, t["compute_dtype"])
    return cell, values


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN_CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_train_fp8_control_is_not_correct(card, name, seed):
    cell, values = _reference_in_place(name, seed, card, "float8")
    _report("fp8_control", name, seed, values)
    assert not harness.judge(common.checks(values, cell.workload))


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN_CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_train_bf16_reference_is_within_the_limits(card, name, seed):
    """A witness: the reference itself under the program's bfloat16
    autocast reads the forward's gaps that the program reads, so they
    are the precision's, not the port's."""
    cell, values = _reference_in_place(name, seed, card, "bfloat16")
    _report("bf16_reference", name, seed, values)
    limits = cell.workload["limits"]
    for k in ("emb_rel", "emb_rel_median"):
        if k in limits:
            assert values[k] <= limits[k]["limit"], (k, values[k])


def _run(name: str, seed: int, card, fault=None, compute_dtype=None):
    cell = harness.load_cell(name)
    if compute_dtype is not None:
        cell = copy.deepcopy(cell)
        cell.traffic["compute_dtype"] = compute_dtype
    args = argparse.Namespace(seed=seed, seconds=1.0, trace=0)
    return train.run(cell, args, time.perf_counter(), device=card,
                     fault=fault)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN_CELLS)
@pytest.mark.parametrize("seed", SOUND_SEEDS)
def test_train_sound_run_is_correct(card, name, seed):
    out = _run(name, seed, card)
    _report("sound", name, seed, out.readings)
    assert harness.judge(out.checks), out.checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN_CELLS)
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_train_float32_program_matches_the_reference(card, name, seed):
    """A witness: the program at float32 against the reference, where
    the forward's gaps fall to rounding."""
    out = _run(name, seed, card, compute_dtype="float32")
    _report("float32_program", name, seed, out.readings)
    assert out.readings["emb_rel"] < 1e-3, out.readings


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN_CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_train_half_batch_is_not_correct(card, name, seed):
    out = _run(name, seed, card, fault=faults.half_batch)
    _report("half_batch", name, seed, out.readings)
    assert not harness.judge(out.checks)
