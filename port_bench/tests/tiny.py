"""Cells shrunk to what the CPU runs in seconds: the same code path, the
configuration's widths, small inputs, gallery and batches."""

from __future__ import annotations

import argparse
import copy

from port_bench import harness


def tiny_cell(name: str):
    cell = copy.deepcopy(harness.load_cell(name))
    cell.config["image_size"] = 32
    t = cell.traffic
    if t["kind"] == "serve":
        t.update(queries=4, image_px=40, pool=3, warmup_requests=1,
                 check_requests=3, keep_one_in=1, k=20)
        t["gallery"] = dict(t["gallery"], rows=600, classes=12)
    else:
        t.update(triplets=4, image_px=40, pool=4, warmup_steps=0)
    return cell


def args(seed: int = 3, seconds: float = 0.2):
    return argparse.Namespace(seed=seed, seconds=seconds, trace=0)
