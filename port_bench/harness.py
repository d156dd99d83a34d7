"""The benchmark's entry: finds a cell by name, runs it once, checks what
it produced and prints one result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` (at the checkout's root) gives it:

- ``configs/<config>.json``: the model's sizes, as run;
- ``traffic/<traffic>.json``: the mix's parameters, read by the general
  generator (``generator.py``) and by the module its ``kind`` names
  (``kinds/<kind>.py``);
- ``workloads/<cell>.json``: the cell's limits for ``correct``, with the
  readings they were set from;
- ``metrics/<metric>.py``: one per-layer metric's reader, ``read(r)``,
  which returns a number or None (nothing to read: left out of the line).

The run refuses to start without as many CUDA devices as the cell asks
for, and refuses to print a result if ``jax``, ``jaxlib``, ``flax`` or the
JAX package is loaded in this process when the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
CHECKOUT = BENCH_DIR.parent
# compared with the top-level name of each loaded module, whole
FORBIDDEN = ("jax", "jaxlib", "flax", "imageretrievalresearch_tpu")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among loaded modules (``names``:
    ``sys.modules`` by default)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def load_cell(name: str, bench: dict | None = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json`` by default) with
    its configuration, traffic and workload files."""
    if bench is None:
        bench = read_json(bench_dir.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"cells: {sorted(cells)}")
    entry = cells[name]
    workload = read_json(bench_dir / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: {key} {workload[key]!r} in its "
                             f"workload file, {entry[key]!r} in "
                             "BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, e2e_names)]
    return Cell(name=name, chips=entry["chips"],
                config=read_json(bench_dir / "configs"
                                 / f"{entry['config']}.json"),
                traffic=read_json(bench_dir / "traffic"
                                  / f"{entry['traffic']}.json"),
                workload=workload, end_to_end=e2e, per_layer=layer)


def load_reader(metric: str, bench_dir: Path = BENCH_DIR):
    """``read`` of ``metrics/<metric>.py``."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def set_environment() -> None:
    """Caches at fixed paths inside the checkout, so that a second run in
    it finds what the first one built; no JAX pulled in by a library."""
    cache = CHECKOUT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def judge(checks: dict) -> bool:
    """Every compared number at or under its limit (a NaN fails)."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def check_lines(checks: dict) -> list[str]:
    return [f"check {k} {c['value']!r} limit {c['limit']!r}"
            for k, c in checks.items()]


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, start: float | None = None) -> int:
    start = time.perf_counter() if start is None else start
    args = parse(argv)
    set_environment()
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("port_bench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {cell.name} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    kind = importlib.import_module(
        f"port_bench.kinds.{cell.traffic['kind']}")
    out = kind.run(cell, args, start)
    found = forbidden_modules()
    if found:
        print(f"port_bench: loaded in this process: {found}",
              file=sys.stderr)
        return 3
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(m["name"])(out.reading)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out.end_to_end[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    correct = judge(out.checks)
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics,
              "device": out.device}
    if args.trace and out.reading.trace is not None:
        result["breakdown"] = out.reading.trace.breakdown()
    result["checks"] = out.checks
    for line in check_lines(out.checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
