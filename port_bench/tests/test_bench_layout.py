"""The benchmark's files on the CPU: every cell resolves to its files by
name, new files are found without an edit, names keep to their
characters, nothing loads JAX or the JAX package, the reference loads
nothing of the program, the generators repeat for a seed, and the work
counts reproduce the kernel table's bounds."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import generator as gen
from port_bench import harness
from port_bench.work import counts

BENCH = harness.BENCH_DIR
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.read_json(ROOT / "BENCHMARK.json")


def test_every_workload_resolves(bench):
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"], bench)
        assert cell.traffic["kind"] in {p.stem for p in
                                       (BENCH / "kinds").glob("*.py")}
        assert cell.config["name"] == w["config"]
        assert cell.end_to_end[0]["name"] == "setup_s"
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert (BENCH / "metrics" / f"{m['name']}.py").exists()


def test_every_file_is_used(bench):
    used = {f"{w['name']}.json" for w in bench["workloads"]}
    files = {p.name for p in (BENCH / "workloads").glob("*.json")}
    assert files == used
    for name in files:
        w = harness.read_json(BENCH / "workloads" / name)
        assert (BENCH / "configs" / f"{w['config']}.json").exists()
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    configs = {c["name"] for c in bench["configs"]}
    assert {w["config"] for w in bench["workloads"]} == configs
    for c in bench["configs"]:
        assert harness.read_json(ROOT / c["file"])["source"] == c["source"]


def test_a_cell_added_as_files_is_found(bench, tmp_path):
    copy = tmp_path / "port_bench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns(
        "__pycache__"))
    w = dict(bench["workloads"][0], name="b3a.serve.q32")
    traffic = harness.read_json(copy / "traffic" / f"{w['traffic']}.json")
    (copy / "traffic" / "serve_q32.json").write_text(json.dumps(
        dict(traffic, queries=32)))
    w["traffic"] = "serve_q32"
    wl = harness.read_json(copy / "workloads"
                           / f"{bench['workloads'][0]['name']}.json")
    (copy / "workloads" / "b3a.serve.q32.json").write_text(json.dumps(
        dict(wl, traffic="serve_q32")))
    (copy / "metrics" / "queries.serve.py").write_text(
        "def read(r):\n    return r.counts.get('queries')\n")
    new = dict(bench, workloads=bench["workloads"] + [w],
               per_layer=bench["per_layer"] + [dict(
                   bench["per_layer"][0], name="queries.serve",
                   workloads=["b3a.serve.q32"])])
    cell = harness.load_cell("b3a.serve.q32", new, bench_dir=copy)
    assert cell.traffic["queries"] == 32
    assert [m["name"] for m in cell.per_layer] == ["queries.serve"]
    reader = harness.load_reader("queries.serve", bench_dir=copy)
    assert reader(type("R", (), {"counts": {"queries": 7}})()) == 7


def test_names_and_units(bench):
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [w["traffic"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
             + [k for c in bench["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert 0 < len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(bench["workloads"]) // 4)


def test_forbidden_names_compare_whole_top_level():
    assert harness.forbidden_modules(["jax.numpy", "torch"]) == ["jax"]
    assert harness.forbidden_modules(
        ["imageretrievalresearch_tpu.ops", "flax"]) == [
            "flax", "imageretrievalresearch_tpu"]
    assert harness.forbidden_modules(
        ["imageretrievalresearch_tpu_torch.ops", "jaxtyping",
         "jax_like"]) == []


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_jax_in_any_benchmark_file():
    for path in BENCH.rglob("*.py"):
        assert not (_imports(path) & set(harness.FORBIDDEN)), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "imageretrievalresearch_tpu_torch" not in _imports(path), path
    code = ("import sys, port_bench.reference.models, "
            "port_bench.reference.transforms, port_bench.reference.train, "
            "port_bench.reference.retrieval; print(sorted({m.split('.')[0] "
            "for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert "imageretrievalresearch_tpu_torch" not in out
    assert "jax" not in out


def test_run_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "b3a.serve.q64", "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_generators_repeat_for_a_seed():
    s = gen.seeds(2 ** 31 + 12345)
    assert s == gen.seeds(2 ** 31 + 12345)
    assert s != gen.seeds(2 ** 31 + 12346)
    assert len(set(s.values())) == len(s)
    spec = {"pool": 2, "queries": 3, "image_px": 8, "triplets": 2}
    a = gen.request_pool(spec, s["requests"], "cpu")
    b = gen.request_pool(spec, s["requests"], "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    ta = gen.triplet_pool(spec, 125, s["batches"], "cpu")
    tb = gen.triplet_pool(spec, 125, s["batches"], "cpu")
    assert all(np.array_equal(x[k], y[k]) for x, y in zip(ta, tb)
               for k in ("qry", "cat_idx"))
    g = {"rows": 50, "dim": 16, "classes": 5, "spread": 1.0}
    r1, c1 = gen.gallery(g, s["gallery"], "cpu")
    r2, c2 = gen.gallery(g, s["gallery"], "cpu")
    assert torch.equal(r1, r2) and torch.equal(c1, c2)
    assert torch.allclose(torch.linalg.vector_norm(r1, dim=1),
                          torch.ones(50))


def test_kernel1_bound_reproduces_the_table():
    k1 = counts.kernel1(64, 100_000, 1536, 150)
    assert round(k1["bound_s"] * 1e3, 3) == 0.184
    assert round(k1["f32_fma_bound_s"] * 1e3, 3) == 0.293
    assert round(counts.kernel1(64, 100_000, 1920, 150)["bound_s"] * 1e3,
                 3) == 0.230


@pytest.mark.parametrize("kind,bound_ms", [("histogram", 0.0029),
                                           ("lut", 0.0058),
                                           ("shift", 0.0058),
                                           ("cubic", 0.0058)])
def test_image_kernel_bounds_reproduce_the_table(kind, bound_ms):
    got = counts.image_kernel(kind, 192, 224, 224)["bound_s"] * 1e3
    assert round(got, 4) == bound_ms


@pytest.mark.parametrize("config,gmacs", [("efficientnet_b3a", (0.9, 1.1)),
                                          ("rexnet_150", (0.8, 1.0))])
def test_forward_flops(config, gmacs):
    cfg = harness.read_json(BENCH / "configs" / f"{config}.json")
    macs = counts.forward_flops(cfg, 224) / 2e9
    assert gmacs[0] < macs < gmacs[1]
