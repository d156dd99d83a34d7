"""The port's training CLIs (``cli/data_split.py``, ``cli/train.py``,
``cli/find_lr.py``), ``train/lr_finder.py`` and ``utils/analysis.py`` on
the CPU, held against the JAX package: the score helpers on a grid, the
LR range test on deterministic synthetic steps, the parsers, the
argument print against ``yaml.dump``, and tiny runs of each CLI from a
tree on disk (``--device cpu``), which write what JAX's CLIs write.

Tolerances: none. The score helpers and ``lr_find`` run the same float
arithmetic in both packages (the synthetic steps read the schedule's
float32 lr), so their outputs are compared exactly."""

import contextlib
import dataclasses
import glob
import io
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch
import yaml

from imageretrievalresearch_tpu.cli import data_split as jax_split_cli
from imageretrievalresearch_tpu.cli import find_lr as jax_find_lr_cli
from imageretrievalresearch_tpu.cli import train as jax_train_cli
from imageretrievalresearch_tpu.train.lr_finder import lr_find as jax_lr_find
from imageretrievalresearch_tpu.utils import analysis as jax_analysis
from imageretrievalresearch_tpu_torch.cli import data_split as split_cli
from imageretrievalresearch_tpu_torch.cli import find_lr as find_lr_cli
from imageretrievalresearch_tpu_torch.cli import train as train_cli
from imageretrievalresearch_tpu_torch.data.synthetic import make_sketchy_tree
from imageretrievalresearch_tpu_torch.train.lr_finder import lr_find
from imageretrievalresearch_tpu_torch.utils import analysis

CPU = ["--device", "cpu"]
TINY = ["--model_name", "efficientnet_b0", "--batch_size", "8",
        "--image_size", "32", "--compute_dtype", "float32",
        "--num_workers", "2"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CLI runs train small models on the CPU: one intra-op thread
    keeps them fast beside the other test workers, whose threads would
    otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ analysis helpers

SCORES = np.linspace(-1.0, 1.0, 41).tolist() + [0.29999, 0.3, 0.30001]


@pytest.mark.parametrize("name", ["cos_sim_score_with_threshold",
                                  "cos_sim_score_booster",
                                  "find_lr_cos_sim_score"])
def test_score_helpers_equal_jax(name):
    got, ref = getattr(analysis, name), getattr(jax_analysis, name)
    extra = ([{"threshold": t} for t in (0.0, 0.3, 0.7)]
             if name == "cos_sim_score_with_threshold"
             else [{"mode": m} for m in ("for_pos", "for_neg")])
    for score in SCORES:
        for eps in (0.5, 1.0, 5.0):
            for alpha in (0.1, 1.0, 2.0):
                for kw in extra:
                    assert got(score, eps, alpha, **kw) == ref(
                        score, eps, alpha, **kw)
    if name != "cos_sim_score_with_threshold":
        with pytest.raises(ValueError, match="unknown mode"):
            got(0.5, 5, 1, mode="nope")


def test_roc_curve_equals_jax():
    import pandas as pd
    rng = np.random.default_rng(0)
    df = pd.DataFrame({"actual": rng.integers(0, 2, 200),
                       "prediction": rng.random(200)})
    got, ref = analysis.roc_curve(df), jax_analysis.roc_curve(df)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- lr_find

def _loss_fns():
    def normal(lr, b):
        return (np.log10(lr) + 4.0) ** 2 + 1.0 + 0.01 * b

    def diverge(lr, b):
        return float(np.exp(3.0 * max(0.0, np.log10(lr) + 3.0))) + 0.001 * b

    def nan_late(lr, b):
        return float("nan") if lr > 1e-2 else 2.0 - 0.1 * np.log10(lr)

    def nan_early(lr, b):
        return float("nan") if lr > 2e-8 else 1.0
    return {"normal": normal, "diverge": diverge, "nan_late": nan_late,
            "nan_early": nan_early}


# (loss, number of batches, num_steps): a normal sweep, divergence, a NaN,
# replay of a short iterable, fewer than 3 losses, a short sweep that
# takes the fallback suggestion
LR_CASES = [("normal", 100, 60), ("diverge", 100, 60), ("nan_late", 100, 60),
            ("normal", 3, 40), ("nan_early", 100, 20), ("normal", 100, 12)]


@pytest.mark.parametrize("loss,n_batches,steps", LR_CASES)
def test_lr_find_equals_jax(loss, n_batches, steps):
    fn = _loss_fns()[loss]

    def make_state(schedule):
        return {"step": 0, "schedule": schedule, "seen": []}

    def step(state, batch, rng):
        lr = float(np.float32(state["schedule"](state["step"])))
        state["seen"].append(batch)
        state["step"] += 1
        return state, {"train_loss": fn(lr, batch)}

    kw = dict(min_lr=1e-8, max_lr=1.0, num_steps=steps)
    ref = jax_lr_find(make_state, step, iter(range(n_batches)),
                      jax.random.key(0), **kw)
    got = lr_find(make_state, step, iter(range(n_batches)),
                  torch.Generator().manual_seed(0), **kw)
    assert got["suggestion"] == ref["suggestion"]
    np.testing.assert_array_equal(got["lrs"], ref["lrs"])
    np.testing.assert_array_equal(got["losses"], ref["losses"])
    if loss == "nan_early":
        assert got["suggestion"] is None and len(got["losses"]) < 3
    elif loss in ("diverge", "nan_late"):
        assert 3 <= len(got["losses"]) < steps


def test_lr_find_replays_seen_batches_and_passes_the_generator():
    gen = torch.Generator().manual_seed(3)
    calls = []

    def step(state, batch, g):
        calls.append((batch, g))
        return state, {"train_loss": 1.0}

    lr_find(lambda s: None, step, iter(["a", "b", "c"]), gen, num_steps=8)
    assert [b for b, _ in calls] == ["a", "b", "c", "a", "b", "c", "a",
                                     "b"][:len(calls)]
    assert all(g is gen for _, g in calls)
    # the schedule holds the float32-rounded log-spaced lrs
    sched = []
    lr_find(lambda s: sched.append(s), step, iter([0]), gen, num_steps=5,
            min_lr=1e-4, max_lr=1e-1)
    lrs = np.exp(np.linspace(np.log(1e-4), np.log(1e-1), 5))
    assert [sched[0](i) for i in (-1, 0, 4, 9)] == [
        float(np.float32(lrs[i])) for i in (0, 0, 4, 4)]


# ---------------------------------------------------------------- parsers

PARSERS = {
    "train": (train_cli.build_parser, jax_train_cli.build_parser, []),
    "find_lr": (find_lr_cli.build_parser, jax_find_lr_cli.build_parser, []),
    "data_split": (split_cli.build_parser, jax_split_cli.build_parser,
                   ["--data_dir", "d", "--out_path", "o.json"]),
}


def _options(parser) -> list:
    return [(a.option_strings, a.dest, a.nargs, a.choices)
            for a in parser._actions]


@pytest.mark.parametrize("name", sorted(PARSERS))
def test_parser_equals_jax(name):
    port, ref, argv = PARSERS[name]
    assert _options(port()) == _options(ref())
    got, want = vars(port().parse_args(argv)), vars(ref().parse_args(argv))
    assert got.pop("device", "cuda") == "cuda"
    want.pop("device", None)
    assert got == want


@pytest.mark.parametrize("name", sorted(PARSERS))
def test_argument_print_equals_yaml_dump(name):
    """The parser's defaults, and args with None, floats, lists and path
    strings, print as ``yaml.dump(vars(args), default_flow_style=False)``
    does."""
    port, _, argv = PARSERS[name]
    args = vars(port().parse_args(argv))
    want = yaml.dump(args, default_flow_style=False)
    assert train_cli.yaml_dump(args) == want
    args.update(ims_path="/tmp/pytest-of-root/run 1/sketchy_db/",
                split_json=None, learning_rate=4.7863e-03, lrs=[1e-8, 0.5],
                split=[0.8, 0.1, 0.1], empty=[], paths=["a/b", "c d"],
                big=1e17, neg=-0.0, whole=3.0, tiny=5e-324)
    assert train_cli.yaml_dump(args) == yaml.dump(args,
                                                  default_flow_style=False)


def test_yaml_dump_strings_equal_yaml():
    """Strings yaml leaves plain, quotes, escapes or folds past its width
    of 80: seeded strings over an alphabet of the characters that decide
    the style, and hand-picked ones."""
    rng = np.random.default_rng(0)
    alphabet = list("ab/_.-:#'@ !?[]{},&*|>%`\"0123456789\t") + ["é"]
    picked = ["", "true", "No", "1.5", "0x1f", "~", "null", "-x", "- x",
              "a: b", "a:b", "a #b", "a#b", "@x", " lead", "trail ",
              "---x", "2020-01-01", "it's", "x " * 50, "p/q r" * 30,
              "x'y " * 30, "=", "<<", ".inf", "-.5e+3", "1_000", "0o7"]
    strings = picked + ["".join(rng.choice(alphabet, rng.integers(1, 120)))
                        for _ in range(400)]
    for i, s in enumerate(strings):
        d = {"k" * (1 + i % 12): s}
        assert train_cli.yaml_dump(d) == yaml.dump(
            d, default_flow_style=False) or not s.isascii() or "\t" in s, s


# ------------------------------------------------------------------- runs

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The port's own Sketchy tree (JPEG photos, PNG sketches), as the JAX
    CLI tests make theirs, and its 3-way split by the port's CLI."""
    root = str(tmp_path_factory.mktemp("sk"))
    make_sketchy_tree(root, n_cats=3, n_prods=1, n_photos=8, n_sketches=4,
                      size=32)
    split = os.path.join(root, "split.json")
    split_cli.run(split_cli.build_parser().parse_args([
        "--data_dir", root, "--out_path", split, "--layout", "sketchy",
        "--policy", "cat", "--no-hard_split",
        "--split", "0.5", "0.25", "0.25"]))
    return {"root": root, "split": split}


def test_data_split_cli_equals_jax(tree, tmp_path):
    out = str(tmp_path / "jax.json")
    jax_split_cli.run(jax_split_cli.build_parser().parse_args([
        "--data_dir", tree["root"], "--out_path", out, "--layout",
        "sketchy", "--policy", "cat", "--no-hard_split",
        "--split", "0.5", "0.25", "0.25"]))
    with open(out) as f, open(tree["split"]) as g:
        assert json.load(g) == json.load(f)


def _jax_config(argv: list, save_name: str):
    """The config JAX's train CLI builds from the same argv."""
    args = jax_train_cli.build_parser().parse_args(argv)
    cfg = jax_train_cli.build_config(
        args, vars(jax_train_cli.build_parser().parse_args([])))
    cfg.checkpoint_dir = os.path.join(cfg.save_path, save_name)
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in dataclasses.asdict(cfg).items()}


def test_train_cli_run_writes_what_jax_writes(tree, tmp_path):
    save = str(tmp_path / "models")
    argv = ["--ims_path", tree["root"], *TINY, "--max_epochs", "1",
            "-sp", save, "--split_json", tree["split"], "--cache",
            "--recipe", "train_efficient_cos_con_ce_loss",
            "--learning_rate", "0.001", "--batch_size", "4"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state, history = train_cli.run(
            train_cli.build_parser().parse_args(argv + CPU))
    out = buf.getvalue()
    args = vars(train_cli.build_parser().parse_args(argv + CPU))
    assert ("Training Arguments:\n"
            + yaml.dump(args, default_flow_style=False)) in out
    assert "Number of train set images: 12" in out
    assert "Train dataset has 3 classes" in out
    save_name = "efficientnet_b0_Adam_0.001"
    ckpt = os.path.join(save, save_name)
    with open(os.path.join(ckpt, "hparams.yaml")) as f:
        hp = yaml.safe_load(f)
    want = _jax_config(argv, save_name)
    assert hp.pop("device") == "cpu" and want.pop("device") == "tpu"
    assert hp == want
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    keys = set().union(*recs)
    assert {"val_loss", "cos_sims", "cos_unsims", "val_top1", "val_top3",
            "val_loss_con", "step", "time"} <= keys
    # 12 train queries, 6 validation ones: 3 steps and 1 val batch of 4
    assert state.step == 3 and len(history["epochs"]) == 1
    for kind in ("best", "last"):
        assert os.listdir(os.path.join(ckpt, kind)) == ["3"]
        assert os.path.isfile(os.path.join(ckpt, kind, "3", "state.pt"))


def test_find_lr_cli_sweep_train_after_and_pickled_results(tree, tmp_path):
    save = str(tmp_path / "models")
    args = find_lr_cli.build_parser().parse_args([
        "--ims_path", tree["root"], *TINY, "--max_epochs", "1", "-sp", save,
        "--split_json", tree["split"], "--min_lr", "1e-5", "--max_lr",
        "1e-2", "--num_lr_steps", "5", "--train_after", *CPU])
    out = find_lr_cli.run(args)
    assert out["suggestion"] is not None and np.isfinite(out["suggestion"])
    # one of the sweep's lrs: exp(linspace(log)) of the range, which may
    # leave it by rounding (1e-2 comes back as 0.010000000000000004)
    assert out["suggestion"] in out["lrs"].tolist()
    assert 1e-5 * (1 - 1e-12) <= out["suggestion"] <= 1e-2 * (1 + 1e-12)
    assert len(out["losses"]) == 5 and np.all(np.isfinite(out["losses"]))
    res = out["test_results"]
    assert set(res) == {"test_loss", "test_top3", "test_top1",
                        "test_scores", "test_scores_mean"}
    assert res["test_scores"] and all(np.isfinite(res["test_scores"]))
    pkl = glob.glob(os.path.join(save, "results", "*_results.pickle"))
    assert [os.path.basename(p) for p in pkl] == [
        f"efficientnet_b0_Adam_{out['suggestion']:.6g}_results.pickle"]
    with open(pkl[0], "rb") as f:
        assert pickle.load(f)["test_scores"] == res["test_scores"]
    ckpt = os.path.join(save, f"efficientnet_b0_Adam_{out['suggestion']:.6g}")
    assert os.path.isfile(os.path.join(ckpt, "hparams.yaml"))


def test_find_lr_sweeps_start_from_the_initial_weights(tree, monkeypatch):
    """Each make_state restores the model's initial weights, whatever an
    earlier sweep's steps did to them."""
    from imageretrievalresearch_tpu_torch.train import lr_finder
    seen = []

    def twice(make_state, step, batches, gen, **kw):
        batch = next(iter(batches))
        for _ in range(2):
            state = make_state(lambda s: 1e-2)
            before = [p.detach().clone() for p in state.model.parameters()]
            step(state, batch, gen)
            seen.append((before, [p.detach().clone()
                                  for p in state.model.parameters()]))
        return {"suggestion": None, "lrs": np.zeros(0),
                "losses": np.zeros(0)}

    monkeypatch.setattr(lr_finder, "lr_find", twice)
    find_lr_cli.run(find_lr_cli.build_parser().parse_args([
        "--ims_path", tree["root"], *TINY, *CPU]))
    (first, stepped), (second, _) = seen
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert not all(torch.equal(a, b) for a, b in zip(first, stepped))


@pytest.mark.parametrize("case", ["one_process", "fsdp_across_processes",
                                  "incomplete", "process_id_out_of_range"])
@pytest.mark.parametrize("cli", [train_cli, find_lr_cli])
def test_cli_multi_process_flags(cli, case, tree, tmp_path, capsys):
    """The multi-host flags: one process over them starts a group of one
    (JAX's line printed), runs, and leaves the group; FSDP across
    processes raises before any group starts, as JAX's trainer refuses
    it; the flags go together, with a process id below the count."""
    from imageretrievalresearch_tpu_torch.parallel import distributed
    addr = ["--coordinator_address", f"localhost:{distributed.free_port()}"]
    flags, error, match = {
        "one_process": ([*addr, "--num_processes", "1", "--process_id", "0",
                         "--max_epochs", "1", "--num_lr_steps", "3"],
                        None, None),
        "fsdp_across_processes": ([*addr, "--num_processes", "2",
                                   "--process_id", "0", "--param_sharding",
                                   "fsdp"], NotImplementedError,
                                  "single-process"),
        "incomplete": (["--num_processes", "2"], ValueError, "go together"),
        "process_id_out_of_range": ([*addr, "--num_processes", "2",
                                     "--process_id", "2"], ValueError,
                                    "--process_id 2 of --num_processes 2"),
    }[case]
    if cli is train_cli:
        flags = [f for f in flags if f not in ("--num_lr_steps", "3")]
    args = cli.build_parser().parse_args(
        ["--ims_path", tree["root"], *TINY, *CPU, "-sp", str(tmp_path),
         *flags])
    if error is None:
        cli.run(args)
        assert ("[distributed] process 0 of 1, 1 local / 1 global devices"
                in capsys.readouterr().out)
    else:
        with pytest.raises(error, match=match):
            cli.run(args)
    assert not distributed.in_group()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("cli", [train_cli, find_lr_cli])
def test_cli_defaults_to_the_card(cli, tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(cli.build_parser().parse_args(
            ["--ims_path", tree["root"], *TINY]))
