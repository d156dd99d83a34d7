"""The single-card triplet train step replayed from CUDA graphs against the
same step run eagerly, on the card.

Skipped without a CUDA device. Imports no JAX (the machine with the card
has none); run there with

    python -m pytest --noconftest -m cuda tests/test_torch_train_graph.py

Both sides start from the same weights and take the same batches and
dropout draws; the eager side is sent eager by a no-op forward pre-hook on
its backbone, which is how the step decides. Every comparison is bitwise:
the replays launch the kernels the eager step launches, on the same
operands.
"""

import warnings

import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu_torch.models import create_model
from imageretrievalresearch_tpu_torch.recipes import make_config
from imageretrievalresearch_tpu_torch.train import (
    Trainer,
    TrainState,
    build_train_step,
    make_optimizer,
    multistep_lr,
)
from imageretrievalresearch_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

N_CLS, B, SIZE, STEPS = 5, 8, 64, 4


@pytest.fixture
def cuda_device():
    # decided here, never at import: every xdist worker collects the same
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _model(name, device, hooked):
    kw = {"depth_mult": 0.2} if name == "efficientnet_b3a" else {}
    model = create_model(name, num_classes=N_CLS, width_mult=0.5,
                         drop_rate=0.3, device=device, seed=3, **kw)
    if hooked:
        model.register_forward_pre_hook(lambda module, args: None)
    return model


def _batches(device, n, b=B):
    g = torch.Generator().manual_seed(7)

    def images():
        return torch.rand((b, SIZE, SIZE, 3), generator=g).to(
            device, torch.bfloat16)

    def labels():
        return torch.randint(0, N_CLS, (b,), generator=g).to(device)
    return [{"qry": images(), "pos": [images()], "neg": [images()],
             "cat_idx": labels(), "prod_idx": labels()} for _ in range(n)]


def _run(name, device, hooked, batches, monkeypatch, embed=None):
    """STEPS steps from seed 3's weights under a recording profiler (the
    counters count only then): the metrics as returned, the values read
    right after each step, the state, the dropout generator and the
    counters."""
    cfg = make_config("train_efficient_cos_con_ce_loss", batch_size=B,
                      image_size=SIZE, device="cuda",
                      compute_dtype="bfloat16")
    model = _model(name, device, hooked)
    if embed is not None:
        model.embed = embed(model.embed)
    state = TrainState(model, make_optimizer(
        "Adam", model.parameters(), cfg.learning_rate, cfg.weight_decay), 0)
    step = build_train_step(cfg, multistep_lr(cfg.learning_rate, (2,), 0.1,
                                              1))
    gen = torch.Generator(device).manual_seed(11)
    monkeypatch.setattr(profiling, "_COUNTS", {})
    metrics, read = [], []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for batch in batches:
            state, m = step(state, batch, gen)
            metrics.append(m)
            read.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    return metrics, read, state, gen, profiling.counts()


def _assert_states_equal(a: TrainState, b: TrainState):
    assert a.step == b.step
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), k      # parameters, BatchNorm's buffers
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("name", ["efficientnet_b3a", "rexnet_150"])
def test_graphed_steps_equal_eager_steps(cuda_device, monkeypatch, name):
    batches = _batches(cuda_device, STEPS)
    em, eread, estate, egen, ecounts = _run(name, cuda_device, True,
                                            batches, monkeypatch)
    gm, gread, gstate, ggen, gcounts = _run(name, cuda_device, False,
                                            batches, monkeypatch)
    assert ecounts == {"train.eager_steps": STEPS}
    assert gcounts == {"train.eager_steps": 1, "train.graph_captures": 1,
                       "train.graph_replays": STEPS - 2}
    assert gread == eread
    # what a step returned keeps its values after the later replays
    assert [{k: float(v) for k, v in m.items()} for m in gm] == gread
    assert len({r["train_loss"] for r in gread}) == STEPS
    _assert_states_equal(gstate, estate)
    # the dropout generator advanced as the eager steps advanced it
    assert torch.equal(ggen.get_state(), egen.get_state())


def test_a_failed_capture_runs_the_step_eagerly(cuda_device, monkeypatch):
    """A host sync in the forward refuses the capture: the step runs
    eagerly, and so do later steps of that signature."""
    def syncing(embed):
        return lambda x: embed(x) + 0 * float(x.float().sum())
    batches = _batches(cuda_device, STEPS)
    _, eread, estate, egen, _ = _run("rexnet_150", cuda_device, True,
                                     batches, monkeypatch, syncing)
    with pytest.warns(UserWarning, match="capture failed"):
        _, gread, gstate, ggen, gcounts = _run(
            "rexnet_150", cuda_device, False, batches, monkeypatch, syncing)
    assert gcounts == {"train.eager_steps": STEPS}
    assert gread == eread
    _assert_states_equal(gstate, estate)
    assert torch.equal(ggen.get_state(), egen.get_state())


class _Loader:
    """Seeded uint8 triplet batches of 80 px; the last one partial."""

    def __init__(self, sizes):
        rng = np.random.default_rng(5)

        def u8(b):
            return rng.integers(0, 256, (b, 80, 80, 3), dtype=np.uint8)
        self.batches = [{"qry": u8(b), "pos": [u8(b)], "neg": [u8(b)],
                         "cat_idx": rng.integers(0, N_CLS, b),
                         "prod_idx": rng.integers(0, N_CLS, b)}
                        for b in sizes]

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)

    def set_epoch(self, epoch):
        pass


def test_capture_under_the_trainers_profiler(cuda_device, monkeypatch,
                                             tmp_path):
    """``Trainer.fit`` with ``profile_dir`` traces steps 1-3 (CPU and
    CUDA activity): step 1 captures inside the trace, 2-3 replay; the
    epochs equal a hooked (eager) trainer's, the partial batch of each
    epoch (eager in the first, captured in the second) and the second
    epoch's new generators included."""
    sizes = [B] * 5 + [B // 2]
    out = {}
    for hooked in (True, False):
        cfg = make_config("train", batch_size=B, image_size=SIZE,
                          device="cuda", compute_dtype="bfloat16",
                          profile_dir=str(tmp_path / f"p{int(hooked)}"))
        monkeypatch.setattr(profiling, "_COUNTS", {})
        trainer = Trainer(cfg, _model("rexnet_150", cuda_device, hooked),
                          _Loader(sizes))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            state, history = trainer.fit(max_epochs=2)
        # no step's gradient accumulators outlive it onto another stream
        assert not [w for w in caught if "AccumulateGrad" in str(w.message)]
        out[hooked] = (state, history, profiling.counts())
        assert (tmp_path / f"p{int(hooked)}" / "trace.json").exists()
    (estate, ehist, ecounts), (gstate, ghist, gcounts) = out[True], out[False]
    assert ecounts == {"train.eager_steps": 3}
    assert gcounts == {"train.graph_captures": 1, "train.graph_replays": 2}
    assert ghist == ehist
    _assert_states_equal(gstate, estate)
