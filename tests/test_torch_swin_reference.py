"""The port's Swin (``models/swin.py``) against the benchmark's plain
reference (``port_bench/reference/swin.py``) on the CPU, and the port's
Swin spans and counters.

The comparison runs ``swin_s3_base_224``'s layout at 224 px: its window
table (7, 14, 14, 7), so stage 1 (a 56² grid) and stage 2 (28²) attend
in shifted windows under the -100 region masks, stages 3 (14²) and 4
(7²) clamp the window to the grid and attend globally, and patch merging
runs between stages; at depths (2, 2, 2, 2) and embed 32 with heads
(1, 2, 4, 8), so head dimension 32 as published, it runs in a second.
Every tensor of the state dict is drawn, the relative-position bias
tables too (the benchmark's generator draws them as zeros, so only this
test holds the port's bias index against timm's)."""

import json
from pathlib import Path

import pytest
import torch

import port_bench
from imageretrievalresearch_tpu_torch.models import create_model
from imageretrievalresearch_tpu_torch.utils import profiling
from port_bench import generator as gen
from port_bench.reference import models as ref_models

CONFIG = json.loads((Path(port_bench.__file__).parent / "configs"
                     / "swin_s3_base_224.json").read_text())
SMALL = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
SPANS = ("swin.attention", "swin.window", "swin.mlp", "swin.merge")
# both compute every product in float32 in the same order of operations
# (bitwise equal on this CPU); what may differ on another is how a
# library blocks a product, a few float32 ulps in a sum, well under 1e-5
# of the norm. A zeroed or transposed bias index moves it by 0.07-0.08.
TOLERANCE = 1e-5


def _reference_config() -> dict:
    return dict(CONFIG, **SMALL, num_features=8 * SMALL["embed_dim"])


def _port(device="cpu"):
    return create_model(CONFIG["model_name"],
                        num_classes=CONFIG["num_classes"], device=device,
                        seed=None, **SMALL)


def _drawn_state(template: dict, seed: int) -> dict:
    """Every key drawn: LeCun-normal weights, bias tables from a unit
    normal (as large as the scaled scores they are added to), LayerNorm
    scales near 1, biases and shifts of 0.1."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, t in template.items():
        x = torch.randn(t.shape, generator=g)
        if k.endswith("relative_position_bias_table"):
            pass
        elif k.endswith("weight") and t.ndim in (2, 4):
            x = x * t[0].numel() ** -0.5
        elif k.endswith("weight"):
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        out[k] = x
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((torch.linalg.vector_norm(a - b, dim=1)
                  / torch.linalg.vector_norm(b, dim=1)).max())


@pytest.fixture(scope="module")
def pair():
    ref = ref_models.build(_reference_config())
    sd = _drawn_state(ref.timm_state_dict(), seed=23)
    ref.load_timm_state_dict(sd)
    port = _port()
    port.load_timm_state_dict(sd)
    x = torch.randn((2, 224, 224, 3), generator=torch.Generator()
                    .manual_seed(7))
    return port, ref.eval(), sd, x


@torch.no_grad()
def test_port_matches_the_plain_reference(pair):
    port, ref, _, x = pair
    emb, logits = port.features_and_logits(x)
    emb_ref, logits_ref = ref(x)
    assert emb.shape == emb_ref.shape == (2, 256)
    assert _rel(emb, emb_ref) < TOLERANCE
    assert _rel(logits, logits_ref) < TOLERANCE


@torch.no_grad()
def test_the_bias_tables_move_the_embedding(pair):
    """The comparison above sees the bias: with the tables zeroed in the
    port alone, the embeddings part by far more than the tolerance."""
    _, ref, sd, x = pair
    port = _port()
    port.load_timm_state_dict({
        k: torch.zeros_like(v) if k.endswith("bias_table") else v
        for k, v in sd.items()})
    assert _rel(port.embed(x), ref(x)[0]) > 100 * TOLERANCE


def test_generator_weights_load_strictly_at_full_size(monkeypatch):
    """The benchmark's weights for the configuration (key set and shapes,
    drawn on the meta device: no generator there, so none is given) load
    strictly into the port's full-size model."""
    monkeypatch.setattr(gen, "device_generator", lambda seed, device: None)
    sd = gen.weights(CONFIG, 5, "meta")
    with torch.device("meta"):
        model = create_model(CONFIG["model_name"],
                             num_classes=CONFIG["num_classes"],
                             device="meta", seed=None)
    model.load_timm_state_dict(sd)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.net.state_dict().items()}
    assert model.num_features == CONFIG["num_features"]


@torch.no_grad()
def test_counters_and_spans_under_a_profiler(monkeypatch):
    monkeypatch.setattr(profiling, "_COUNTS", {})
    model = _port()
    x = torch.zeros((2, 224, 224, 3))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.embed(x)
    # per stage (grid, window as clamped, heads): (56, 7, 1), (28, 14, 2),
    # (14, 14, 4), (7, 7, 8), two blocks each; a block call's windows are
    # B (grid / window)² = 2 x (64, 4, 1, 1), its scores windows x heads x
    # (window²)², and the odd block of stages 1 and 2 (grid > window) is
    # shifted and masked; on the CPU every attention and MLP call is
    # eager, an MLP call's multiply-adds 2 x tokens x dim x 4 dim
    assert profiling.counts() == {
        "swin.attn_eager": 8,
        "swin.mlp_eager": 8,
        "swin.mlp_macs": 2 * 2 * 8 * (3136 * 32 ** 2 + 784 * 64 ** 2
                                      + 196 * 128 ** 2 + 49 * 256 ** 2),
        "swin.windows": 2 * 2 * (64 + 4 + 1 + 1),
        "swin.masked_windows": 2 * (64 + 4),
        "swin.attn_scores": 2 * 2 * (64 * 1 * 49 ** 2 + 4 * 2 * 196 ** 2
                                     + 1 * 4 * 196 ** 2 + 1 * 8 * 49 ** 2)}
    names = {e.name for e in prof.events()}
    assert set(SPANS) <= names


@torch.no_grad()
def test_counters_stay_still_without_a_profiler(monkeypatch):
    monkeypatch.setattr(profiling, "_COUNTS", {})
    _port().embed(torch.zeros((1, 224, 224, 3)))
    assert profiling.counts() == {}
