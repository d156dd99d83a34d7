"""The general generator: every input of a run, made from ``--seed`` and
the cell's configuration and traffic files.

- ``weights``: one timm-keyed state dict, made on the device in one draw:
  He-normal convolutions, LeCun-normal linear layers, zero biases,
  identity BatchNorm. The program and the reference both load it.
- ``gallery``: class-clustered unit rows (``traffic['gallery']``).
- ``images``: uint8 RGB images, drawn on the device, held on the host as
  a caller holds decoded photos.
- ``triplet_pool``: raw triplet batches as a loader hands them over
  (``qry``, ``pos``, ``neg`` uint8 NHWC arrays, ``cat_idx``,
  ``prod_idx``).

Every stream has its own seed (``seeds``), so one part can grow without
moving the others.
"""

from __future__ import annotations

import math

import numpy as np
import torch

STREAMS = ("weights", "gallery", "requests", "batches", "sample",
           "augment", "dropout")


def seeds(seed: int) -> dict:
    """A 63-bit seed per stream, from any whole number."""
    s = int(seed) % (1 << 64)
    seq = np.random.SeedSequence([s & 0xFFFFFFFF, s >> 32])
    return {name: int(child.generate_state(2, np.uint64)[0] >> np.uint64(1))
            for name, child in zip(STREAMS, seq.spawn(len(STREAMS)))}


def device_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def weights(cfg: dict, seed: int, device) -> dict:
    """The configuration's timm-keyed state dict: the keys, shapes and
    dtypes of its reference net's (built on the meta device)."""
    from port_bench.reference.models import build
    template = build(cfg, device="meta").timm_state_dict()
    drawn = [(k, t) for k, t in template.items()
             if k.endswith("weight") and t.ndim in (2, 4)]
    total = sum(t.numel() for _, t in drawn)
    flat = torch.randn(total, generator=device_generator(seed, device),
                       device=device)
    out, at = {}, 0
    for k, t in drawn:
        n = t.numel()
        fan_in = n // t.shape[0]
        gain = 2.0 if t.ndim == 4 else 1.0
        out[k] = (flat[at:at + n].view(t.shape)
                  * math.sqrt(gain / fan_in)).to(t.dtype)
        at += n
    for k, t in template.items():
        if k in out:
            continue
        if k.endswith("running_var") or (k.endswith("weight")
                                          and t.ndim == 1):
            out[k] = torch.ones(t.shape, dtype=t.dtype, device=device)
        else:
            out[k] = torch.zeros(t.shape, dtype=t.dtype, device=device)
    return out


def gallery(spec: dict, seed: int, device) -> tuple:
    """(rows (G, D) float32, classes (G,) int64) on ``device``: row i is
    ``normalize(center_c + noise)`` of its class c, the noise's norm
    ``spec['spread']`` times the center's."""
    g = device_generator(seed, device)
    n, d, c = spec["rows"], spec["dim"], spec["classes"]
    centers = torch.randn((c, d), generator=g, device=device)
    centers /= torch.linalg.vector_norm(centers, dim=1, keepdim=True)
    classes = torch.randint(0, c, (n,), generator=g, device=device)
    rows = torch.randn((n, d), generator=g, device=device)
    rows *= spec["spread"] / math.sqrt(d)
    rows += centers[classes]
    rows /= torch.linalg.vector_norm(rows, dim=1, keepdim=True)
    return rows, classes


def images(n: int, size: int, generator: torch.Generator) -> np.ndarray:
    """(n, size, size, 3) uint8 on the host, drawn on the generator's
    device."""
    return torch.randint(0, 256, (n, size, size, 3), generator=generator,
                         device=generator.device,
                         dtype=torch.uint8).cpu().numpy()


def request_pool(spec: dict, seed: int, device) -> list:
    """``spec['pool']`` distinct requests of ``spec['queries']`` images."""
    g = device_generator(seed, device)
    allx = images(spec["pool"] * spec["queries"], spec["image_px"], g)
    return list(allx.reshape(spec["pool"], spec["queries"],
                             *allx.shape[1:]))


def triplet_pool(spec: dict, num_classes: int, seed: int, device) -> list:
    """``spec['pool']`` distinct raw triplet batches of
    ``spec['triplets']`` rows."""
    g = device_generator(seed, device)
    p, b = spec["pool"], spec["triplets"]
    allx = images(p * 3 * b, spec["image_px"], g).reshape(
        p, 3, b, spec["image_px"], spec["image_px"], 3)
    labels = torch.randint(0, num_classes, (p, 2, b), generator=g,
                           device=device).cpu().numpy()
    return [{"qry": allx[i, 0], "pos": [allx[i, 1]], "neg": [allx[i, 2]],
             "cat_idx": labels[i, 0], "prod_idx": labels[i, 1]}
            for i in range(p)]


def dropout_masks(steps: int, rows: int, features: int, keep: float,
                  seed: int, device) -> list:
    """The head dropout's keep masks of ``steps`` consecutive steps, as a
    ``torch.Generator`` seeded with ``seed`` yields them to the program's
    dropout (one ``rand`` of (rows, features) a step)."""
    g = device_generator(seed, device)
    return [torch.rand((rows, features), generator=g, device=device) < keep
            for _ in range(steps)]
