"""GalleryIndex — persistent embedding gallery, f32 serving on the card.

Counterpart of ``imageretrievalresearch_tpu/retrieval/index.py``: an
append-only gallery of L2-normalized embeddings with class labels and
paths, saved as one portable ``.npz`` (format v1: f32; v2: bf16 bit view or
int8 + scales) that either package loads. Queries run on one device
through :func:`ops.retrieval.cosine_topk`; the f32 gallery is uploaded once
with its row norms computed there (build time, on the device).

Not ported yet: ``matmul_dtype`` other than float32 (bf16, int8,
int8_rerank serving) and ``mesh`` sharding.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from imageretrievalresearch_tpu_torch import metrics as M
from imageretrievalresearch_tpu_torch._device import resolve_device
from imageretrievalresearch_tpu_torch.ops.retrieval import (
    cosine_topk,
    l2_normalize,
)

_FORMAT_VERSION = 1          # raw f32 embeddings
_FORMAT_VERSION_COMPACT = 2  # bf16 bit-view / int8+scales storage


def _np_quantize_rows_int8(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization (round half to even), the JAX
    package's host arithmetic."""
    x = np.asarray(x, np.float32)
    scale = np.maximum(np.abs(x).max(axis=1, keepdims=True),
                       np.float32(1e-12)) / np.float32(127.0)
    codes = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return codes, scale.astype(np.float32)


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 (round to nearest even) as a uint16 bit view."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _bf16_from_bits(u16: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(u16).view(np.int16)).view(
        torch.bfloat16).float().numpy()


class GalleryIndex:
    """Append-only gallery of L2-normalized embeddings with labels.

    Host state is numpy (cheap appends); the device copy is made on the
    first query and dropped by ``add``. ``device=None`` means ``cuda``.
    """

    def __init__(self, dim: int, *, meta: dict | None = None,
                 device: str | torch.device | None = None):
        self.dim = int(dim)
        self.device = resolve_device(device)
        self._embeds: list[np.ndarray] = []
        self._classes: list[np.ndarray] = []
        self._paths: list[str] = []
        self.meta = dict(meta or {})
        self._device_gallery: tuple[torch.Tensor, torch.Tensor] | None = None
        self._device_classes: torch.Tensor | None = None

    # --- construction ---

    def add(self, embeddings, classes, paths: list[str] | None = None
            ) -> "GalleryIndex":
        """Append (N, dim) embeddings with (N,) integer class labels;
        normalized on the host, with torch on the CPU."""
        e = np.asarray(embeddings, dtype=np.float32)
        if e.ndim != 2 or e.shape[1] != self.dim:
            raise ValueError(f"expected (N, {self.dim}) embeddings, "
                             f"got {e.shape}")
        c = np.asarray(classes, dtype=np.int32).reshape(-1)
        if c.shape[0] != e.shape[0]:
            raise ValueError(f"{e.shape[0]} embeddings but {c.shape[0]} "
                             "class labels")
        if paths is not None and len(paths) != e.shape[0]:
            raise ValueError(f"{e.shape[0]} embeddings but {len(paths)} "
                             "paths")
        self._embeds.append(l2_normalize(torch.from_numpy(e)).numpy())
        self._classes.append(c)
        self._paths.extend(paths if paths is not None
                           else [""] * e.shape[0])
        self._device_gallery = None
        self._device_classes = None
        return self

    def __len__(self) -> int:
        return sum(e.shape[0] for e in self._embeds)

    @property
    def embeddings(self) -> np.ndarray:
        """(G, dim) normalized embeddings (host copy)."""
        if not self._embeds:
            return np.zeros((0, self.dim), np.float32)
        if len(self._embeds) > 1:
            self._embeds = [np.concatenate(self._embeds)]
        return self._embeds[0]

    @property
    def classes(self) -> np.ndarray:
        if not self._classes:
            return np.zeros((0,), np.int32)
        if len(self._classes) > 1:
            self._classes = [np.concatenate(self._classes)]
        return self._classes[0]

    @property
    def paths(self) -> list[str]:
        return self._paths

    # --- persistence ---

    def save(self, path: str | Path, *,
             store_dtype: str = "float32") -> None:
        """One portable .npz: embeddings, classes, paths, json meta.
        ``store_dtype`` 'bfloat16' (uint16 bit view) or 'int8' (codes +
        f32 scales) writes format v2."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        emb = self.embeddings
        extra = {}
        if store_dtype == "bfloat16":
            emb = _bf16_bits(emb)
        elif store_dtype == "int8":
            emb, extra["scales"] = _np_quantize_rows_int8(emb)
        elif store_dtype != "float32":
            raise ValueError(f"unknown store_dtype {store_dtype!r}")
        version = (_FORMAT_VERSION if store_dtype == "float32"
                   else _FORMAT_VERSION_COMPACT)
        np.savez_compressed(
            path,
            embeddings=emb,
            classes=self.classes,
            # fixed-width unicode, not dtype=object: loads stay pickle-free
            paths=np.asarray(self._paths, dtype=np.str_),
            # structural fields win over same-named user meta keys
            meta=np.frombuffer(json.dumps(
                {**self.meta, "version": version, "dim": self.dim,
                 "store_dtype": store_dtype}).encode(),
                dtype=np.uint8),
            **extra,
        )

    @classmethod
    def load(cls, path: str | Path, *,
             device: str | torch.device | None = None) -> "GalleryIndex":
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["meta"].tobytes()).decode())
            if meta.pop("version") not in (_FORMAT_VERSION,
                                           _FORMAT_VERSION_COMPACT):
                raise ValueError(f"unsupported gallery format in {path}")
            store_dtype = meta.pop("store_dtype", "float32")
            idx = cls(meta.pop("dim"), meta=meta, device=device)
            e = z["embeddings"]
            if store_dtype == "bfloat16":
                e = _bf16_from_bits(e)
            elif store_dtype == "int8":
                e = e.astype(np.float32) * z["scales"]
            else:
                e = e.astype(np.float32)
            if e.shape[0]:
                idx._embeds = [e]
                idx._classes = [z["classes"].astype(np.int32)]
                idx._paths = [str(p) for p in z["paths"]]
        return idx

    # --- querying ---

    def _gallery_on_device(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The f32 serving form: (G, dim) embeddings on the device and
        their row norms, computed there at upload."""
        if self._device_gallery is None:
            g = torch.from_numpy(self.embeddings).to(self.device)
            self._device_gallery = (g, torch.linalg.vector_norm(g, dim=1))
        return self._device_gallery

    def _classes_on_device(self) -> torch.Tensor:
        if self._device_classes is None:
            self._device_classes = torch.from_numpy(self.classes).to(
                self.device)
        return self._device_classes

    def _query_tensors(self, queries, k: int, method: str,
                       matmul_dtype: str, mesh, precision: str):
        if not len(self):
            raise ValueError("empty gallery")
        if mesh is not None:
            raise NotImplementedError("mesh sharding is not ported yet")
        if matmul_dtype != "float32":
            raise NotImplementedError(
                f"matmul_dtype={matmul_dtype!r} is not ported yet")
        q = torch.as_tensor(queries, dtype=torch.float32,
                            device=self.device)
        g, g_norms = self._gallery_on_device()
        return cosine_topk(q, g, min(k, len(self)), method=method,
                           gallery_norms=g_norms, precision=precision)

    def query(self, queries, k: int = 150, *, method: str = "exact",
              matmul_dtype: str = "float32", mesh=None,
              precision: str = "default"
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Rank the gallery for (Q, dim) query embeddings; returns numpy
        ``(vals, inds, classes)`` each (Q, k). ``method`` follows
        :func:`ops.retrieval.cosine_topk` ('exact' takes the fused CUDA
        kernel on the card when eligible)."""
        vals, inds = self._query_tensors(queries, k, method, matmul_dtype,
                                         mesh, precision)
        inds = inds.cpu().numpy()
        return vals.cpu().numpy(), inds, self.classes[inds]

    def query_class_dedup(self, queries, *, k: int = 150,
                          num_unique: int = 3, method: str = "exact",
                          matmul_dtype: str = "float32", mesh=None,
                          precision: str = "default"
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Top-k, then the first ``num_unique`` unique classes
        (training_analysis.ipynb cell 2). Returns numpy ``(vals, inds,
        classes)`` each (Q, num_unique)."""
        vals, inds = self._query_tensors(queries, k, method, matmul_dtype,
                                         mesh, precision)
        uniq_inds, uniq_vals, uniq_cls = M.unique_class_dedup(
            inds, vals, self._classes_on_device(), num_unique=num_unique)
        return (uniq_vals.cpu().numpy(), uniq_inds.cpu().numpy(),
                uniq_cls.cpu().numpy())
