"""GalleryIndex — persistent embedding gallery, served on the card.

Counterpart of ``imageretrievalresearch_tpu/retrieval/index.py``: an
append-only gallery of L2-normalized embeddings with class labels and
paths, saved as one portable ``.npz`` (format v1: f32; v2: bf16 bit view or
int8 + scales) that either package loads. Queries run on one device in
the serving modes ``float32``, ``bfloat16``, ``int8`` (through
:func:`ops.retrieval.cosine_topk`) and ``int8_rerank`` (through
:func:`ops.retrieval.int8_rerank_topk`). Each mode's resident form is
made on the device from the uploaded host rows once and cached, by the
same quantizers the ops use; the f32 form's row norms are computed on the
device at upload.

Not ported yet: ``mesh`` sharding.
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
    int8_rerank_topk,
    l2_normalize,
    pack_codes_int32,
    quantize_rows_int8,
    quantize_rows_int8_residual,
)

_FORMAT_VERSION = 1          # raw f32 embeddings
_FORMAT_VERSION_COMPACT = 2  # bf16 bit-view / int8+scales storage
# host rows uploaded and converted per step when a compact form is built:
# each f32 intermediate of the quantizers covers only these (100 MB at
# D = 1536), whatever the gallery's size
_UPLOAD_ROWS = 16384


def _rerank_form(x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The int8_rerank resident form of normalized rows: primary codes and
    scales, packed residual codes and scales, and the two norm bounds."""
    c1, s1, c2, s2, g1max, rmax = quantize_rows_int8_residual(x)
    return c1, s1, pack_codes_int32(c2), s2, g1max, rmax


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 (round to nearest even) as a uint16 bit view."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _bf16_from_bits(u16: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(u16).view(np.int16)).view(
        torch.bfloat16).float().numpy()


class GalleryIndex:
    """Append-only gallery of L2-normalized embeddings with labels.

    Host state is numpy (cheap appends); each mode's device form is made
    on its first query and all are dropped by ``add``. ``device=None``
    means ``cuda``.
    """

    def __init__(self, dim: int, *, meta: dict | None = None,
                 device: str | torch.device | None = None):
        self.dim = int(dim)
        self.device = resolve_device(device)
        self._embeds: list[np.ndarray] = []
        self._classes: list[np.ndarray] = []
        self._paths: list[str] = []
        self.meta = dict(meta or {})
        self._device_gallery: dict[str, tuple[torch.Tensor, ...]] = {}
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
        self._device_gallery = {}
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
            emb, extra["scales"] = (t.numpy() for t in quantize_rows_int8(
                torch.from_numpy(emb)))
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

    def _gallery_on_device(self, matmul_dtype: str = "float32"
                           ) -> tuple[torch.Tensor, ...]:
        """The resident serving form of ``matmul_dtype``, made once on the
        device from the host copy:

        - float32: ``(embeddings, norms)``, the norms computed on the
          device;
        - bfloat16: ``(embeddings as bf16,)``;
        - int8: ``(codes (G, D) int8, scales (G, 1) f32)``;
        - int8_rerank: ``(codes, scales, packed residual codes (G, D/4)
          int32, residual scales, max primary norm, max residual norm)``.

        The compact forms are converted in uploaded blocks of
        ``_UPLOAD_ROWS`` rows. Codes and scales are per row and the bounds
        are maxima over rows, so the blocks join to the same bits."""
        if matmul_dtype not in self._device_gallery:
            if matmul_dtype == "float32":
                g = torch.from_numpy(self.embeddings).to(self.device)
                form = (g, torch.linalg.vector_norm(g, dim=1))
            elif matmul_dtype == "bfloat16":
                form = self._converted(lambda x: (x.to(torch.bfloat16),))
            elif matmul_dtype == "int8":
                form = self._converted(quantize_rows_int8)
            elif matmul_dtype == "int8_rerank":
                form = self._converted(_rerank_form)
            else:
                raise ValueError(f"unknown matmul_dtype {matmul_dtype!r}")
            self._device_gallery[matmul_dtype] = form
        return self._device_gallery[matmul_dtype]

    def _converted(self, convert) -> tuple[torch.Tensor, ...]:
        """``convert`` applied on the device to uploaded row blocks of the
        host copy; row tensors concatenate, 0-d bounds take their max."""
        emb = self.embeddings
        parts = [convert(torch.from_numpy(emb[lo:lo + _UPLOAD_ROWS]).to(
            self.device)) for lo in range(0, emb.shape[0], _UPLOAD_ROWS)]
        return tuple(torch.cat(ts) if ts[0].ndim else torch.stack(ts).amax()
                     for ts in zip(*parts))

    def _classes_on_device(self) -> torch.Tensor:
        if self._device_classes is None:
            self._device_classes = torch.from_numpy(self.classes).to(
                self.device)
        return self._device_classes

    def _query_tensors(self, queries, k: int, method: str,
                       matmul_dtype: str, mesh, precision: str,
                       shortlist: int):
        if not len(self):
            raise ValueError("empty gallery")
        if mesh is not None and method != "exact":
            raise ValueError(
                f"method={method!r} is not supported with mesh; the sharded"
                " path is exact-only")
        q = torch.as_tensor(queries, dtype=torch.float32,
                            device=self.device)
        k = min(k, len(self))
        if matmul_dtype == "int8_rerank":
            if mesh is not None:
                raise ValueError("matmul_dtype='int8_rerank' does not "
                                 "support mesh sharding yet")
            if method != "exact":
                raise ValueError("int8_rerank is an exact re-rank mode; "
                                 f"method={method!r} is not supported")
            if precision != "default":
                raise ValueError("int8_rerank already re-ranks in true f32 "
                                 "(JAX: Precision.HIGHEST); the precision "
                                 "knob applies to float32 mode only")
            c1, s1, c2, s2, g1m, rm = self._gallery_on_device(matmul_dtype)
            vals, inds, _ = int8_rerank_topk(
                q, c1, s1, c2, s2, k, shortlist=shortlist,
                gallery_norm_bound=g1m, residual_norm_bound=rm)
            return vals, inds
        if mesh is not None:
            raise NotImplementedError("mesh sharding is not ported yet")
        form = self._gallery_on_device(matmul_dtype)
        g, aux = form[0], form[1] if len(form) > 1 else None
        f32 = matmul_dtype == "float32"
        return cosine_topk(q, g, k, method=method, matmul_dtype=matmul_dtype,
                           gallery_norms=aux if f32 else None,
                           gallery_scale=None if f32 else aux,
                           precision=precision)

    def query(self, queries, k: int = 150, *, method: str = "exact",
              matmul_dtype: str = "float32", mesh=None,
              precision: str = "default", shortlist: int = 256
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Rank the gallery for (Q, dim) query embeddings; returns numpy
        ``(vals, inds, classes)`` each (Q, k). ``method`` and
        ``precision`` follow :func:`ops.retrieval.cosine_topk` ('exact'
        takes the fused CUDA kernel of the mode on the card when
        eligible; 'approx' the dense path, equal to exact on the port). ``matmul_dtype``: 'float32', 'bfloat16' or 'int8' (exact
        top-k of that mode's scores over its resident form), or
        'int8_rerank' (:func:`ops.retrieval.int8_rerank_topk` with this
        ``shortlist``; exact method and default precision only)."""
        vals, inds = self._query_tensors(queries, k, method, matmul_dtype,
                                         mesh, precision, shortlist)
        inds = inds.cpu().numpy()
        return vals.cpu().numpy(), inds, self.classes[inds]

    def query_class_dedup(self, queries, *, k: int = 150,
                          num_unique: int = 3, method: str = "exact",
                          matmul_dtype: str = "float32", mesh=None,
                          precision: str = "default", shortlist: int = 256
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Top-k, then the first ``num_unique`` unique classes
        (training_analysis.ipynb cell 2). Returns numpy ``(vals, inds,
        classes)`` each (Q, num_unique)."""
        vals, inds = self._query_tensors(queries, k, method, matmul_dtype,
                                         mesh, precision, shortlist)
        uniq_inds, uniq_vals, uniq_cls = M.unique_class_dedup(
            inds, vals, self._classes_on_device(), num_unique=num_unique)
        return (uniq_vals.cpu().numpy(), uniq_inds.cpu().numpy(),
                uniq_cls.cpu().numpy())
