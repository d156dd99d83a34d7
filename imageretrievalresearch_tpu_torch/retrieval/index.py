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

With ``mesh`` (a :class:`parallel.mesh.Mesh`), the float32, bfloat16
and int8 modes run sharded: the host rows are zero-padded to a multiple
of the mesh size (int8 scales and f32 norms padded with 1.0, so a pad row
scores exactly 0), each device makes only its own row shard of the
mode's form, :func:`parallel.gallery.sharded_cosine_topk` ranks the
shards and merges them, and the pad rows are dropped after an
over-query of ``k + pad``. The result equals the unsharded query's bit
for bit. ``int8_rerank`` and ``approx`` are refused with a mesh, as in
JAX.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from imageretrievalresearch_tpu_torch import metrics as M
from imageretrievalresearch_tpu_torch._device import resolve_device
from imageretrievalresearch_tpu_torch.ops.retrieval import (
    _stable_topk,
    cosine_topk,
    int8_rerank_topk,
    l2_normalize,
    pack_codes_int32,
    quantize_rows_int8,
    quantize_rows_int8_residual,
)
from imageretrievalresearch_tpu_torch.parallel.gallery import (
    sharded_cosine_topk,
)
from imageretrievalresearch_tpu_torch.parallel.mesh import RowSharded

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


def _f32_form(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The float32 resident form of normalized rows: the rows and their
    norms, computed on the rows' device."""
    return x, torch.linalg.vector_norm(x, dim=1)


# each mode's converter of uploaded rows, and the value of each of its
# tensors in a pad row (0: a zero row; 1.0: its norm or scale), so that a
# pad row scores exactly 0
_FORMS = {"float32": (_f32_form, (0, 1.0)),
          "bfloat16": (lambda x: (x.to(torch.bfloat16),), (0,)),
          "int8": (quantize_rows_int8, (0, 1.0)),
          "int8_rerank": (_rerank_form, None)}


def _drop_pad_rows(vals: torch.Tensor, inds: torch.Tensor, n_real: int,
                   k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A top-(k + pad) result re-ranked after masking pad rows (index >=
    ``n_real``) to -inf: the stable top-k of the rest."""
    vals = torch.where(inds < n_real, vals, -torch.inf)
    vals, order = _stable_topk(vals, k)
    return vals, torch.gather(inds, 1, order)


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

    def _gallery_on_device(self, matmul_dtype: str = "float32", mesh=None
                           ) -> tuple:
        """The resident serving form of ``matmul_dtype``, made once per
        (mode, mesh devices) on the device from the host copy:

        - float32: ``(embeddings, norms)``, the norms computed on the
          device;
        - bfloat16: ``(embeddings as bf16,)``;
        - int8: ``(codes (G, D) int8, scales (G, 1) f32)``;
        - int8_rerank: ``(codes, scales, packed residual codes (G, D/4)
          int32, residual scales, max primary norm, max residual norm)``.

        The forms are converted in uploaded blocks of ``_UPLOAD_ROWS``
        rows. Codes, scales and norms are per row and the bounds are
        maxima over rows, so the blocks join to the same bits. With
        ``mesh`` each tensor is a :class:`parallel.mesh.RowSharded`: device
        i converts only rows ``[i * shard, (i + 1) * shard)`` of the host
        copy, padded with pad rows to ``shard = ceil(G / n)`` (int8_rerank
        has no sharded form)."""
        key = (matmul_dtype if mesh is None
               else (matmul_dtype, tuple(str(d) for d in mesh.devices)))
        if key not in self._device_gallery:
            if matmul_dtype not in _FORMS:
                raise ValueError(f"unknown matmul_dtype {matmul_dtype!r}")
            convert, pad_values = _FORMS[matmul_dtype]
            if mesh is None:
                form = self._converted(convert, 0, len(self), self.device)
            elif pad_values is None:
                raise ValueError(f"matmul_dtype={matmul_dtype!r} does not "
                                 "support mesh sharding yet")
            else:
                form = self._sharded(convert, pad_values, mesh)
            self._device_gallery[key] = form
        return self._device_gallery[key]

    def _converted(self, convert, lo: int, hi: int,
                   device: torch.device) -> tuple[torch.Tensor, ...]:
        """``convert`` applied on ``device`` to uploaded row blocks of rows
        ``[lo, hi)`` of the host copy; row tensors concatenate (into an
        allocation of their own), 0-d bounds take their max."""
        emb = self.embeddings
        parts = [convert(torch.tensor(emb[b:min(b + _UPLOAD_ROWS, hi)],
                                      device=device))
                 for b in range(lo, max(hi, lo + 1), _UPLOAD_ROWS)]
        return tuple(torch.cat(ts) if ts[0].ndim else torch.stack(ts).amax()
                     for ts in zip(*parts))

    def _sharded(self, convert, pad_values, mesh
                 ) -> tuple[RowSharded, ...]:
        """Each device's shard of the mode's form: its real rows converted
        on the device, then the pad rows."""
        n, g = mesh.shape["data"], len(self)
        shard = -(-g // n)
        per_device = []
        for i, dev in enumerate(mesh.devices):
            lo, hi = min(i * shard, g), min((i + 1) * shard, g)
            real = self._converted(convert, lo, hi, dev)
            per_device.append(tuple(
                torch.cat([t, torch.full((shard - (hi - lo), *t.shape[1:]),
                                         fill, dtype=t.dtype, device=dev)])
                if hi - lo < shard else t
                for t, fill in zip(real, pad_values)))
        return tuple(RowSharded(ts) for ts in zip(*per_device))

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
        form = self._gallery_on_device(matmul_dtype, mesh)
        g, aux = form[0], form[1] if len(form) > 1 else None
        f32 = matmul_dtype == "float32"
        kw = dict(matmul_dtype=matmul_dtype,
                  gallery_norms=aux if f32 else None,
                  gallery_scale=None if f32 else aux, precision=precision)
        if mesh is None:
            return cosine_topk(q, g, k, method=method, **kw)
        # a zero pad row scores exactly 0, which outranks real rows of
        # negative similarity: over-query by the pad count, then drop them
        pad = g.shape[0] - len(self)
        vals, inds = sharded_cosine_topk(q, g, min(k + pad, g.shape[0]),
                                         mesh, **kw)
        if pad:
            vals, inds = _drop_pad_rows(vals, inds, len(self), k)
        return vals[:, :k].to(self.device), inds[:, :k].to(self.device)

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
        ``shortlist``; exact method and default precision only). With
        ``mesh`` (a :class:`parallel.mesh.Mesh`; float32, bfloat16 and
        int8, exact method) the gallery is ranked in row shards over the
        mesh's devices, with the unsharded result."""
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
