"""Sharded gallery retrieval: rank each row shard on its device, gather
the candidates, merge.

Counterpart of ``imageretrievalresearch_tpu/parallel/gallery.py``. The
gallery is split by rows over a :class:`parallel.mesh.Mesh`; each shard
ranks the normalized queries with the ranking of the single-device path
(``ops.retrieval.rank_normalized``: on a CUDA shard the fused kernel of
the mode, 1, 2 or 3, with the certificate repair where it is eligible,
else the dense path); each shard's top-``min(k, shard)`` is copied to
``mesh.devices[0]`` (the all-gather) and merged by a stable top-k, so
ties go to the lowest global index. The scores of a row do not depend on
the shard it lies in, so the result is the unsharded ranking's bit for
bit.
"""

from __future__ import annotations

import numpy as np
import torch

from imageretrievalresearch_tpu_torch.ops.retrieval import (
    FUSED_BINS,
    FUSED_T_DEPTH,
    _check_fused_k,
    _check_matmul_dtype,
    _check_precision,
    _check_prepared,
    _fused_eligible,
    _prepare_gallery,
    _stable_topk,
    l2_normalize,
    rank_normalized,
)
from imageretrievalresearch_tpu_torch.parallel.mesh import (
    Mesh,
    RowSharded,
    put_row_sharded,
)


def _as_tensor(x):
    if x is None or isinstance(x, (RowSharded, torch.Tensor)):
        return x
    return torch.as_tensor(np.ascontiguousarray(x))


def _on_mesh(x, mesh: Mesh, axis_name: str) -> RowSharded:
    """``x`` as row shards on the mesh: a :class:`RowSharded` whose shards
    already lie on the mesh's devices passes through; anything else is
    placed by :func:`put_row_sharded`."""
    if isinstance(x, RowSharded):
        if len(x.shards) != mesh.shape[axis_name] or any(
                s.device != torch.device(d) for s, d in
                zip(x.shards, mesh.devices)):
            raise ValueError("row shards do not lie on this mesh's devices")
        return x
    return put_row_sharded(x, mesh, axis_name)


def sharded_cosine_topk(queries, gallery, k: int, mesh: Mesh, *,
                        axis_name: str = "data",
                        use_fused: bool | None = None,
                        matmul_dtype: str = "float32",
                        gallery_scale=None, gallery_norms=None,
                        precision: str = "default"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, D) queries x (G, D) gallery sharded on ``axis_name`` -> global
    ``(vals, inds)`` (Q, min(k, G)) on ``mesh.devices[0]``; inds int32.

    The gallery (and ``gallery_scale`` (G, 1) / ``gallery_norms`` (G,))
    is a :class:`RowSharded` on the mesh or an array that is placed there
    row by row; G must divide the mesh (pad upstream). It may be raw f32
    or prepared (bf16 normalized, int8 codes with their scales), as for
    :func:`ops.retrieval.cosine_topk`. q̂ = ``l2_normalize(queries)`` is
    computed once, on ``mesh.devices[0]``, and copied to each shard. Each
    shard takes the fused path where ``use_fused`` says so, by default
    where its device is CUDA and ``_fused_eligible(Q, shard, D, k_local)``
    holds (``use_fused=True`` on a CPU shard runs the kernel's plain
    version), else the dense path."""
    gallery, gallery_scale, gallery_norms = map(
        _as_tensor, (gallery, gallery_scale, gallery_norms))
    _check_matmul_dtype(matmul_dtype)
    _check_prepared(gallery, matmul_dtype, gallery_scale)
    _check_precision(precision, matmul_dtype)
    if gallery_norms is not None and matmul_dtype != "float32":
        raise ValueError("gallery_norms applies to the float32 mode only")
    n_dev = mesh.shape[axis_name]
    g = gallery.shape[0]
    if g % n_dev:
        raise ValueError("pad gallery to a multiple of the mesh size")
    shard = g // n_dev
    # each shard's top-min(k, shard) holds its part of the global top-k
    k = min(k, g)
    k_local = min(k, shard)
    if use_fused:
        _check_fused_k(k_local)
    shards = _on_mesh(gallery, mesh, axis_name).shards
    scales = (_on_mesh(gallery_scale, mesh, axis_name).shards
              if gallery_scale is not None else (None,) * n_dev)
    if isinstance(gallery_norms, torch.Tensor):
        gallery_norms = gallery_norms.reshape(-1)
    norms = (_on_mesh(gallery_norms, mesh, axis_name).shards
             if gallery_norms is not None else (None,) * n_dev)
    home = mesh.devices[0]
    q = torch.as_tensor(queries, dtype=torch.float32).to(home)
    q_hat = l2_normalize(q)
    nq, d = q.shape
    vals, inds = [], []
    for i, (dev, g_i, s_i, n_i) in enumerate(zip(mesh.devices, shards,
                                                 scales, norms)):
        if matmul_dtype == "float32":
            g_in, s_in = g_i.float(), None
        else:
            g_in, s_in = _prepare_gallery(g_i, matmul_dtype, s_i)
        fused = use_fused if use_fused is not None else (
            dev.type == "cuda"
            and _fused_eligible(nq, shard, d, k_local, FUSED_BINS,
                                FUSED_T_DEPTH))
        v, ix = rank_normalized(q_hat.to(dev), g_in, k_local, fused=fused,
                                matmul_dtype=matmul_dtype,
                                gallery_scale=s_in, gallery_norms=n_i)
        # localize -> globalize by the shard's row offset, gather home
        vals.append(v.to(home))
        inds.append((ix + i * shard).to(home))
    mvals, mpos = _stable_topk(torch.cat(vals, dim=1), k)
    return mvals, torch.gather(torch.cat(inds, dim=1), 1, mpos)
