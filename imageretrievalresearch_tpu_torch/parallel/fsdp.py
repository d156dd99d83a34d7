"""ZeRO-3-style parameter and optimizer sharding ("FSDP") over the ranks
of a process group.

Counterpart of ``imageretrievalresearch_tpu/parallel/fsdp.py``. There,
every large parameter (and its Adam moments) lives sharded over the
mesh's ``data`` axis and GSPMD derives the all-gathers and the
reduce-scatter. Here the same layout is FSDP2's ``fully_shard`` over a
one-axis ``DeviceMesh`` of the group's ranks: each parameter is a DTensor
sharded on the dim :func:`fsdp_spec` picks, the optimizer's state follows
its parameter, FSDP all-gathers each parameter for the forward and the
backward and reduce-scatters its gradient (averaged over the ranks, as
DDP's all-reduce is).

The rule (``fsdp_spec``), JAX's: for each tensor, shard the LARGEST dim
divisible by the rank count, preferring the trailing dim on ties; tensors
smaller than ``min_elems`` and tensors with no divisible dim stay
replicated. FSDP2 shards every parameter it manages, so a parameter that
JAX replicates is split on dim 0 here, unevenly where the ranks do not
divide it (FSDP2 pads the last shard): a rounding error of the state's
bytes either way. Buffers (BatchNorm's running statistics) stay whole on
every rank; the group-wide BatchNorm keeps them equal.

Not ported: JAX's 2-D hybrid layout and its grouped-conv guard
(``check_model_axis_safety``): the port's mesh has one axis.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from imageretrievalresearch_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    _tree_map,
)

# Leaves below this many elements are replicated: a (C,) BatchNorm vector
# costs nothing to replicate. 8192 f32 elements = 32 KiB.
MIN_SHARD_ELEMS = 8192


def fsdp_spec(shape: tuple, n_shards: int, axis_name: str = "data",
              min_elems: int = MIN_SHARD_ELEMS) -> tuple:
    """The spec (a ``PartitionSpec``-like tuple, ``()`` replicated) that
    shards the largest ``n_shards``-divisible dim."""
    shape = tuple(int(d) for d in shape)
    if int(np.prod(shape, dtype=np.int64)) < min_elems:
        return ()
    best_size, best_dim = -1, -1
    for i, d in enumerate(shape):
        # >= prefers the later dim on ties (out-features over kernel taps)
        if d % n_shards == 0 and d > 0 and d >= best_size:
            best_size, best_dim = d, i
    if best_dim < 0:
        return ()
    spec: list = [None] * len(shape)
    spec[best_dim] = axis_name
    return tuple(spec)


def fsdp_sharding(mesh: Mesh, tree: Any, axis_name: str = "data",
                  min_elems: int = MIN_SHARD_ELEMS) -> Any:
    """A tree of :class:`NamedSharding` mirroring ``tree`` (a dict / list
    / tuple of tensors or shapes; only ``.shape`` is read)."""
    n = mesh.shape[axis_name]
    return _tree_map(lambda x: NamedSharding(mesh, fsdp_spec(
        getattr(x, "shape", x), n, axis_name, min_elems)), tree)


def _device_mesh(mesh: Mesh, axis_name: str):
    from torch.distributed.device_mesh import init_device_mesh
    if mesh.rank is None:
        raise ValueError("FSDP runs over a process group's mesh "
                         "(make_mesh() inside parallel.distributed's group)")
    return init_device_mesh(mesh.local_device.type, (mesh.shape[axis_name],),
                            mesh_dim_names=(axis_name,))


def put_fsdp(mesh: Mesh, module: torch.nn.Module, axis_name: str = "data",
             min_elems: int = MIN_SHARD_ELEMS) -> torch.nn.Module:
    """``module`` moved to this rank's device and sharded in place by
    ``fully_shard``: each parameter on the dim :func:`fsdp_spec` picks
    (dim 0 where it replicates). Every rank must hold the same values (a
    same-seed init), as JAX's ``put_fsdp`` requires."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    n = mesh.shape[axis_name]

    def placement(p: torch.nn.Parameter):
        spec = fsdp_spec(p.shape, n, axis_name, min_elems)
        return Shard(spec.index(axis_name) if spec else 0)

    module.to(mesh.local_device)
    fully_shard(module, mesh=_device_mesh(mesh, axis_name),
                shard_placement_fn=placement)
    return module


def constrain_fsdp(mesh: Mesh, module: torch.nn.Module,
                   optimizer: torch.optim.Optimizer | None = None,
                   axis_name: str = "data",
                   min_elems: int = MIN_SHARD_ELEMS) -> None:
    """Check that the state is still in its FSDP layout after a step:
    each parameter of ``module`` a DTensor sharded on :func:`fsdp_spec`'s
    dim, and each optimizer state of that parameter's shape sharded the
    same (JAX constrains the updated state to its layout inside the step;
    here the layout is FSDP's, and this raises if it was lost)."""
    from torch.distributed.tensor import DTensor

    n = mesh.shape[axis_name]
    for name, p in module.named_parameters():
        spec = fsdp_spec(p.shape, n, axis_name, min_elems)
        want = NamedSharding(mesh, spec if spec else (axis_name,)).placements
        held = [p] + ([t for t in optimizer.state.get(p, {}).values()
                       if isinstance(t, torch.Tensor)
                       and t.shape == p.shape] if optimizer else [])
        for t in held:
            if not isinstance(t, DTensor) or tuple(t.placements) != want:
                raise RuntimeError(
                    f"{name}: lost its FSDP layout {want} (holds "
                    f"{getattr(t, 'placements', 'a whole tensor')})")
