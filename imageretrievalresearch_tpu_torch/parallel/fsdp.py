"""ZeRO-3-style parameter and optimizer sharding ("FSDP") over the ranks
of a process group.

Counterpart of ``imageretrievalresearch_tpu/parallel/fsdp.py``. There,
every large parameter (and its Adam moments) lives sharded over the
mesh's ``data`` axis and GSPMD derives the all-gathers and the
reduce-scatter. Here the same layout is FSDP2's ``fully_shard`` over a
one-axis ``DeviceMesh`` of the group's ranks (the 2-D layout is below):
each parameter is a DTensor sharded on the dim :func:`fsdp_spec` picks,
the optimizer's state follows its parameter, FSDP all-gathers each
parameter for the forward and the backward and reduce-scatters its
gradient (averaged over the ranks, as DDP's all-reduce is).

The rule (``fsdp_spec``), JAX's: for each tensor, shard the LARGEST dim
divisible by the rank count, preferring the trailing dim on ties; tensors
smaller than ``min_elems`` and tensors with no divisible dim stay
replicated. FSDP2 shards every parameter it manages, so a parameter that
JAX replicates is split on dim 0 here, unevenly where the ranks do not
divide it (FSDP2 pads the last shard): a rounding error of the state's
bytes either way. Buffers (BatchNorm's running statistics) stay whole on
every rank; the group-wide BatchNorm keeps them equal.

The 2-D hybrid layout (JAX's ``put_fsdp(mesh2d, ..., axis_name="model")``
on a ``(data, model)`` mesh: the batch split over ``data``, the
parameters and optimizer state over ``model``) is FSDP2's HSDP over the
mesh's ``(data, model)`` DeviceMesh (``mesh.group_mesh``): each parameter
is replicated over ``data`` and sharded over ``model`` on ``fsdp_spec``'s
dim for the ``model`` axis's size; FSDP all-gathers it over ``model``,
reduce-scatters its gradient over ``model`` and all-reduces that over
``data``, averaging over every rank, which gives the global batch's mean
gradient: the ranks at one ``data`` index hold the same rows, so their
gradients are equal. The batch-wide collectives and BatchNorm run over the
``data`` sub-group (``Mesh.batch_group``). FSDP2 shards over its mesh's
last dim, so ``axis_name="data"`` on a 2-D mesh is refused (a one-axis
mesh shards over ``data``).

Not ported, on purpose: JAX's grouped-conv guard (``GROUPED_CONV_FAMILIES``,
``check_model_axis_safety``), which refuses the hybrid layout for
EfficientNet, RexNet and ResNeXt because XLA 0.9.0's GSPMD partitioner
multiplies a grouped conv's kernel gradient by the ``model`` axis's size
there (its own strict xfail asks for the guard's removal once XLA is
fixed). torch has no such partitioner: FSDP2 all-gathers each parameter
whole and the convolution runs unsharded, so those families run on the
2-D layout here (tests/test_torch_hybrid.py holds the shrunken b3a's
step against JAX's single-device step). ``model_name`` is accepted, as
JAX's keyword, and not required.
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


def full_tensor(t):
    """A DTensor gathered whole, any other value as it is: a collective,
    which every rank of the tensor's mesh calls in the same order. Each
    mesh dim that shards it is all-gathered over that dim's group by the
    process group's own ``all_gather_into_tensor`` (the shards padded to
    ``torch.chunk``'s size and the pad cut off), not by
    ``DTensor.full_tensor``, whose functional collectives crash the
    process on a gloo group of CUDA tensors (torch 2.11, ranks sharing a
    card)."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return t
    whole = t.to_local()
    for mesh_dim, placement in reversed(list(enumerate(t.placements))):
        if not isinstance(placement, Shard):
            continue
        group = t.device_mesh.get_group(mesh_dim)
        n, d = group.size(), placement.dim
        chunk = -(-t.shape[d] // n)
        local = whole.movedim(d, 0)
        if local.shape[0] < chunk:
            local = torch.cat([local, local.new_zeros(
                (chunk - local.shape[0], *local.shape[1:]))])
        out = local.new_empty((n * chunk, *local.shape[1:]))
        torch.distributed.all_gather_into_tensor(out, local.contiguous(),
                                                 group=group)
        whole = out[:t.shape[d]].movedim(0, d)
    return whole.contiguous()


def _device_mesh(mesh: Mesh, axis_name: str):
    """The DeviceMesh FSDP2 shards over: a one-axis mesh's, built here, or
    the ``(data, model)`` mesh's own (HSDP: FSDP2 replicates over its first
    dim and shards over its last)."""
    from torch.distributed.device_mesh import init_device_mesh
    if mesh.rank is None:
        raise ValueError("FSDP runs over a process group's mesh "
                         "(make_mesh() or group_mesh() inside "
                         "parallel.distributed's group)")
    if len(mesh.axis_names) == 1:
        return init_device_mesh(mesh.local_device.type,
                                (mesh.shape[axis_name],),
                                mesh_dim_names=(axis_name,))
    if tuple(mesh.axis_names) != ("data", "model") or axis_name != "model":
        raise ValueError(
            f"on a mesh of axes {mesh.axis_names} FSDP shards over "
            f"'model' of a ('data', 'model') mesh (HSDP: replicated over "
            f"'data', the axis the batch splits on), not over "
            f"{axis_name!r}; shard over 'data' on a one-axis mesh "
            "(make_mesh())")
    return mesh.device_mesh


def put_fsdp(mesh: Mesh, module: torch.nn.Module, axis_name: str = "data",
             min_elems: int = MIN_SHARD_ELEMS,
             model_name: str | None = None) -> torch.nn.Module:
    """``module`` moved to this rank's device and sharded in place by
    ``fully_shard``: each parameter on the dim :func:`fsdp_spec` picks
    over ``axis_name`` (dim 0 where it replicates). Every rank must hold
    the same values (a same-seed init), as JAX's ``put_fsdp`` requires.
    On a ``(data, model)`` mesh (``axis_name="model"``) each parameter is
    replicated over ``data`` and sharded over ``model``. ``model_name`` is
    JAX's keyword, accepted and not needed: the port refuses no family
    (the module's docstring says why)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    device_mesh = _device_mesh(mesh, axis_name)
    n = mesh.shape[axis_name]

    def placement(p: torch.nn.Parameter):
        spec = fsdp_spec(p.shape, n, axis_name, min_elems)
        return Shard(spec.index(axis_name) if spec else 0)

    module.to(mesh.local_device)
    fully_shard(module, mesh=device_mesh, shard_placement_fn=placement)
    return module


def constrain_fsdp(mesh: Mesh, module: torch.nn.Module,
                   optimizer: torch.optim.Optimizer | None = None,
                   axis_name: str = "data",
                   min_elems: int = MIN_SHARD_ELEMS,
                   model_name: str | None = None) -> None:
    """Check that the state is still in its FSDP layout after a step:
    each parameter of ``module`` a DTensor placed as :func:`fsdp_spec`
    says over ``axis_name`` (``Shard(d)``; on a ``(data, model)`` mesh
    ``(Replicate(), Shard(d))``), and each optimizer state of that
    parameter's shape placed the same (JAX constrains the updated state
    to its layout inside the step; here the layout is FSDP's, and this
    raises if it was lost). ``model_name``: as :func:`put_fsdp`."""
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
