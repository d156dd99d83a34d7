"""Device meshes: one process driving a tuple of devices (sharded
retrieval), or the ranks of a process group (multi-device training).

Counterpart of ``imageretrievalresearch_tpu/parallel/mesh.py``. JAX has
one kind of mesh: one controller drives every device, and a multi-host
run adds a controller per host. The port has two readings of one
:class:`Mesh` class:

- ``Mesh(devices)`` (``rank`` None, one axis, ``data``): the calling
  process drives every device, with no process group and no collective
  library. Sharded retrieval runs on it (``put_row_sharded``; the sharded
  top-k's all-gather is a copy of each shard's candidates to
  ``mesh.devices[0]``). A device may repeat: ``Mesh(["cuda:0"] * 4)`` is
  four shards on one card, ``Mesh(["cpu"] * 8)`` the counterpart of JAX's
  eight virtual CPU devices.
- :func:`make_mesh` (one axis) or :func:`group_mesh` (any shape, e.g.
  ``group_mesh((2, 2), ("data", "model"))``) inside a process group
  (``parallel.distributed``): ``devices`` lists each rank's device in
  rank order and ``rank`` is this process's; it drives ``devices[rank]``
  only, and the group's collectives join the rest. Training runs on it:
  :func:`shard_batch` takes this rank's rows of a batch (split over
  ``data``, whole over ``model``), :func:`put_replicated` places a module
  or state the same on every rank, ``fsdp.put_fsdp`` shards it (over
  ``data`` on a one-axis mesh, over ``model`` on a ``(data, model)``
  one). The batch-wide collectives run over ``Mesh.batch_group``, the
  ranks that hold distinct rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from imageretrievalresearch_tpu_torch._device import set_float32_precision
from imageretrievalresearch_tpu_torch.parallel import distributed


class Mesh:
    """A mesh of ``devices`` (repeats allowed) over ``axis_names``.
    ``shape`` gives each axis's size in ``axis_names``' order (default:
    one axis of every device); ``mesh.shape`` maps each axis name to its
    size, as ``jax.sharding.Mesh.shape`` does. The devices lie in
    row-major order over the axes: on a ``(data, model)`` mesh the device
    (and rank) ``r`` sits at ``(r // model, r % model)``, as
    ``np.reshape(devices, (data, model))`` places it.

    ``rank`` None: this process drives every device (one axis only); an
    int: the mesh of a process group, whose rank ``rank`` this process is
    (it drives ``local_device`` only). A group's mesh of more than one
    axis carries ``device_mesh``, the ``torch.distributed`` DeviceMesh of
    the same layout (its sub-groups: :func:`group_mesh` builds it)."""

    def __init__(self, devices: Sequence[str | torch.device],
                 axis_names: Sequence[str] = ("data",),
                 shape: Sequence[int] | None = None, *,
                 rank: int | None = None, device_mesh=None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.rank = rank
        self.device_mesh = device_mesh
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        sizes = (tuple(int(n) for n in shape) if shape is not None
                 else (len(self.devices),))
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {sizes} for axes "
                             f"{self.axis_names}")
        if int(np.prod(sizes)) != len(self.devices):
            raise ValueError(f"a mesh of shape {sizes} needs "
                             f"{int(np.prod(sizes))} devices, got "
                             f"{len(self.devices)}")
        if rank is None and len(sizes) != 1:
            raise ValueError("a mesh that one process drives has one axis "
                             f"(got {self.axis_names}); a mesh of more "
                             "axes is a process group's (group_mesh)")
        self._sizes = sizes
        if any(d.type == "cuda" for d in self.devices):
            set_float32_precision()

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self._sizes))

    @property
    def local_device(self) -> torch.device:
        """The device this process drives on a process group's mesh."""
        if self.rank is None:
            raise ValueError("a mesh that one process drives has no "
                             "local device: training (shard_batch, "
                             "put_replicated, FSDP) takes a process "
                             "group's mesh")
        return self.devices[self.rank]

    @property
    def coords(self) -> dict[str, int]:
        """This rank's index along each axis (row-major) on a process
        group's mesh."""
        self.local_device       # raises on a mesh that one process drives
        index = np.unravel_index(self.rank, self._sizes)
        return {a: int(i) for a, i in zip(self.axis_names, index)}

    @property
    def batch_group(self):
        """The process group over which the ranks hold distinct rows of a
        batch (``shard_batch``'s ``data`` axis), for the batch-wide
        collectives: None (the whole group) on a one-axis mesh, the
        ``data`` axis's sub-group of this rank on a mesh of more axes."""
        if self.device_mesh is None or len(self.axis_names) == 1:
            return None
        return self.device_mesh.get_group("data")

    def rows_of(self, n: int) -> tuple[int, int]:
        """``(first, total)``: where this rank's ``n`` rows (its
        ``shard_batch`` part) lie in the global batch; the steps and the
        transforms take it as ``rows``."""
        return self.coords["data"] * n, n * self.shape["data"]

    def check_single_process(self, what: str) -> None:
        if self.rank is not None:
            raise ValueError(f"{what} runs on a mesh that one process "
                             "drives (Mesh(devices)), not on a process "
                             "group's mesh")

    def __repr__(self) -> str:
        rank = "" if self.rank is None else f", rank={self.rank}"
        shape = ("" if len(self._sizes) == 1
                 else f", shape={self._sizes}")
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"{self.axis_names}{shape}{rank})")


def group_mesh(shape: Sequence[int] | None = None,
               axis_names: Sequence[str] = ("data",)) -> Mesh:
    """The mesh of the process group this process is in: every rank's
    device in rank order, this process's rank, laid out as ``shape`` over
    ``axis_names`` (default: one axis of every rank). Every rank calls it
    together (it gathers the ranks' devices, and a mesh of more axes
    builds its DeviceMesh, whose sub-groups are new process groups). A
    2-D ``(data, model)`` mesh is JAX's
    ``Mesh(devices.reshape(data, model), ("data", "model"))``: the batch
    splits over ``data`` (:func:`shard_batch`) and ``fsdp.put_fsdp(...,
    axis_name="model")`` shards the parameters over ``model``."""
    if not distributed.in_group():
        raise RuntimeError("not in a process group: a group's mesh needs "
                           "parallel.distributed.init_group first")
    n = distributed.world_size()
    sizes = tuple(shape) if shape is not None else (n,)
    axis_names = tuple(axis_names)
    if int(np.prod(sizes)) != n:
        raise ValueError(f"a mesh of shape {sizes} in a process group of "
                         f"{n} ranks")
    if len(sizes) > 1 and "data" not in axis_names:
        raise ValueError(f"a group's mesh of axes {axis_names} needs a "
                         "'data' axis (the batch's)")
    names = [None] * n
    torch.distributed.all_gather_object(names,
                                        str(distributed.local_device()))
    device_mesh = None
    if len(sizes) > 1:
        from torch.distributed.device_mesh import init_device_mesh
        device_mesh = init_device_mesh(distributed.local_device().type,
                                       sizes, mesh_dim_names=axis_names)
    return Mesh(names, axis_names, sizes, rank=distributed.rank(),
                device_mesh=device_mesh)


def make_mesh(num_devices: int | None = None,
              axis_name: str = "data") -> Mesh:
    """A one-axis mesh, as JAX's ``make_mesh``. Inside a process group:
    the group's (:func:`group_mesh`; ``num_devices``, if given, must be
    the group's size). Otherwise the first ``num_devices`` CUDA devices
    (all by default), as JAX takes ``jax.devices()[:num_devices]``; that
    raises without a GPU: build a ``Mesh`` of explicit devices (e.g.
    ``["cpu"] * 8``) to run elsewhere."""
    if distributed.in_group():
        n = distributed.world_size()
        if num_devices is not None and num_devices != n:
            raise ValueError(f"num_devices={num_devices} in a process group "
                             f"of {n} ranks")
        return group_mesh((n,), (axis_name,))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: make_mesh takes the GPUs; build "
            "Mesh([...devices]) explicitly to run on the CPU")
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(devices, (axis_name,))


@dataclasses.dataclass(frozen=True)
class RowSharded:
    """A (G, ...) array held as one row shard per mesh device, in mesh
    order; each shard is its own allocation on its device."""

    shards: tuple[torch.Tensor, ...]

    @property
    def shape(self) -> tuple[int, ...]:
        head = self.shards[0]
        return (sum(s.shape[0] for s in self.shards), *head.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype


def _owned_copy(rows, device: torch.device) -> torch.Tensor:
    """``rows`` (numpy or torch) copied into a new contiguous allocation
    on ``device``: never a view of the source."""
    src = torch.as_tensor(rows)
    out = torch.empty(src.shape, dtype=src.dtype, device=device)
    return out.copy_(src)


def put_row_sharded(arr, mesh: Mesh, axis_name: str = "data"
                    ) -> RowSharded:
    """Place a host (or device) array onto the mesh sharded on its leading
    dim without materialising the whole array on any device: device i
    receives rows ``[i * shard, (i + 1) * shard)`` in an allocation of its
    own (so each shard's base address is the allocator's, aligned for
    the kernels' 16-byte TMA rows). The rows must divide the mesh (pad
    upstream, :func:`pad_to_multiple` or ``GalleryIndex``)."""
    mesh.check_single_process("put_row_sharded")
    n = mesh.shape[axis_name]
    if not isinstance(arr, torch.Tensor):
        arr = np.ascontiguousarray(arr)
    g = arr.shape[0]
    if g % n:
        raise ValueError(f"{g} rows do not divide a mesh of {n} devices; "
                         "pad to a multiple of the mesh size")
    shard = g // n
    return RowSharded(tuple(
        _owned_copy(arr[i * shard:(i + 1) * shard], dev)
        for i, dev in enumerate(mesh.devices)))


def _tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: Any) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def pad_to_multiple(batch: Any, multiple: int) -> tuple[Any, int]:
    """Edge-pad the leading dim of every array in a (dict / list / tuple)
    batch to a multiple of ``multiple``; returns ``(padded, real size)``."""
    sizes = {np.asarray(x).shape[0] for x in _leaves(batch)}
    if len(sizes) != 1:
        raise ValueError(f"ragged batch: leading sizes {sorted(sizes)}")
    n = sizes.pop()
    pad = (-n) % multiple
    if pad == 0:
        return batch, n

    def pad_fn(x):
        x = np.asarray(x)
        return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1), mode="edge")

    return _tree_map(pad_fn, batch), n


# ----------------------------------------------------------- training

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A layout on a mesh, as ``jax.sharding.NamedSharding``: ``spec`` is
    a tuple with the axis name at the sharded dim and None elsewhere
    (``()`` replicates), as a ``PartitionSpec`` reads."""

    mesh: Mesh
    spec: tuple

    @property
    def placements(self) -> tuple:
        """The ``torch.distributed.tensor`` placements of this layout, one
        per mesh axis: ``Shard(d)`` where the spec names the axis at dim
        d, ``Replicate()`` elsewhere."""
        from torch.distributed.tensor import Replicate, Shard
        return tuple(Shard(self.spec.index(a)) if a in self.spec
                     else Replicate() for a in self.mesh.axis_names)


def data_sharding(mesh: Mesh, ndim: int = 1,
                  axis_name: str = "data") -> NamedSharding:
    """Shard the leading (batch) dim, replicate the rest."""
    return NamedSharding(mesh, (axis_name,) + (None,) * (ndim - 1))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def shard_batch(mesh: Mesh, batch: Any, axis_name: str = "data") -> Any:
    """This rank's rows of a host batch (a dict / list / tuple of arrays),
    as tensors on its device, on a process group's mesh: where every
    process loads its own slice (``distributed.process_count() > 1``, the
    multi-host flags), the batch IS this rank's slice; otherwise it is the
    global batch, split on its leading dim over the ``axis_name`` axis and
    whole over the others (JAX's ``P(axis_name)``): the rank at index d of
    that axis takes rows ``[d * b, (d + 1) * b)``, ``b`` the rows over the
    axis's size (which must divide). On a ``(data, model)`` mesh the ranks
    at one ``data`` index hold the same rows."""
    n, dev = mesh.shape[axis_name], mesh.local_device
    r = mesh.coords[axis_name]
    local = distributed.process_count() > 1
    if local and len(mesh.axis_names) > 1:
        raise NotImplementedError(
            "processes that each load their own slice (the multi-host "
            "flags) train on a one-axis mesh; a mesh of more axes takes "
            "the global batch on every rank")

    def put(x):
        x = torch.as_tensor(np.asarray(x))
        if not local:
            if x.shape[0] % n:
                raise ValueError(f"{x.shape[0]} rows do not divide the "
                                 f"{n} ranks of the mesh")
            b = x.shape[0] // n
            x = x[r * b:(r + 1) * b]
        return x.to(dev)

    return _tree_map(put, batch)


def put_replicated(mesh: Mesh, tree: Any) -> Any:
    """The same values on every rank of a process group's mesh: a
    module's parameters and buffers (in place; the module is returned) or
    a tree of tensors, moved to this rank's device and broadcast from rank
    0, so a same-seed state holds rank 0's values everywhere."""
    dev = mesh.local_device

    def put(x):
        x = torch.as_tensor(x).to(dev)
        if distributed.world_size() > 1:
            torch.distributed.broadcast(x, 0)
        return x

    if isinstance(tree, torch.nn.Module):
        tree.to(dev)
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                put(t.data)
        return tree
    return _tree_map(put, tree)
