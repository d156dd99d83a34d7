"""Device mesh for sharded retrieval: one process driving a tuple of
devices.

Counterpart of the gallery half of ``imageretrievalresearch_tpu/parallel/
mesh.py``. JAX's gallery mesh has one controller: one process drives
every device, and ``put_row_sharded`` places each row shard from the
host. The port keeps that model. A :class:`Mesh` is a tuple of torch
devices that the calling process drives, with one axis (``data``): it
uses no ``torch.distributed`` process group and no collective library
(the sharded top-k's all-gather is a copy of each shard's candidates to
``mesh.devices[0]``). A device may repeat: ``Mesh(["cuda:0"] * 4)`` is
four shards on one card, ``Mesh(["cpu"] * 8)`` the counterpart of JAX's
eight virtual CPU devices.

Not ported yet (they belong to multi-device training): ``shard_batch``,
``put_replicated``, ``replicate`` and ``data_sharding``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from imageretrievalresearch_tpu_torch._device import set_float32_precision


class Mesh:
    """A one-axis mesh: ``devices`` (repeats allowed) and ``axis_names``
    (one name). ``shape`` maps the axis name to the device count, as
    ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: Sequence[str | torch.device],
                 axis_names: Sequence[str] = ("data",)):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if len(self.axis_names) != 1:
            raise ValueError(f"one mesh axis is supported, got "
                             f"{self.axis_names}")
        if any(d.type == "cuda" for d in self.devices):
            set_float32_precision()

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"{self.axis_names})")


def make_mesh(num_devices: int | None = None,
              axis_name: str = "data") -> Mesh:
    """The first ``num_devices`` CUDA devices (all by default), as JAX
    takes ``jax.devices()[:num_devices]``. Raises without a GPU: build a
    ``Mesh`` of explicit devices (e.g. ``["cpu"] * 8``) to run elsewhere."""
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
