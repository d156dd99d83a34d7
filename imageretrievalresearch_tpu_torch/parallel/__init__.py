"""Parallelism: device meshes, data-parallel training over a process
group, FSDP, and the sharded gallery retrieval.

Counterpart of ``imageretrievalresearch_tpu/parallel``. JAX runs one
controller over its devices; the mapping here:

- retrieval: a :class:`Mesh` of devices that one process drives; the
  gallery's rows are placed shard by shard (``put_row_sharded``) and
  ranked per shard with an all-gather merge (``sharded_cosine_topk``);
- training: one process per device, joined by a ``torch.distributed``
  process group (``parallel.distributed``: NCCL on cards, gloo on the
  CPU), whose ranks :func:`make_mesh` (one ``data`` axis) or
  :func:`group_mesh` (e.g. a ``(data, model)`` mesh) describes inside the
  group. The global batch is split on its leading dim over ``data``
  (``shard_batch``), the state is replicated (``put_replicated``, then
  ``DistributedDataParallel``) or sharded (``put_fsdp``: FSDP2's
  ``fully_shard`` on ``fsdp_spec``'s dims over ``data``; on a ``(data,
  model)`` mesh over ``model``, replicated over ``data``: HSDP);
  BatchNorm's statistics and the in-batch metrics cover the global batch
  (``models.layers.batch_norm``, ``distributed.all_gather_rows``, over
  ``Mesh.batch_group``: the ranks that hold distinct rows).

JAX's grouped-conv guard for the 2-D layout (``check_model_axis_safety``)
works around an XLA partitioner fault that torch does not have, and is
not ported (``parallel.fsdp``'s docstring).
"""

from imageretrievalresearch_tpu_torch.parallel.fsdp import (
    MIN_SHARD_ELEMS,
    constrain_fsdp,
    fsdp_sharding,
    fsdp_spec,
    put_fsdp,
)
from imageretrievalresearch_tpu_torch.parallel.gallery import (
    sharded_cosine_topk,
)
from imageretrievalresearch_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    RowSharded,
    data_sharding,
    group_mesh,
    make_mesh,
    pad_to_multiple,
    put_replicated,
    put_row_sharded,
    replicate,
    shard_batch,
)

__all__ = ["make_mesh", "group_mesh", "shard_batch", "replicate",
           "put_replicated", "data_sharding", "sharded_cosine_topk",
           "fsdp_spec", "fsdp_sharding", "put_fsdp", "constrain_fsdp",
           "MIN_SHARD_ELEMS", "Mesh", "NamedSharding", "RowSharded",
           "pad_to_multiple", "put_row_sharded"]
