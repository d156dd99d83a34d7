"""Parallelism: the device mesh and the sharded gallery retrieval.

Counterpart of ``imageretrievalresearch_tpu/parallel``, for retrieval: a
:class:`Mesh` is one process driving a tuple of devices (JAX's single
controller), the gallery's rows are placed shard by shard
(``put_row_sharded``) and ranked per shard with an all-gather merge
(``sharded_cosine_topk``). Multi-device training (``shard_batch``,
``put_replicated``, ``replicate``, ``data_sharding`` and ``fsdp.py``) is
not ported yet.
"""

from imageretrievalresearch_tpu_torch.parallel.gallery import (
    sharded_cosine_topk,
)
from imageretrievalresearch_tpu_torch.parallel.mesh import (
    Mesh,
    RowSharded,
    make_mesh,
    pad_to_multiple,
    put_row_sharded,
)

__all__ = ["Mesh", "RowSharded", "make_mesh", "pad_to_multiple",
           "put_row_sharded", "sharded_cosine_topk"]
