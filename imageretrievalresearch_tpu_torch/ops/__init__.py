"""Device-side ops: preprocessing with on-device AutoAugment, pooling,
retrieval, depthwise convolution; the hand-written CUDA kernels of the
fused top-k and the dense cosine scores (``retrieval``), of AutoAugment
(``image_kernels``), of the depthwise convolution (``depthwise``) and of
Swin's window attention (``attention``)."""

from imageretrievalresearch_tpu_torch.ops.autoaugment import (
    imagenet_policy_batch,
)
from imageretrievalresearch_tpu_torch.ops.depthwise import depthwise_conv2d
from imageretrievalresearch_tpu_torch.ops.pooling import get_fm
from imageretrievalresearch_tpu_torch.ops.preprocess import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    TransformSpec,
    build_batch_transform,
    build_triplet_transform,
    square_pad,
)
from imageretrievalresearch_tpu_torch.ops.retrieval import (
    cosine_scores,
    cosine_topk,
    fused_cosine_scores,
    fused_cosine_topk,
    l2_normalize,
)

__all__ = [
    "TransformSpec",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "build_batch_transform",
    "build_triplet_transform",
    "square_pad",
    "get_fm",
    "cosine_scores",
    "cosine_topk",
    "fused_cosine_scores",
    "fused_cosine_topk",
    "l2_normalize",
    "imagenet_policy_batch",
    "depthwise_conv2d",
]
