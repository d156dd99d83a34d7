"""PyTorch/CUDA port of ``imageretrievalresearch_tpu`` for NVIDIA Hopper.

The JAX package is the reference; this package keeps its module layout.
Slice 1 covers f32 gallery serving: the EfficientNet embedding path, the
``GalleryIndex`` and ``RetrievalEngine`` library entry points, and the
fused streaming top-k, whose card path is a hand-written CUDA kernel
(``csrc/fused_topk.cu``).
"""

__version__ = "0.1.0"
