"""PyTorch/CUDA port of ``imageretrievalresearch_tpu`` for NVIDIA Hopper.

The JAX package is the reference; this package keeps its module layout.
Slices 1 and 2 cover gallery serving: the EfficientNet embedding path,
the ``GalleryIndex`` and ``RetrievalEngine`` library entry points in the
float32, bfloat16, int8 and int8_rerank modes, and the fused streaming
top-k, whose card path is a hand-written CUDA kernel with f32, bf16 and
int8 score variants (``csrc/fused_topk.cu``). Slice 3 adds the training
input path of the AutoAugment recipes: ``TransformSpec.train_autoaugment``
through ``build_batch_transform`` / ``build_triplet_transform``, whose
histogram, LUT and row-shift kernels are hand-written CUDA
(``csrc/image_ops.cu``). Slice 4 adds training on one card: the losses and
training metrics, ``config`` / ``recipes``, the optimizer and schedule,
the train and eval steps and the ``Trainer`` (``train/``), checkpointing
and logging (``utils/``), and the depthwise convolution's forward, input
gradient and tap gradients as hand-written CUDA (``csrc/depthwise_conv.cu``,
behind ``IRT_FORCE_PALLAS_DW=1`` as in JAX). Slice 11 adds the gallery
CLI (``cli/gallery.py``: build, info, query, serve) on a PNG decoder that
needs no PIL (``data/decode.py``) and a torch checkpoint loader
(``models/convert.py::load_checkpoint``). Slice 12 adds the RexNet, Swin,
ResNe(X)t and DarkNet backbones. Slice 13 adds training from disk: a
baseline JPEG codec of the port's own (``data/jpeg.py``), the data layer
(``data/``: splits, index, datasets, ``TripletLoader``, synthetic trees),
``train/lr_finder.py``, ``utils/analysis.py`` and the ``data_split``,
``train`` and ``find_lr`` CLIs. Slice 14 adds evaluation and analysis:
the ``inference`` CLI, Grad-CAM (``retrieval/gradcam.py``), the retrieval
grids (``retrieval/visualize.py``, matplotlib imported lazily),
``method='approx'`` (the dense path: exact, as JAX off the TPU), the
published-checkpoint registry (``checkpoints.py``) and the examples
(``examples/``). Slice 15 adds sharded retrieval (``parallel/``: a mesh of
devices driven by one process, ``sharded_cosine_topk``, and
``GalleryIndex(mesh=...)``) and the decode pool that stands for JAX's C++
loader (``data/native_loader.py``).
"""

from imageretrievalresearch_tpu_torch.version import __version__

__all__ = ["__version__"]
