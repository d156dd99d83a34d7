"""PyTorch/CUDA port of ``imageretrievalresearch_tpu`` for NVIDIA Hopper.

The JAX package is the reference; this package keeps its module layout.
Its layers, each calling only the ones below it:

- Entry points. ``cli/`` (``gallery``, ``inference``, ``train``,
  ``find_lr``, ``data_split``, ``convert``), ``examples/`` and the
  benchmark (``port_bench``, beside this package) drive the library:
  ``retrieval.RetrievalEngine`` and ``GalleryIndex`` for serving and
  evaluation, ``train.Trainer`` (with ``config`` / ``recipes``) for
  training.
- ``models/`` (the backbones, timm's module names; ``convert`` for
  checkpoints) and ``ops/``: retrieval scores and top-k
  (``ops/retrieval.py``), the AutoAugment image kernels
  (``ops/image_kernels.py``, ``ops/autoaugment.py``), the depthwise
  convolution (``ops/depthwise.py``, behind ``IRT_FORCE_PALLAS_DW=1`` as
  in JAX), Swin's window attention (``ops/attention.py``). Each kernel
  wrapper launches its hand-written kernel for a CUDA tensor and runs its
  plain PyTorch version for a CPU tensor. ``tools/`` profiles and times
  them (the fused top-k's ablation ladder and the stream probe are
  kernels of its own).
- ``ops/_cuda.py``: builds each ``csrc/`` source with ``nvcc`` at first
  use, loads it with ``ctypes``, launches its C entry points, and keeps
  the ledger of what the kernels did (launches by C entry, plain versions
  run on a CUDA tensor, layout copies), read through ``_cuda.ledger()``.
- ``csrc/``: the CUDA kernels (``fused_topk.cu``, ``image_ops.cu``,
  ``depthwise_conv.cu``, ``window_attention.cu``, ``stream_probe.cu``),
  each behind a plain C interface.

Beside them: ``parallel/`` (sharded retrieval over a mesh of devices, and
a ``torch.distributed`` group of one process per device with DDP, FSDP2
and the 2-D hybrid layout), ``data/`` (decoders, datasets,
``TripletLoader``, the decode pool) and ``utils/profiling.py`` (the
program's spans and counters, on while a ``torch.profiler`` records).
"""

from imageretrievalresearch_tpu_torch.version import __version__

__all__ = ["__version__"]
