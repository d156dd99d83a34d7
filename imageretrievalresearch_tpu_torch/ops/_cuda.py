"""Build, load and launch the port's CUDA kernels (plain C interface,
ctypes).

Each source under ``csrc/`` compiles with its own ``nvcc`` call into a
shared library under ``imageretrievalresearch_tpu_torch/_build/`` (listed
in ``.gitignore``), at the first use of that library, named by a hash of
the source so an edited source rebuilds. Nothing here runs at import
time: the CPU tests import every module, and a machine without the CUDA
toolkit has no ``nvcc``. The kernels' wrappers share the device dispatch
(``on_cpu``), the operand checks and ``launch``.

It also keeps the one record of what the kernels did, read through
``ledger()``: each successful launch under its C entry
(``fused_topk_f32``, ``image_column_shift``, ...), each plain version run
on a CUDA tensor under ``plain:<entry>``, and ``nhwc_copy``.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterator

import torch

_PKG = Path(__file__).resolve().parent.parent
# library name -> its source
SOURCES = {"fused_topk": _PKG / "csrc" / "fused_topk.cu",
           "image_ops": _PKG / "csrc" / "image_ops.cu",
           "depthwise_conv": _PKG / "csrc" / "depthwise_conv.cu",
           "stream_probe": _PKG / "csrc" / "stream_probe.cu",
           "window_attention": _PKG / "csrc" / "window_attention.cu",
           "linear_tf32x3": _PKG / "csrc" / "linear_tf32x3.cu"}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_RUNGS = ("stream_only", "matmul_only", "insert_only")
# library name -> entry point -> argtypes: pointers and the stream as
# c_void_p, sizes as c_int (a workspace's length as c_longlong); every
# entry point returns a CUDA error code
SIGNATURES = {
    # q, gallery, its norms or scales (or none), 7 ints, the workspace and
    # its length in words, the stream
    "fused_topk": {**{f"fused_topk_{mode}": [_P] * 3 + [_I] * 7
                      + [_P, _L, _P] for mode in ("f32", "bf16", "int8")},
                   # x, N, D, the codes, the scales, the stream
                   "quantize_rows_int8_f32": [_P] + [_I] * 2 + [_P] * 3,
                   # q̂, the raw gallery, Q, G, D, the scores, the stream
                   "cosine_scores_f32": [_P] * 2 + [_I] * 3 + [_P] * 2,
                   # the ladder: q̂, gallery, norms, Q, G, D, k, splits,
                   # the two outputs, the stream; int8: q̂'s codes,
                   # gallery codes, their two scales, then the same
                   **{f"fused_topk_{mode}_{rung}": [_P] * 3 + [_I] * 5
                      + [_P] * 3
                      for mode in ("f32", "bf16") for rung in _RUNGS},
                   **{f"fused_topk_int8_{rung}": [_P] * 4 + [_I] * 5
                      + [_P] * 3 for rung in _RUNGS}},
    "image_ops": {"image_histogram": [_P, _I, _I, _P, _P],
                  "image_lut_apply": [_P, _P, _I, _I, _P, _P],
                  "image_row_shift": [_P, _P, _I, _I, _I, _P, _P],
                  "image_column_shift": [_P, _P, _I, _I, _I, _I, _P, _P],
                  "image_row_shift_cubic": [_P, _P, _I, _I, _I, _P, _P]},
    # tensors, then the geometry, the plan (band height, channels, the
    # split), the bf16 flag, the stream
    "depthwise_conv": {"dw_conv_forward": [_P] * 3 + [_I] * 13 + [_P],
                       "dw_conv_grad_x": [_P] * 3 + [_I] * 13 + [_P],
                       "dw_conv_grad_w": [_P] * 4 + [_I] * 13 + [_P]},
    # x, N, D, rows, the row sums, the output, the stream
    "stream_probe": {"stream_probe_f32": [_P] + [_I] * 3 + [_P] * 3},
    # qkv, the bias table, the mask (or none), the output; the windows,
    # the window's side, heads, the mask's windows, the scale (c_float),
    # the stream
    "window_attention": {"window_attention_f32": [_P] * 4 + [_I] * 4
                         + [ctypes.c_float, _P]},
    # x, W_hi, W_lo, the bias (or none), the output; M, N, K, the GELU
    # flag, the grid's cap (the SM count), the stream
    "linear_tf32x3": {"linear_tf32x3_f32": [_P] * 5 + [_I] * 5 + [_P]},
}

_LIBS: dict[str, ctypes.CDLL] = {}
# every count since the process started, read through ledger(); the lock
# keeps counts from concurrent threads (a server's handlers) whole
_COUNTS: collections.Counter[str] = collections.Counter()
_COUNTS_LOCK = threading.Lock()


def record(key: str) -> None:
    """Count one ``key`` in the ledger."""
    with _COUNTS_LOCK:
        _COUNTS[key] += 1


def plain_on_card(entry: str, t: torch.Tensor) -> None:
    """Count a run of the plain version of C entry ``entry`` on ``t`` as
    ``plain:<entry>`` when ``t`` is a CUDA tensor: on the card the kernel
    is the main path, so a count there shows a call that left it."""
    if t.device.type == "cuda":
        record(f"plain:{entry}")


@contextlib.contextmanager
def ledger() -> Iterator[collections.Counter[str]]:
    """Yield a Counter that holds, once the block has exited, what the
    ledger counted inside it (a key counted 0 times is absent). Blocks
    nest: each holds only its own block's counts."""
    with _COUNTS_LOCK:
        start = _COUNTS.copy()
    inside: collections.Counter[str] = collections.Counter()
    try:
        yield inside
    finally:
        with _COUNTS_LOCK:
            inside.update(_COUNTS - start)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> str:
    """Compile library ``name`` if it is missing; returns nvcc's output
    (its -Xptxas -v register and shared-memory report), or "" when the
    library was already built."""
    out = _lib_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
         str(SOURCES[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name].name}:\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def load_library(name: str) -> ctypes.CDLL:
    """Library ``name`` (built now if it is missing), with the C
    signatures of its entry points declared."""
    if name not in _LIBS:
        build(name)
        lib = ctypes.CDLL(str(_lib_path(name)))
        for entry, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = _I
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [_I]
        err.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def error_string(err: int, name: str) -> str:
    return getattr(load_library(name), f"{name}_error_string")(err).decode()


def device_index(device: torch.device) -> int:
    """The card index of ``device`` (the current card for a bare "cuda")."""
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def sm_count(device: torch.device) -> int:
    """The SM count of ``device``'s card, read once per card."""
    return _sm_count(device_index(device))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the wrapper runs its plain version), False
    for a CUDA one (it launches its kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def check_operand(name: str, t: torch.Tensor,
                  dtype: torch.dtype | tuple[torch.dtype, ...], shape: tuple,
                  device: torch.device) -> torch.Tensor:
    """Raise unless ``t`` is contiguous, of ``dtype`` (or one of them) and
    ``shape``, on ``device``; returns ``t``."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if (t.device != device or t.dtype not in dtypes
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{name}: expected {' or '.join(map(str, dtypes))} "
                         f"{tuple(shape)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t


_ENTRIES: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def stream_handle(index: int) -> int:
    """The handle (cudaStream_t as an int) of card ``index``'s current
    stream: torch's own lookup, without the Stream object that
    ``torch.cuda.current_stream`` builds."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Call entry point ``entry`` of library ``name`` on the current stream
    of ``device``, tensors passed as pointers, ints as ints and None as a
    null pointer; raise on the CUDA error it returns, else count the
    launch under ``entry`` in the ledger. The entry point is
    looked up once; the device becomes current only for a call on another
    device than the current one."""
    fn = _ENTRIES.get((name, entry))
    if fn is None:
        fn = _ENTRIES[name, entry] = getattr(load_library(name), entry)
    ptrs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    index = device_index(device)
    if torch.cuda.current_device() == index:
        err = fn(*ptrs, stream_handle(index))
    else:
        with torch.cuda.device(index):
            err = fn(*ptrs, stream_handle(index))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} "
                           f"({error_string(err, name)})")
    record(entry)
