"""Build, load and launch the port's CUDA kernels (plain C interface,
ctypes).

Each source under ``csrc/`` compiles with its own ``nvcc`` call into a
shared library under ``imageretrievalresearch_tpu_torch/_build/`` (listed
in ``.gitignore``), at the first use of that library, named by a hash of
the source so an edited source rebuilds. Nothing here runs at import
time: the CPU tests import every module, and a machine without the CUDA
toolkit has no ``nvcc``. The kernels' wrappers share the device dispatch
(``on_cpu``), the operand checks and ``launch``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
# library name -> its source
SOURCES = {"fused_topk": _PKG / "csrc" / "fused_topk.cu",
           "image_ops": _PKG / "csrc" / "image_ops.cu",
           "depthwise_conv": _PKG / "csrc" / "depthwise_conv.cu",
           "stream_probe": _PKG / "csrc" / "stream_probe.cu"}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# library name -> entry point -> argtypes: pointers and the stream as
# c_void_p, sizes as c_int; every entry point returns a CUDA error code
SIGNATURES = {
    # operands (q, gallery, then norms / scales), 7 ints, 6 outputs and
    # scratch, the stream
    "fused_topk": {"fused_topk_f32": [_P] * 3 + [_I] * 7 + [_P] * 7,
                   "fused_topk_bf16": [_P] * 2 + [_I] * 7 + [_P] * 7,
                   "fused_topk_int8": [_P] * 4 + [_I] * 7 + [_P] * 7,
                   # q̂, the raw gallery, Q, G, D, the scores, the stream
                   "cosine_scores_f32": [_P] * 2 + [_I] * 3 + [_P] * 2,
                   # the ladder: q̂, gallery, norms, Q, G, D, k, splits,
                   # the two outputs, the stream
                   **{f"fused_topk_{mode}_{rung}": [_P] * 3 + [_I] * 5
                      + [_P] * 3
                      for mode in ("f32", "bf16")
                      for rung in ("stream_only", "matmul_only",
                                   "insert_only")}},
    "image_ops": {"image_histogram": [_P, _I, _I, _P, _P],
                  "image_lut_apply": [_P, _P, _I, _I, _P, _P],
                  "image_row_shift": [_P, _P, _I, _I, _I, _P, _P],
                  "image_row_shift_cubic": [_P, _P, _I, _I, _I, _P, _P]},
    # tensors, then the geometry, the tile plan (and the tap-gradient
    # split), the bf16 flag, the stream
    "depthwise_conv": {"dw_conv_forward": [_P] * 3 + [_I] * 12 + [_P],
                       "dw_conv_grad_w": [_P] * 4 + [_I] * 14 + [_P]},
    # x, N, D, rows, the row sums, the output, the stream
    "stream_probe": {"stream_probe_f32": [_P] + [_I] * 3 + [_P] * 3},
}

_LIBS: dict[str, ctypes.CDLL] = {}


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


def launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Call entry point ``entry`` of library ``name`` on the current stream
    of ``device``, tensors passed as pointers and ints as ints; raise on
    the CUDA error it returns."""
    lib = load_library(name)
    p = ctypes.c_void_p
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(
            *(p(a.data_ptr()) if torch.is_tensor(a) else a for a in args),
            p(stream))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} "
                           f"({error_string(err, name)})")
