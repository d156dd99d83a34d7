"""Build and load the port's CUDA kernels (plain C interface, ctypes).

Each source under ``csrc/`` compiles with its own ``nvcc`` call into a
shared library under ``imageretrievalresearch_tpu_torch/_build/`` (listed
in ``.gitignore``), at the first use of that library, named by a hash of
the source so an edited source rebuilds. Nothing here runs at import
time: the CPU tests import every module, and a machine without the CUDA
toolkit has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
# library name -> its source
SOURCES = {"fused_topk": _PKG / "csrc" / "fused_topk.cu",
           "image_ops": _PKG / "csrc" / "image_ops.cu"}
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
                   "fused_topk_int8": [_P] * 4 + [_I] * 7 + [_P] * 7},
    "image_ops": {"image_histogram": [_P, _I, _I, _P, _P],
                  "image_lut_apply": [_P, _P, _I, _I, _P, _P],
                  "image_row_shift": [_P, _P, _I, _I, _I, _P, _P],
                  "image_row_shift_cubic": [_P, _P, _I, _I, _I, _P, _P]},
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
