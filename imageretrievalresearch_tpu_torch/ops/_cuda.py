"""Build and load the port's CUDA kernels (plain C interface, ctypes).

``csrc/fused_topk.cu`` compiles with one ``nvcc`` call into a shared
library under ``imageretrievalresearch_tpu_torch/_build/`` (listed in
``.gitignore``), at first use, named by a hash of the source so an edited
source rebuilds. Nothing here runs at import time: the CPU tests import
every module, and a machine without the CUDA toolkit has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fused_topk.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIB: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libfused_topk_{digest}.so"


def build() -> str:
    """Compile the kernel if its library is missing; returns nvcc's output
    (its -Xptxas -v register and shared-memory report), or "" when the
    library was already built."""
    out = _lib_path()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def load_library() -> ctypes.CDLL:
    """The kernels' library (built now if it is missing), with the C
    signatures of its three entry points declared."""
    global _LIB
    if _LIB is None:
        build()
        lib = ctypes.CDLL(str(_lib_path()))
        p, i = ctypes.c_void_p, ctypes.c_int
        # operands (q, gallery, then norms / scales), 7 ints, 6 outputs
        # and scratch, the stream
        for name, n_in in (("fused_topk_f32", 3), ("fused_topk_bf16", 2),
                           ("fused_topk_int8", 4)):
            fn = getattr(lib, name)
            fn.argtypes = [p] * n_in + [i] * 7 + [p] * 6 + [p]
            fn.restype = i
        lib.fused_topk_error_string.argtypes = [i]
        lib.fused_topk_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def error_string(err: int) -> str:
    return load_library().fused_topk_error_string(err).decode()
