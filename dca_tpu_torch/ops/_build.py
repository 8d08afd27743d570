"""Build the CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles ``csrc/*.cu`` for ``sm_90a`` (Hopper) into a shared
library with a plain C interface, in ``dca_tpu_torch/_build/<hash>/``.  The
hash covers the sources and the flags, so an edited source builds anew and
an unchanged one is loaded from the earlier build.  A failed build raises.
Nothing here runs at import time: this module is imported on machines with
no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("fused_nll.cu",)
HEADERS = ("special.cuh",)
# no --use_fast_math: the kernels must agree with their plain versions
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_LL, _I, _F = ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "dca_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "dca_nll_fwd_grid": ([ctypes.c_longlong], ctypes.c_int),
    # y, mu, theta, pi, partials, n, G, theta mode, pi mode, ridge, with_pi,
    # stream
    "dca_nll_fwd": ([_P, _P, _P, _P, _P, _LL, _LL, _I, _I, _F, _I, _P], _I),
    # y, mu, theta, pi, scale, d mu, d theta, d pi, n, G, theta mode,
    # pi mode, ridge, with_pi, stream
    "dca_nll_bwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _F, _I,
                     _P], _I),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels of dca_tpu_torch cannot be built"
        )
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels unless this exact build exists; return the path
    of the shared library.  ``build.log`` beside it holds nvcc's output
    (registers, shared memory and spills of each kernel)."""
    out_dir = os.path.join(BUILD_DIR, _source_hash())
    lib_path = os.path.join(out_dir, "libdca_tpu_torch_kernels.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    # build under a temporary name and rename: a concurrent process sees
    # either no library or a whole one
    fd, tmp_path = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp_path,
           *(os.path.join(CSRC_DIR, s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp_path)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}"
        )
    os.replace(tmp_path, lib_path)
    return lib_path


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(build())
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
