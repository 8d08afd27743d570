"""Build the CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles each of ``csrc/*.cu`` for ``sm_90a`` (Hopper), all
sources at once in parallel processes, and links them into one shared
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
SOURCES = ("fused_nll.cu", "fused_dense.cu")
HEADERS = ("special.cuh",)
# no --use_fast_math: the kernels must agree with their plain versions
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_LL, _I, _F = ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "dca_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "dca_nll_fwd_workspace_floats": ([], ctypes.c_longlong),
    # y, mu, theta, pi, w, workspace, out, n, G, theta mode, pi mode, ridge,
    # with_pi, with_w, stream
    "dca_nll_fwd": ([_P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _F, _I, _I, _P], _I),
    # y, mu, theta, pi, w, scale, d mu, d theta, d pi, n, G, theta mode,
    # pi mode, ridge, with_pi, with_w, stream
    "dca_nll_bwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _F, _I,
                     _I, _P], _I),
    # splits, out: co-resident clusters of that many split-K blocks
    "dca_fused_dense_max_clusters": ([_I, ctypes.POINTER(ctypes.c_int)], _I),
    # x, w, b, s, t, sf, out, M, K, N, activation, with_bn, with_sf, bf16,
    # the plan (kind, bm, bn, bk, splits, cluster), stream
    "dca_fused_dense": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _P], _I),
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


def _run_all(cmds):
    """Run the commands at once; return (returncode, output) of each."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outputs = [p.communicate()[0] for p in procs]
    return [(p.returncode, text) for p, text in zip(procs, outputs)]


def build() -> str:
    """Compile the kernels unless this exact build exists; return the path
    of the shared library.  ``build.log`` beside it holds nvcc's output
    (registers, shared memory and spills of each kernel)."""
    out_dir = os.path.join(BUILD_DIR, _source_hash())
    lib_path = os.path.join(out_dir, "libdca_tpu_torch_kernels.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    # build under temporary names and rename: a concurrent process sees
    # either no library or a whole one
    work = tempfile.mkdtemp(dir=out_dir)
    try:
        nvcc = _nvcc()
        objs = [os.path.join(work, s + ".o") for s in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", "-o", o,
                 os.path.join(CSRC_DIR, s)] for s, o in zip(SOURCES, objs)]
        tmp_lib = os.path.join(work, "lib.so")
        link = [nvcc, "-shared", "-o", tmp_lib, *objs]
        results = _run_all(cmds)
        if all(rc == 0 for rc, _ in results):
            results += _run_all([link])
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            for cmd, (rc, text) in zip(cmds + [link], results):
                f.write(" ".join(cmd) + f"\n(exit {rc})\n{text}\n")
        failed = [(c, r) for c, r in zip(cmds + [link], results) if r[0] != 0]
        if failed:
            (cmd, (rc, text)) = failed[0]
            raise RuntimeError(
                f"nvcc failed with exit code {rc}: {' '.join(cmd)}\n{text}")
        os.replace(tmp_lib, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
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
