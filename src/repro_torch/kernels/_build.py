"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each ``kernel.cu`` exposes a plain C interface (device pointers, sizes,
the CUDA stream; it returns the ``cudaGetLastError()`` code of its
launch), so it compiles in seconds without PyTorch's headers. The shared
library goes to ``build/torch_kernels/`` at the repository root (or
``$REPRO_TORCH_BUILD_DIR``), named by a hash of its source, so an edited
source is rebuilt and never mistaken for a stale library. ``build()``
starts one nvcc per source, all at once, and waits for them all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent
SOURCES = {
    "ensemble_mlp": _PKG / "ensemble_mlp" / "kernel.cu",
    "knn": _PKG / "knn" / "kernel.cu",
}
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every function returns the launch's cudaError_t as an int
SIGNATURES = {
    "ensemble_mlp": {
        # x, w1, b1, w2, b2, out, M, T, d, h, stream
        "ensemble_mlp_forward_f32": (_P,) * 6 + (_I,) * 4 + (_P,),
    },
    "knn": {
        # queries, hist, ys, mask, scale, out, Q, T, d, k, stream
        "knn_predict_f32": (_P,) * 6 + (_I,) * 4 + (_P,),
        # queries, hist, mask, out, Q, T, d, stream
        "pairwise_sq_dists_f32": (_P,) * 4 + (_I,) * 3 + (_P,),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}


def build_dir() -> pathlib.Path:
    d = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return pathlib.Path(d) if d else _PKG.parents[2] / "build" / "torch_kernels"


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def lib_path(name: str) -> pathlib.Path:
    src = SOURCES[name].read_bytes()
    digest = hashlib.sha256(src + " ".join(ARCH_FLAGS + NVCC_FLAGS)
                            .encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def build(names=None) -> dict[str, float]:
    """Compile every named kernel whose library is missing, all nvcc
    processes at once. Returns the seconds each build took (0.0 for a
    library already built); raises with nvcc's output if one fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not lib_path(n).exists()]
    times = {n: 0.0 for n in names}
    if not todo:
        return times
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        out = lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
               str(SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out, time.perf_counter())
    errors = []
    for n, (p, tmp, out, t0) in procs.items():
        log, _ = p.communicate()
        times[n] = time.perf_counter() - t0
        BUILD_LOG[n] = log
        if p.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[n]}:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built at first use, with its C
    signatures set (pointers and the stream as ``c_void_p``)."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({err}: {msg})")
