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

import torch

_PKG = pathlib.Path(__file__).resolve().parent
SOURCES = {
    "ensemble_mlp": _PKG / "ensemble_mlp" / "kernel.cu",
    "knn": _PKG / "knn" / "kernel.cu",
    "segment_dp": _PKG / "segment_dp" / "kernel.cu",
    "flash_attention": _PKG / "flash_attention" / "kernel.cu",
    "flash_decode": _PKG / "flash_decode" / "kernel.cu",
    "ssd_scan": _PKG / "ssd_scan" / "kernel.cu",
}
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-ldl")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures: every function returns the launch's cudaError_t as an int
# (the *_smem queries a size in bytes)
SIGNATURES = {
    "ensemble_mlp": {
        # x, w1, b1, w2, b2, out, M, T, d, h, stream
        "ensemble_mlp_forward_f32": (_P,) * 6 + (_I,) * 4 + (_P,),
        # x, w1, b1, w2, b2, mu_x, sd_x, mu_y, sd_y, out, T, d, h, stream
        "mlp_predict_f32": (_P,) * 10 + (_I,) * 3 + (_P,),
    },
    "knn": {
        # queries, hist, ys, mask, scale, out, Q, T, d, k, warps a query,
        # stream
        "knn_predict_f32": (_P,) * 6 + (_I,) * 5 + (_P,),
        # queries, hist, mask, out, Q, T, d, stream
        "pairwise_sq_dists_f32": (_P,) * 4 + (_I,) * 3 + (_P,),
    },
    "segment_dp": {
        # profiles, cost and back scratch (null: shared memory), cuts, M,
        # G, k, the plan's mt and cap, stream
        "segment_dp_fit_f32": (_P,) * 4 + (_I,) * 5 + (_P,),
        # profiles, cost, M, G, the plan's mt and cap, stream
        "segment_cost_f32": (_P,) * 2 + (_I,) * 4 + (_P,),
    },
    "flash_attention": {
        # q, k, v, out, B, S, H, Hkv, D, scale, causal, kv_len, stream
        "flash_attention_f32": (_P,) * 4 + (_I,) * 5 + (_F, _I, _I, _P),
        # q, k and v tensor maps, out, B, S, H, Hkv, D, scale, causal,
        # kv_len, stream
        "flash_attention_bf16": (_P,) * 4 + (_I,) * 5 + (_F, _I, _I, _P),
        # the same, and lse (B, H, S) fp32 after out
        "flash_attention_lse_f32": (_P,) * 5 + (_I,) * 5 + (_F, _I, _I, _P),
        "flash_attention_lse_bf16": (_P,) * 5 + (_I,) * 5 + (_F, _I, _I, _P),
        # dtype, q, k, v, o, dout, lse, delta, dq, B, S, H, Hkv, D, scale,
        # causal, kv_len, stream
        "flash_attention_bwd_dq": (_I,) + (_P,) * 8 + (_I,) * 5
        + (_F, _I, _I, _P),
        # dtype, q, k, v, dout, lse, delta, dk, dv, B, S, H, Hkv, D, scale,
        # causal, kv_len, stream
        "flash_attention_bwd_dkdv": (_I,) + (_P,) * 8 + (_I,) * 5
        + (_F, _I, _I, _P),
        # map_out, ptr, dims[4], byte strides[3], box[4]
        "flash_attention_tensor_map": (_P,) * 5,
        # D, 0 (dQ) or 1 (dK/dV): the bf16 backward kernel's dynamic shared
        # memory in bytes (a size, not an error code)
        "flash_attention_bwd_smem": (_I, _I),
    },
    "flash_decode": {
        # q dtype, cache dtype, P's dtype, q, k_cache, v_cache, pos, out,
        # lse (or null), B, H, Hkv, D, S_loc, k strides (B, S, Hkv), v
        # strides (B, S, Hkv), scale, offset, splits, span, stream
        "flash_decode_fwd": (_I,) * 3 + (_P,) * 6 + (_I,) * 5 + (_L,) * 6
        + (_F, _I, _I, _I, _P),
    },
    "ssd_scan": {
        # dtype, x, dt, B, C, a, y, final_state, B, S, H, P, N, Q,
        # x strides (B, S, H), B strides (B, S), C strides (B, S), stream
        "ssd_scan_fwd": (_I,) + (_P,) * 7 + (_I,) * 6 + (_L,) * 7 + (_P,),
        # dtype, x, dt, B, C, a, dy, dfinal (or null), the scratch prevs,
        # dstates (bf16; null for fp32), dB and dC partials and da
        # partials, dx, ddt, dB, dC, da, B, S, H, P, N, Q, x strides (B, S,
        # H), B strides (B, S), C strides (B, S), stream
        "ssd_scan_bwd": (_I,) + (_P,) * 17 + (_I,) * 6 + (_L,) * 7 + (_P,),
        # N, 0 (each chunk's state) or 1 (each chunk's gradient): the bf16
        # backward kernel's dynamic shared memory in bytes (a size)
        "ssd_scan_bwd_smem": (_I, _I),
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


def launch(fn, index: int, *args) -> int:
    """Call a kernel's C function ``fn`` with ``args`` and the current
    stream of CUDA device ``index``, on that device; returns its error
    code. It enters the device's context only when ``index`` is not the
    current device, and reads the stream as an int without making a Stream
    object, so a call on the current device costs one stream lookup and the
    ctypes call."""
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(index):
        return fn(*args, stream)
