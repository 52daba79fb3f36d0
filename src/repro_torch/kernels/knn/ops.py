"""k-NN wrappers: checks, output allocation and the launches.

``knn_predict`` is what the k-NN model computes for a block of queries:
scaled distances over the masked history, the k nearest (lowest index
first on ties) and the mean of their targets. ``pairwise_sq_dists`` is the
reference TPU kernel's own function (``scale = 1``, 3.4e38 at masked
columns). CPU tensors take the plain versions (``ref.py``); CUDA tensors
launch the kernels in ``kernel.cu`` on the current stream.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import KERNEL_LAUNCHES
from repro_torch.kernels import _build
from repro_torch.kernels.knn.ref import knn_predict_ref, pairwise_sq_dists_ref

MAX_K = 32          # the kernel's register list
MAX_FEATURES = 32   # shared-memory tile of 256 rows x (d + 2) floats


def _check_cuda(*args):
    dev = args[0].device
    if dev.type != "cuda":
        raise ValueError(f"no knn kernel for device {dev}")
    for a in args:
        if a.device != dev or a.dtype != torch.float32 \
                or not a.is_contiguous():
            raise ValueError("knn takes contiguous float32 tensors on one "
                             "CUDA device")


def _check_shapes(queries, hist, **vectors):
    if queries.dim() != 2 or hist.dim() != 2 \
            or queries.shape[1] != hist.shape[1]:
        raise ValueError("queries must be (Q,d) and hist (T,d)")
    for name, (a, n) in vectors.items():
        if tuple(a.shape) != (n,):
            raise ValueError(f"{name} has shape {tuple(a.shape)}, "
                             f"expected ({n},)")
    if queries.shape[1] > MAX_FEATURES:
        raise ValueError(f"knn kernel takes at most {MAX_FEATURES} features")


def knn_predict(queries, hist, ys, mask, scale, k: int = 5):
    """queries (Q,d), hist (T,d), ys (T,), mask (T,), scale (d,) -> (Q,)."""
    t, d = hist.shape
    _check_shapes(queries, hist, ys=(ys, t), mask=(mask, t),
                  scale=(scale, d))
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if queries.device.type == "cpu":
        return knn_predict_ref(queries, hist, ys, mask, scale, k)
    _check_cuda(queries, hist, ys, mask, scale)
    q = queries.shape[0]
    out = torch.empty((q,), dtype=torch.float32, device=queries.device)
    if q == 0:
        return out
    lib = _build.load("knn")
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    with torch.cuda.device(queries.device):
        err = lib.knn_predict_f32(
            queries.data_ptr(), hist.data_ptr(), ys.data_ptr(),
            mask.data_ptr(), scale.data_ptr(), out.data_ptr(), q, t, d, k,
            stream)
    _build.check(lib, err, "knn_predict")
    KERNEL_LAUNCHES["knn_predict"] += 1
    return out


def pairwise_sq_dists(queries, hist, mask):
    """queries (Q,d), hist (T,d), mask (T,) -> (Q,T) squared distances,
    3.4e38 at masked columns."""
    t, d = hist.shape
    _check_shapes(queries, hist, mask=(mask, t))
    if queries.device.type == "cpu":
        return pairwise_sq_dists_ref(queries, hist, mask)
    _check_cuda(queries, hist, mask)
    q = queries.shape[0]
    out = torch.empty((q, t), dtype=torch.float32, device=queries.device)
    if q * t == 0:
        return out
    if q > 65535:
        raise ValueError("pairwise_sq_dists takes at most 65535 queries")
    lib = _build.load("knn")
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    with torch.cuda.device(queries.device):
        err = lib.pairwise_sq_dists_f32(
            queries.data_ptr(), hist.data_ptr(), mask.data_ptr(),
            out.data_ptr(), q, t, d, stream)
    _build.check(lib, err, "pairwise_sq_dists")
    KERNEL_LAUNCHES["pairwise_sq_dists"] += 1
    return out
