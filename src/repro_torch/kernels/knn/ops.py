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
MAX_FEATURES = 32   # the block's queries and scale in shared memory
WARPS = 8           # a block's warps, shared by 8 / splits queries
SPLITS = (1, 2, 4, 8)


def plan_splits(q: int, t: int) -> int:
    """Warps a query. Below 256 rows one warp scans them fastest (a second
    merge costs more than it saves); from 256 rows up, the most warps that
    keep the grid at or under 1,024 warps (Q x warps), which spreads small
    Q over the card and leaves large Q one warp each (chip_smoke.py's
    phase 7 prints the device time at each)."""
    if t < 256:
        return 1
    s = WARPS
    while s > 1 and q * s > 1024:
        s //= 2
    return s


def _check(queries, hist, vectors):
    if queries.dim() != 2 or hist.dim() != 2 \
            or queries.shape[1] != hist.shape[1]:
        raise ValueError("queries must be (Q,d) and hist (T,d)")
    for name, a, n in vectors:
        if a.shape != (n,):
            raise ValueError(f"{name} has shape {tuple(a.shape)}, "
                             f"expected ({n},)")
    if queries.shape[1] > MAX_FEATURES:
        raise ValueError(f"knn kernel takes at most {MAX_FEATURES} features")


def _device_index(args) -> int:
    """The CUDA device all of ``args`` lie on; raises unless they are
    contiguous float32 tensors on one CUDA device."""
    if not args[0].is_cuda:
        raise ValueError(f"no knn kernel for device {args[0].device}")
    idx = args[0].get_device()
    for a in args:
        if a.get_device() != idx or a.dtype != torch.float32 \
                or not a.is_contiguous():
            raise ValueError("knn takes contiguous float32 tensors on one "
                             "CUDA device")
    return idx


def knn_predict(queries, hist, ys, mask, scale, k: int = 5, *,
                splits: int | None = None):
    """queries (Q,d), hist (T,d), ys (T,), mask (T,), scale (d,) -> (Q,).
    ``splits`` (warps a query, in ``SPLITS``) overrides the kernel's plan
    (:func:`plan_splits`)."""
    t = hist.shape[0]
    _check(queries, hist, (("ys", ys, t), ("mask", mask, t),
                           ("scale", scale, hist.shape[1])))
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if queries.device.type == "cpu":
        return knn_predict_ref(queries, hist, ys, mask, scale, k)
    idx = _device_index((queries, hist, ys, mask, scale))
    q, d = queries.shape
    s = plan_splits(q, t) if splits is None else splits
    if s not in SPLITS:
        raise ValueError(f"splits must be one of {SPLITS}, got {s}")
    out = torch.empty((q,), dtype=torch.float32, device=queries.device)
    if q == 0:
        return out
    lib = _build.load("knn")
    err = _build.launch(lib.knn_predict_f32, idx, queries.data_ptr(),
                        hist.data_ptr(), ys.data_ptr(), mask.data_ptr(),
                        scale.data_ptr(), out.data_ptr(), q, t, d, k, s)
    _build.check(lib, err, "knn_predict")
    KERNEL_LAUNCHES["knn_predict"] += 1
    return out


def pairwise_sq_dists(queries, hist, mask):
    """queries (Q,d), hist (T,d), mask (T,) -> (Q,T) squared distances,
    3.4e38 at masked columns."""
    t = hist.shape[0]
    _check(queries, hist, (("mask", mask, t),))
    if queries.device.type == "cpu":
        return pairwise_sq_dists_ref(queries, hist, mask)
    idx = _device_index((queries, hist, mask))
    q, d = queries.shape
    out = torch.empty((q, t), dtype=torch.float32, device=queries.device)
    if q * t == 0:
        return out
    if q > 65535:
        raise ValueError("pairwise_sq_dists takes at most 65535 queries")
    lib = _build.load("knn")
    err = _build.launch(lib.pairwise_sq_dists_f32, idx, queries.data_ptr(),
                        hist.data_ptr(), mask.data_ptr(), out.data_ptr(), q,
                        t, d)
    _build.check(lib, err, "pairwise_sq_dists")
    KERNEL_LAUNCHES["pairwise_sq_dists"] += 1
    return out
