"""Segment-DP wrappers: checks, output and scratch allocation, the launches.

``fit_cuts`` is what the temporal path's boundary fit computes: the k cut
columns minimising the total over-reservation of a pool's (M, G) profile
history (the reference's ``repro.kernels.segment_dp.ops.fit_cuts``, whose
jitted path is bitwise ``ref.fit_cuts_ref``). ``segment_cost`` is the
reference TPU kernel's own function, the (G+1, G+1) cost matrix with
``inf`` where ``j <= i``. CPU tensors take the plain versions (``ref.py``);
CUDA tensors launch the kernels in ``kernel.cu`` on the current stream.
The reference pads M to a power of two only to bound its compiles; zero
rows cost exactly 0.0, so the kernel runs on the real M.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import KERNEL_LAUNCHES
from repro_torch.kernels import _build
from repro_torch.kernels.segment_dp.ref import (cost_matrix_plain,
                                                fit_cuts_plain)

NAME = "segment_dp"
MAX_GRID = 1024     # the DP's two rows of G + 1 floats in shared memory


def _check(P, k: int | None = None):
    if P.dim() != 2:
        raise ValueError(f"profiles must be (M, G), got {tuple(P.shape)}")
    m, g = P.shape
    if not 1 <= g <= MAX_GRID:
        raise ValueError(f"segment_dp takes 1 <= G <= {MAX_GRID}, got {g}")
    if m * g >= 2**31:
        raise ValueError(f"segment_dp: M*G={m * g} exceeds int32 indexing")
    if k is not None and not 1 <= k <= g:
        raise ValueError(f"k must be in [1, G={g}], got {k}")
    if P.device.type == "cpu":
        return m, g
    if P.device.type != "cuda":
        raise ValueError(f"no segment_dp kernel for device {P.device}")
    if P.dtype != torch.float32 or not P.is_contiguous():
        raise ValueError("segment_dp takes a contiguous float32 tensor")
    return m, g


def fit_cuts(P: torch.Tensor, k: int) -> torch.Tensor:
    """(M, G) float32 profiles -> the (k,) int64 cut columns (segment
    ends, the last == G) on ``P``'s device. ``k`` must be in [1, G]."""
    k = int(k)
    m, g = _check(P, k)
    if P.device.type == "cpu":
        return fit_cuts_plain(P.to(torch.float32), k)
    dev = P.device
    cost = torch.empty((g + 1, g + 1), dtype=torch.float32, device=dev)
    back = torch.empty((k, g + 1), dtype=torch.int32, device=dev)
    cuts = torch.empty((k,), dtype=torch.int64, device=dev)
    lib = _build.load(NAME)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.segment_dp_fit_f32(P.data_ptr(), cost.data_ptr(),
                                     back.data_ptr(), cuts.data_ptr(), m, g,
                                     k, stream)
    _build.check(lib, err, "segment_dp_fit")
    KERNEL_LAUNCHES[NAME] += 1
    return cuts


def segment_cost(P: torch.Tensor) -> torch.Tensor:
    """(M, G) float32 profiles -> (G+1, G+1) float32 over-reservation
    cost, ``inf`` where ``j <= i``, on ``P``'s device."""
    m, g = _check(P)
    if P.device.type == "cpu":
        return cost_matrix_plain(P.to(torch.float32))
    dev = P.device
    cost = torch.empty((g + 1, g + 1), dtype=torch.float32, device=dev)
    lib = _build.load(NAME)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.segment_cost_f32(P.data_ptr(), cost.data_ptr(), m, g,
                                   stream)
    _build.check(lib, err, "segment_cost")
    KERNEL_LAUNCHES["segment_cost"] += 1
    return cost
