"""Ensemble-MLP wrapper: checks, output allocation and the launch.

``ensemble_mlp_forward`` computes, for M models x T tasks,
``tanh(x W1 + b1) W2 + b2`` in fp32 (the reference's
``repro.kernels.ensemble_mlp.ops.ensemble_mlp_forward``). CPU tensors take
the plain version (``ref.py``); CUDA tensors launch the kernel in
``kernel.cu`` on the current stream.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import KERNEL_LAUNCHES
from repro_torch.kernels import _build
from repro_torch.kernels.ensemble_mlp.ref import ensemble_mlp_ref

NAME = "ensemble_mlp"
MAX_SMEM_FLOATS = 12 * 1024   # 48 KB of shared memory per block


def _check(x, w1, b1, w2, b2):
    if x.dim() != 3 or w1.dim() != 3:
        raise ValueError("x must be (M,T,d) and w1 (M,d,h)")
    m, t, d = x.shape
    h = w1.shape[-1]
    shapes = {"w1": (w1, (m, d, h)), "b1": (b1, (m, h)),
              "w2": (w2, (m, h, 1))}
    for name, (a, want) in shapes.items():
        if tuple(a.shape) != want:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, "
                             f"expected {want}")
    if b2.numel() != m or b2.shape[0] != m:
        raise ValueError(f"b2 must be (M,) or (M,1), got {tuple(b2.shape)}")
    return m, t, d, h


def ensemble_mlp_forward(x, w1, b1, w2, b2):
    """x (M,T,d), w1 (M,d,h), b1 (M,h), w2 (M,h,1), b2 (M,) or (M,1)
    -> (M,T) fp32 predictions."""
    m, t, d, h = _check(x, w1, b1, w2, b2)
    args = (x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return ensemble_mlp_ref(*args)
    if x.device.type != "cuda":
        raise ValueError(f"no ensemble_mlp kernel for device {x.device}")
    for a in args:
        if a.device != x.device or a.dtype != torch.float32 \
                or not a.is_contiguous():
            raise ValueError("ensemble_mlp takes contiguous float32 "
                             "tensors on one CUDA device")
    if d * h + 2 * h > MAX_SMEM_FLOATS or m > 65535:
        raise ValueError(f"ensemble_mlp: d*h={d * h}, M={m} exceed the "
                         f"kernel's limits")
    out = torch.empty((m, t), dtype=torch.float32, device=x.device)
    if m * t == 0:
        return out
    lib = _build.load(NAME)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.ensemble_mlp_forward_f32(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), m, t, d, h, stream)
    _build.check(lib, err, NAME)
    KERNEL_LAUNCHES[NAME] += 1
    return out
