"""Ensemble-MLP wrappers: checks, output allocation and the launches.

``ensemble_mlp_forward`` computes, for M models x T tasks,
``tanh(x W1 + b1) W2 + b2`` in fp32 (the reference's
``repro.kernels.ensemble_mlp.ops.ensemble_mlp_forward``, the TPU kernel's
own function). ``mlp_predict`` is all of the MLP model's prediction in one
launch: ``((x - mu_x) / sd_x)``, that forward for one model, then ``* sd_y
+ mu_y``, rounded step by step as the eager steps round. CPU tensors take
the plain versions (``ref.py``); CUDA tensors launch the kernels in
``kernel.cu`` on the current stream. Both count under
``KERNEL_LAUNCHES["ensemble_mlp"]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import KERNEL_LAUNCHES
from repro_torch.kernels import _build
from repro_torch.kernels.ensemble_mlp.ref import (ensemble_mlp_ref,
                                                  mlp_predict_ref)

NAME = "ensemble_mlp"
MAX_SMEM_FLOATS = 12 * 1024   # 48 KB of shared memory per block
THREADS = 128                 # a block's rows


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


def _device_index(args) -> int:
    """The CUDA device all of ``args`` lie on; raises unless they are
    contiguous float32 tensors on one CUDA device."""
    if not args[0].is_cuda:
        raise ValueError(f"no ensemble_mlp kernel for device "
                         f"{args[0].device}")
    idx = args[0].get_device()
    for a in args:
        if a.get_device() != idx or a.dtype != torch.float32 \
                or not a.is_contiguous():
            raise ValueError("ensemble_mlp takes contiguous float32 "
                             "tensors on one CUDA device")
    return idx


def ensemble_mlp_forward(x, w1, b1, w2, b2):
    """x (M,T,d), w1 (M,d,h), b1 (M,h), w2 (M,h,1), b2 (M,) or (M,1)
    -> (M,T) fp32 predictions."""
    m, t, d, h = _check(x, w1, b1, w2, b2)
    args = (x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return ensemble_mlp_ref(*args)
    idx = _device_index(args)
    if d * h + 2 * h > MAX_SMEM_FLOATS or m > 65535:
        raise ValueError(f"ensemble_mlp: d*h={d * h}, M={m} exceed the "
                         f"kernel's limits")
    out = torch.empty((m, t), dtype=torch.float32, device=x.device)
    if m * t == 0:
        return out
    lib = _build.load(NAME)
    err = _build.launch(lib.ensemble_mlp_forward_f32, idx, x.data_ptr(),
                        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                        b2.data_ptr(), out.data_ptr(), m, t, d, h)
    _build.check(lib, err, NAME)
    KERNEL_LAUNCHES[NAME] += 1
    return out


def mlp_predict(x, w1, b1, w2, b2, mu_x, sd_x, mu_y, sd_y):
    """One model's prediction: x (T,d), w1 (d,h), b1 (h,), w2 (h,1), b2
    (1,), mu_x and sd_x (d,), mu_y and sd_y one value each -> (T,),
    ``(tanh(((x - mu_x) / sd_x) W1 + b1) W2 + b2) * sd_y + mu_y``."""
    if x.dim() != 2 or w1.dim() != 2:
        raise ValueError("x must be (T,d) and w1 (d,h)")
    t, d = x.shape
    h = w1.shape[1]
    if (w1.shape[0], b1.shape, w2.shape, b2.numel(), mu_x.shape,
            sd_x.shape, mu_y.numel(), sd_y.numel()) != (d, (h,), (h, 1), 1,
                                                         (d,), (d,), 1, 1):
        raise ValueError(
            f"mlp_predict shapes disagree: x {tuple(x.shape)}, w1 "
            f"{tuple(w1.shape)}, b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}"
            f", b2 {tuple(b2.shape)}, mu_x {tuple(mu_x.shape)}, sd_x "
            f"{tuple(sd_x.shape)}, mu_y {tuple(mu_y.shape)}, sd_y "
            f"{tuple(sd_y.shape)}")
    args = (x, w1, b1, w2, b2, mu_x, sd_x, mu_y, sd_y)
    if x.device.type == "cpu":
        return mlp_predict_ref(*args)
    idx = _device_index(args)
    if d * h + 2 * h + (2 + THREADS) * d > MAX_SMEM_FLOATS:
        raise ValueError(f"mlp_predict: d={d}, h={h} exceed the kernel's "
                         f"limits")
    out = torch.empty((t,), dtype=torch.float32, device=x.device)
    if t == 0:
        return out
    lib = _build.load(NAME)
    err = _build.launch(lib.mlp_predict_f32, idx, x.data_ptr(),
                        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                        b2.data_ptr(), mu_x.data_ptr(), sd_x.data_ptr(),
                        mu_y.data_ptr(), sd_y.data_ptr(), out.data_ptr(), t,
                        d, h)
    _build.check(lib, err, NAME)
    KERNEL_LAUNCHES[NAME] += 1
    return out
