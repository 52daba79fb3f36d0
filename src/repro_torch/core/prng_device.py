"""JAX's threefry draws as tensor code on a device, for bulk draws.

:mod:`repro_torch.core.prng` reproduces ``jax.random`` bit for bit in numpy
on the host, where Sizey's decisions draw a few dozen numbers per fit. The
serving sampler draws Gumbel noise over the whole vocabulary at every
decode step (8 x 32,256 values for zamba2-7b), which on the host takes as
long as the model's decode step; these are the same functions on tensors,
so the draw stays on the card. The arithmetic is the host version's:
32-bit words held in int64 and masked after each add, float32 values
reinterpreted from their bits, and XLA's fused multiply-adds of ``log``
taken in float64 and rounded once (exact, as on the host). Elementwise
tensor operations round as numpy does on every device, so the draws are
bitwise those of :mod:`repro_torch.core.prng` and of ``jax.random``
(tests/test_torch_serve.py on the CPU, tests/test_torch_cuda.py on the
card). Keys stay numpy arrays: a key's split is a single hash on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.prng import _LOG_P, _ROT0, _ROT1

_M32 = 0xFFFFFFFF
F32_TINY = float(np.finfo(np.float32).tiny)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & _M32) | (v >> (32 - r))


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """:func:`repro_torch.core.prng.threefry2x32` on int64 tensors holding
    uint32 words."""
    k1, k2 = int(k1), int(k2)
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in (_ROT0 if i % 2 == 0 else _ROT1):
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + i + 1) & _M32
    return a, b


def random_bits(key: np.ndarray, shape, device) -> torch.Tensor:
    """32 random bits per element (int64), as ``prng.random_bits``."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], idx >> 32, idx & _M32)
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(key: np.ndarray, shape, minval, maxval, device) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on ``[minval, maxval)``."""
    bits = random_bits(key, shape, device)
    fl = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp_min(fl * float(hi - lo) + float(lo), float(lo))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add: exact product and sum in float64, one
    rounding (``prng._fma``)."""
    if isinstance(b, torch.Tensor):
        b = b.double()
    if isinstance(c, torch.Tensor):
        c = c.double()
    return (a.double() * b + c).float()


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """``prng.log_f32`` (XLA's CPU logarithm) for positive float32."""
    p = [float(v) for v in _LOG_P]
    t = torch.clamp_min(x, float(np.float32(1.1754943508222875e-38)))
    bits = t.view(torch.int32)
    e = 1.0 + ((bits >> 23) - 0x7F).to(torch.float32)
    t = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = t < float(np.float32(0.707106781186547524))
    t1 = torch.where(small, t, 0.0)
    t = t - 1.0
    e = e - small.to(torch.float32)
    t = t + t1
    x2 = t * t
    x3 = x2 * t
    y = _fma(t, p[0], p[1])
    y1 = _fma(t, p[3], p[4])
    y2 = _fma(t, p[6], p[7])
    y = _fma(y, t, p[2])
    y1 = _fma(y1, t, p[5])
    y2 = _fma(y2, t, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * float(np.float32(-2.12194440e-4)))
    t = _fma(x2, -0.5, t)
    t = t + y
    t = _fma(e, float(np.float32(0.693359375)), t)
    return torch.where(x == 0.0, float("-inf"), t)


def gumbel(key: np.ndarray, shape, device) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in float32 (mode "low") on
    ``device``: -log(-log(u)), u uniform on [tiny, 1)."""
    u = uniform(key, shape, F32_TINY, 1.0, device)
    return -log_f32(-log_f32(u))
