"""Gradient compression: int8 stochastic-rounding quantization.

The reference's (``repro/train/compression.py``) on tensors. Quantize each
gradient leaf to int8 with a per-leaf fp32 scale before the all-reduce and
dequantize after: an 8x cut of the data-parallel sync's wire traffic.
Stochastic rounding keeps the quantizer unbiased (E[q] = g).

The rounding draws are JAX's: the key is split per leaf as
``jax.random.split`` does, in JAX's leaf order (dict keys sorted), and each
leaf's uniforms are threefry bits computed where the leaf lies
(``core.prng_device``, bitwise ``jax.random.uniform``), so for equal
gradients the int8 tensors are bitwise the reference's. The draws run in
chunks of counters, so a leaf of any size costs a few chunk-sized
temporaries.

Wired in as the ``grad_transform`` hook of ``make_train_step``;
``compressed_psum`` is the all-reduce variant for data-parallel paths.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.prng_device import threefry2x32
from repro_torch.utils.misc import (tree_flatten_with_path, tree_map,
                                    tree_unflatten)

_M32 = 0xFFFFFFFF
CHUNK = 1 << 22      # counters hashed at once


def _uniform(key: np.ndarray, shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 on [0, 1)) on
    ``device``, hashed CHUNK counters at a time."""
    n = int(np.prod(shape, dtype=np.int64))
    out = torch.empty(n, dtype=torch.float32, device=device)
    for i0 in range(0, n, CHUNK):
        idx = torch.arange(i0, min(n, i0 + CHUNK), dtype=torch.int64,
                           device=device)
        b1, b2 = threefry2x32(key[0], key[1], idx >> 32, idx & _M32)
        bits = b1 ^ b2
        out[i0:i0 + idx.numel()] = ((bits >> 9) | 0x3F800000).to(
            torch.int32).view(torch.float32) - 1.0
    return out.reshape(tuple(shape))


def _quantize_leaf(key, g, scale=None):
    g32 = g.float()
    if scale is None:
        scale = torch.clamp_min(torch.max(torch.abs(g32)), 1e-12) / 127.0
    x = g32 / scale
    lo = torch.floor(x)
    p_up = x - lo
    rnd = _uniform(key, g.shape, g.device)
    # XLA's float -> int8 conversion saturates; so does this
    q = (lo + (rnd < p_up).float()).clamp(-128, 127).to(torch.int8)
    return q, scale


def quantize_int8(grads, key):
    """(int8 tree, fp32 scale tree) of ``grads`` under ``key`` (a
    ``core.prng`` key)."""
    _, leaves = tree_flatten_with_path(grads)
    keys = prng.split(key, len(leaves))
    out = [_quantize_leaf(k, g) for k, g in zip(keys, leaves)]
    qs = tree_unflatten(grads, [q for q, _ in out])
    scales = tree_unflatten(grads, [s for _, s in out])
    return qs, scales


def dequantize_int8(qs, scales, dtype=torch.float32):
    return tree_map(lambda q, s: q.float() * s, qs, scales)


def make_compressor(seed: int = 0):
    """grad_transform hook: quantize -> dequantize round trip (unbiased)."""
    def transform(grads):
        # fold the grad fingerprint into the key so rounding decorrelates
        # across steps without threading a counter through the step fn
        _, leaves = tree_flatten_with_path(grads)
        fingerprint = torch.sum(leaves[0]).float()
        key = prng.fold_in(prng.prng_key(seed),
                           int(fingerprint.to(torch.int32)))
        qs, scales = quantize_int8(grads, key)
        return dequantize_int8(qs, scales)

    return transform


def compressed_psum(grads, axis_name: str, key):
    """int8-on-the-wire sum for data-parallel paths.

    Peers first agree on a per-leaf global scale (a max over the group),
    quantize with that shared scale, sum the int8 payload in int32 (no
    overflow) and dequantize. Until the port has process groups (ROADMAP
    queue 1, item 9) the group is this one device: ``axis_name`` is not
    read, the max and the sum are over the device itself, and the result
    is the quantize/dequantize round trip at the leaf's own scale."""
    _, leaves = tree_flatten_with_path(grads)
    scales = [torch.clamp_min(torch.max(torch.abs(g.float())), 1e-12)
              / 127.0 for g in leaves]
    keys = prng.split(key, len(leaves))
    summed = [_quantize_leaf(k, g, s)[0].to(torch.int32)
              for k, g, s in zip(keys, leaves, scales)]
    return tree_unflatten(grads, [q.float() * s
                                  for q, s in zip(summed, scales)])
