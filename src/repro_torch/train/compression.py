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
``compressed_psum`` is the all-reduce variant for data-parallel paths, over
a process group (a mesh axis under ``distributed.sharding.axis_rules``).
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


def _scale(g32):
    """max(|g|, 1e-12) / 127 as a true fp32 division on every device: on a
    CUDA device a division by a Python number multiplies by its reciprocal
    instead, which can differ by one ulp from the CPU's and JAX's
    quotient."""
    top = torch.clamp_min(torch.max(torch.abs(g32)), 1e-12)
    return top / torch.tensor(127.0, dtype=torch.float32, device=top.device)


def _quantize_leaf(key, g, scale=None):
    g32 = g.float()
    if scale is None:
        scale = _scale(g32)
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


def _group(axis_name: str):
    """The process group of the axis ``axis_name`` of the mesh that
    ``distributed.sharding.axis_rules`` activated; with no mesh active,
    None: a group of this one process."""
    from repro_torch.distributed.sharding import _current_mesh, axis_names
    mesh = _current_mesh()
    if mesh is None:
        return None
    if axis_name not in axis_names(mesh):
        raise ValueError(f"compressed_psum: the mesh has no axis "
                         f"{axis_name!r} (axes {axis_names(mesh)})")
    return mesh.get_group(axis_name)


def compressed_psum(grads, axis_name: str, key):
    """int8-on-the-wire sum over the group ``axis_name`` names (see
    ``_group``), for data-parallel paths.

    Peers first agree on a per-leaf global scale (one all-reduce of the
    leaves' fp32 scales by max: negligible traffic), quantize with that
    shared scale, all-reduce the int8 payload as int32 (no overflow) and
    dequantize. Every peer passes the same ``key``, as the reference's
    shard_map does. With a group of one, the quantize/dequantize round
    trip at each leaf's own scale."""
    import torch.distributed as dist
    group = _group(axis_name)
    _, leaves = tree_flatten_with_path(grads)
    scales = [_scale(g.float()) for g in leaves]
    if group is not None and leaves:
        shared = torch.stack(scales)
        dist.all_reduce(shared, op=dist.ReduceOp.MAX, group=group)
        scales = list(shared.unbind(0))
    keys = prng.split(key, len(leaves))
    summed = [_quantize_leaf(k, g, s)[0].to(torch.int32)
              for k, g, s in zip(keys, leaves, scales)]
    if group is not None:
        for q in summed:
            dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return tree_unflatten(grads, [q.float() * s
                                  for q, s in zip(summed, scales)])
