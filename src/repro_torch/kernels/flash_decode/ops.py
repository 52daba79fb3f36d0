"""Flash-decode wrappers: checks, output allocation and the launch.

``flash_decode`` takes one query token (B, 1, H, D) and one layer's caches
(B, S_max, Hkv, D) in the model's layout, with ``pos`` the last live
position. ``flash_decode_lse`` takes one rank's slice of a cache sharded
over the sequence (the positions ``offset..offset + S_loc - 1``) and
returns the fp32 output and each row's log-sum-exp, for the cross-rank
merge of tensor-parallel decode (``ref.merge_partials``). CPU tensors take
the plain versions (``ref.py``); CUDA tensors launch the kernel in
``kernel.cu`` on the current stream. On the card ``pos`` is an int32
tensor on the device, read by the kernel itself, so the decode step never
waits for the host; the caches are read through their strides (a layer's
slice of the stacked cache is not copied). The caches are of the query's
type or e4m3 (``torch.float8_e4m3fn``), widened in registers; the
softmax's numerator is rounded to ``p_dtype`` before P.V: v's type by
default (the TPU kernel's function), the query's type where the model
calls it (the reference model's). The kernel splits the positions over a
cluster of up to 8 blocks per (KV head, sequence), each serving all the
KV head's query heads; ``split_plan`` fixes the split count and span from
the shapes and the SM count, never from pos.

The launches are registered torch ops (``torch.ops.repro_torch.
flash_decode`` and ``flash_decode_lse``): the real implementation is the
launch, the fake implementation allocates the outputs and counts no
launch, so a decode step traced on fake tensors (``launch.dryrun``) goes
through K5 without a card; the FLOP formulas count
``analysis.kernel_costs``' products over every cache position (a formula
sees shapes, not ``pos``: a dry run's decode step reads a full cache).
Launches are counted as ``flash_decode`` (a cache of the query's type),
``flash_decode_fp8`` (an e4m3 cache) and ``flash_decode_lse``.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.analysis import kernel_costs
from repro_torch.kernels import KERNEL_LAUNCHES
from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode.ref import (flash_decode_lse_plain,
                                                  flash_decode_plain)

NAME = "flash_decode"
MAX_HEAD_DIM = 128          # the kernel's kMaxD
MAX_GROUP = 8               # query heads per KV head a lane keeps (kMaxG)
TILE = 64                   # cache positions per tile
MAX_SPLITS = 8              # blocks per cluster (the portable cluster size)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}                  # q and out
FP8 = torch.float8_e4m3fn
CACHE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, FP8: 2}
P_DTYPES = CACHE_DTYPES     # what P is rounded to before P.V


def _check(q, k_cache, v_cache):
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 \
            or k_cache.shape != v_cache.shape:
        raise ValueError("flash_decode takes q (B,1,H,D) and caches "
                         "(B,S_max,Hkv,D)")
    b, _, h, d = q.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"cache shape {tuple(k_cache.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if h % k_cache.shape[2] != 0:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k_cache.shape[2]} kv heads")
    if k_cache.dtype != v_cache.dtype:
        raise ValueError("flash_decode takes K and V caches of one type")


def _check_cuda(q, k_cache, v_cache, pos, p_dtype):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"no flash_decode kernel for device {dev}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_decode takes float32 or bfloat16, not "
                         f"{q.dtype}")
    if k_cache.dtype not in (q.dtype, FP8):
        raise ValueError(f"flash_decode takes caches of the query's type "
                         f"or {FP8}, not {k_cache.dtype}")
    if p_dtype not in P_DTYPES:
        raise ValueError(f"flash_decode rounds P to float32, bfloat16 or "
                         f"{FP8}, not {p_dtype}")
    if not q.is_contiguous():
        raise ValueError("flash_decode takes a contiguous query")
    size = k_cache.element_size()
    for c in (k_cache, v_cache):
        if c.device != dev or c.stride(3) != 1:
            raise ValueError("flash_decode takes caches on the query's "
                             "device with unit stride over D")
        # alignment in the cache's own element size
        if any(st * size % 16 for st in c.stride()[:3]) \
                or q.shape[3] * size % 16:
            raise ValueError("flash_decode reads the caches in 16-byte "
                             "chunks: rows must be 16-byte aligned")
    if not (isinstance(pos, torch.Tensor) and pos.device == dev
            and pos.dtype == torch.int32 and pos.numel() == 1):
        raise ValueError("on the card pos must be one int32 on the query's "
                         "device")
    if q.shape[3] > MAX_HEAD_DIM or q.shape[3] % 8:
        raise ValueError(f"flash_decode takes D % 8 == 0 and D <= "
                         f"{MAX_HEAD_DIM}, got {q.shape[3]}")
    if q.shape[2] // k_cache.shape[2] > MAX_GROUP:
        raise ValueError(f"flash_decode takes at most {MAX_GROUP} query "
                         f"heads per kv head, got "
                         f"{q.shape[2] // k_cache.shape[2]}")
    if q.shape[0] > 65535 or k_cache.shape[2] > 65535:
        raise ValueError("flash_decode takes at most 65535 sequences and "
                         "kv heads (the grid's z and y)")


def split_plan(s_max: int, groups: int, n_sm: int) -> tuple[int, int]:
    """(splits, span) for ``groups`` = B * Hkv clusters on a card of
    ``n_sm`` SMs: about two blocks per SM in all, at most MAX_SPLITS a
    cluster and no more than S_max has tiles; each block takes ``span``
    positions (a multiple of TILE), together covering S_max with none
    wholly past it. Fixed by the shapes alone, so pos stays on the device;
    a split that starts past pos loads nothing."""
    if s_max < 1 or groups < 1 or n_sm < 1:
        raise ValueError(f"flash_decode takes S_max, B * Hkv and the SM "
                         f"count >= 1, got {s_max}, {groups}, {n_sm}")
    tiles = -(-s_max // TILE)
    want = min(MAX_SPLITS, tiles, max(1, -(-2 * n_sm // groups)))
    span = -(-tiles // want) * TILE
    return -(-s_max // span), span


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_any(q, k_cache, v_cache, pos, scale, offset, p_dtype, lse):
    """K5 on the card: the output in q's type, or with ``lse`` the fp32
    output and the (B, 1, H) fp32 log-sum-exps of the slice at
    ``offset``."""
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("flash_decode reads the caches in 16-byte chunks: "
                         "rows must be 16-byte aligned")
    b, _, h, d = q.shape
    out = torch.empty_like(q, dtype=torch.float32 if lse else q.dtype)
    lse_out = torch.empty((b, 1, h), dtype=torch.float32, device=q.device) \
        if lse else None
    if out.numel() == 0:
        return (out, lse_out) if lse else out
    splits, span = split_plan(k_cache.shape[1], b * k_cache.shape[2],
                              _sm_count(q.device.index))
    lib = _build.load(NAME)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_decode_fwd(
            DTYPES[q.dtype], CACHE_DTYPES[k_cache.dtype], P_DTYPES[p_dtype],
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), out.data_ptr(),
            0 if lse_out is None else lse_out.data_ptr(), b, h,
            k_cache.shape[2], d, k_cache.shape[1], *k_cache.stride()[:3],
            *v_cache.stride()[:3], scale, offset, splits, span, stream)
    _build.check(lib, err, NAME)
    KERNEL_LAUNCHES["flash_decode_lse" if lse else "flash_decode_fp8"
                    if k_cache.dtype == FP8 else NAME] += 1
    return (out, lse_out) if lse else out


def _launch(q, k_cache, v_cache, pos, scale, p_dtype=None):
    return _launch_any(q, k_cache, v_cache, pos, scale, 0,
                       v_cache.dtype if p_dtype is None else p_dtype, False)


def _launch_lse(q, k_cache, v_cache, pos, scale, offset, p_dtype=None):
    return _launch_any(q, k_cache, v_cache, pos, scale, offset,
                       v_cache.dtype if p_dtype is None else p_dtype, True)


# a CUDA kernel and a fake kernel through ``torch.library.Library`` (its
# Python dispatch costs less host time a call than ``custom_op``'s: see
# ``kernels/flash_attention/ops.py``)
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_decode(Tensor q, Tensor k_cache, Tensor v_cache, "
            "Tensor pos, float scale, ScalarType? p_dtype=None) -> Tensor")
_LIB.define("flash_decode_lse(Tensor q, Tensor k_cache, Tensor v_cache, "
            "Tensor pos, float scale, int offset, ScalarType? p_dtype=None)"
            " -> (Tensor, Tensor)")
_LIB.impl("flash_decode", _launch, "CUDA")
_LIB.impl("flash_decode_lse", _launch_lse, "CUDA")


@torch.library.register_fake("repro_torch::flash_decode")
def _(q, k_cache, v_cache, pos, scale, p_dtype=None):
    return torch.empty_like(q)


@torch.library.register_fake("repro_torch::flash_decode_lse")
def _(q, k_cache, v_cache, pos, scale, offset, p_dtype=None):
    b, _, h, _ = q.shape
    return (torch.empty_like(q, dtype=torch.float32),
            q.new_empty((b, 1, h), dtype=torch.float32))


def _flops(q_shape, k_shape, *args, **kw):
    b, _, h, d = q_shape
    return kernel_costs.k5_work(b, h, k_shape[2], d, k_shape[1], 2)[1]


register_flop_formula(torch.ops.repro_torch.flash_decode)(_flops)
register_flop_formula(torch.ops.repro_torch.flash_decode_lse)(_flops)


def flash_decode(q, k_cache, v_cache, pos, *, scale: float | None = None,
                 p_dtype=None):
    """q (B, 1, H, D); caches (B, S_max, Hkv, D); pos the last live cache
    position -> (B, 1, H, D) in q's type: attention of the token over the
    positions 0..pos. ``scale`` defaults to D ** -0.5, ``p_dtype`` to v's
    type."""
    _check(q, k_cache, v_cache)
    scale = q.shape[3] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, pos, scale=scale,
                                  p_dtype=p_dtype)
    p_dtype = v_cache.dtype if p_dtype is None else p_dtype
    _check_cuda(q, k_cache, v_cache, pos, p_dtype)
    return torch.ops.repro_torch.flash_decode(q, k_cache, v_cache, pos, scale,
                                              p_dtype)


def flash_decode_lse(q, k_cache, v_cache, pos, *, offset: int = 0,
                     scale: float | None = None, p_dtype=None):
    """q (B, 1, H, D); one slice of the caches (B, S_loc, Hkv, D), the
    positions ``offset..offset + S_loc - 1``; pos the last live position
    of the whole cache -> (o (B, 1, H, D) fp32, lse (B, 1, H) fp32): the
    slice's attention, normalised and not rounded, and its log-sum-exp
    (o = 0, lse = -inf where the slice holds no live position)."""
    _check(q, k_cache, v_cache)
    scale = q.shape[3] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_decode_lse_plain(q, k_cache, v_cache, pos,
                                      offset=offset, scale=scale,
                                      p_dtype=p_dtype)
    p_dtype = v_cache.dtype if p_dtype is None else p_dtype
    _check_cuda(q, k_cache, v_cache, pos, p_dtype)
    return torch.ops.repro_torch.flash_decode_lse(q, k_cache, v_cache, pos,
                                                  scale, int(offset), p_dtype)
