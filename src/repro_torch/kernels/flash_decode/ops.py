"""Flash-decode wrapper: checks, output allocation and the launch.

``flash_decode`` takes one query token (B, 1, H, D) and one layer's caches
(B, S_max, Hkv, D) in the model's layout, with ``pos`` the last live
position. CPU tensors take the plain version (``ref.py``); CUDA tensors
launch the kernel in ``kernel.cu`` on the current stream. On the card
``pos`` is an int32 tensor on the device, read by the kernel itself, so
the decode step never waits for the host; the caches are read through
their strides (a layer's slice of the stacked cache is not copied). The
kernel splits the positions over a cluster of up to 8 blocks per (KV head,
sequence), each serving all the KV head's query heads; ``split_plan``
fixes the split count and span from the shapes and the SM count, never
from pos.

The launch is a registered torch op (``torch.ops.repro_torch.
flash_decode``): its real implementation is the launch, its fake
implementation allocates the output and counts no launch, so a decode
step traced on fake tensors (``launch.dryrun``) goes through K5 without a
card; its FLOP formula counts ``analysis.kernel_costs``' products over
every cache position (a formula sees shapes, not ``pos``: a dry run's
decode step reads a full cache).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.analysis import kernel_costs
from repro_torch.kernels import KERNEL_LAUNCHES
from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode.ref import flash_decode_plain

NAME = "flash_decode"
MAX_HEAD_DIM = 128          # the kernel's kMaxD
MAX_GROUP = 8               # query heads per KV head a lane keeps (kMaxG)
TILE = 64                   # cache positions per tile
MAX_SPLITS = 8              # blocks per cluster (the portable cluster size)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _check_cuda(q, k_cache, v_cache, pos):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"no flash_decode kernel for device {dev}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_decode takes float32 or bfloat16, not "
                         f"{q.dtype}")
    if not q.is_contiguous():
        raise ValueError("flash_decode takes a contiguous query")
    per16 = 16 // q.element_size()      # values per 16-byte load
    for c in (k_cache, v_cache):
        if c.device != dev or c.dtype != q.dtype or c.stride(3) != 1:
            raise ValueError("flash_decode takes caches of the query's type "
                             "on its device with unit stride over D")
        if any(st % per16 for st in c.stride()[:3]):
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


def _launch(q, k_cache, v_cache, pos, scale):
    """K5 on the card."""
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("flash_decode reads the caches in 16-byte chunks: "
                         "rows must be 16-byte aligned")
    b, _, h, d = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    splits, span = split_plan(k_cache.shape[1], b * k_cache.shape[2],
                              _sm_count(q.device.index))
    lib = _build.load(NAME)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_decode_fwd(
            DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), pos.data_ptr(), out.data_ptr(), b, h,
            k_cache.shape[2], d, k_cache.shape[1], *k_cache.stride()[:3],
            *v_cache.stride()[:3], scale, splits, span, stream)
    _build.check(lib, err, NAME)
    KERNEL_LAUNCHES[NAME] += 1
    return out


# a CUDA kernel and a fake kernel through ``torch.library.Library`` (its
# Python dispatch costs less host time a call than ``custom_op``'s: see
# ``kernels/flash_attention/ops.py``)
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_decode(Tensor q, Tensor k_cache, Tensor v_cache, "
            "Tensor pos, float scale) -> Tensor")
_LIB.impl("flash_decode", _launch, "CUDA")


@torch.library.register_fake("repro_torch::flash_decode")
def _(q, k_cache, v_cache, pos, scale):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_decode)
def _flops(q_shape, k_shape, v_shape, pos_shape, scale, *, out_shape=None,
           **kw):
    b, _, h, d = q_shape
    return kernel_costs.k5_work(b, h, k_shape[2], d, k_shape[1], 2)[1]


def flash_decode(q, k_cache, v_cache, pos, *, scale: float | None = None):
    """q (B, 1, H, D); caches (B, S_max, Hkv, D); pos the last live cache
    position -> (B, 1, H, D) in q's type: attention of the token over the
    positions 0..pos. ``scale`` defaults to D ** -0.5."""
    _check(q, k_cache, v_cache)
    b, _, h, d = q.shape
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, pos, scale=scale)
    _check_cuda(q, k_cache, v_cache, pos)
    return torch.ops.repro_torch.flash_decode(q, k_cache, v_cache, pos, scale)
