"""Flash-attention wrapper: checks, tensor maps, output allocation and the
launch.

``flash_attention`` takes the model's layout, q (B, S, H, D) and k, v
(B, S, Hkv, D). CPU tensors take the plain version (``ref.py``); CUDA
tensors launch the kernel in ``kernel.cu`` on the current stream, which
reads the tensors as they are (no padding of D or S, no transpose, no
repeated heads) and raises on what it does not take. The bf16 kernel reads
its inputs through TMA: each tensor is described to the card as 4-D,
(D, heads, S, B) innermost first, and loaded in boxes of 64 values of one
head over 128 positions (``tensor_map_plan``); the
descriptors are cached by pointer, shape and strides, so a repeated call
encodes none.

Training: when grad mode is on and q, k or v requires a gradient, the call
goes through ``FlashAttention`` (a ``torch.autograd.Function``). On the
card its forward launches K4's variant that also writes each row's
log-sum-exp, and its backward the two backward kernels of ``kernel.cu``
(dQ with Delta = rowsum(dO * O), then dK and dV; bf16 on the tensor cores
with dS rounded to bf16, ``ref.flash_attention_backward_rounded``, fp32
in fp32 FMA); without a gradient the
launch is the serving one, unchanged. On the CPU the plain version's own
autograd runs. ``KERNEL_LAUNCHES`` counts the four launches apart:
``flash_attention`` (no gradient), ``flash_attention_lse``,
``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkdv``.

Each launch is a registered torch op (``torch.ops.repro_torch.
flash_attention``, ``flash_attention_lse`` and ``flash_attention_bwd``):
its real implementation is the launch, its fake implementation allocates
the launch's outputs and scratch with their shapes and types and counts
no launch, so a step traced on fake tensors (``launch.dryrun``) goes
through K4 without a card, and its FLOP formula counts
``analysis.kernel_costs``' products.
"""
from __future__ import annotations

import collections
import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.analysis import kernel_costs
from repro_torch.kernels import KERNEL_LAUNCHES
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

NAME = "flash_attention"
MAX_HEAD_DIM = 128          # two 64-column boxes (bf16), D / 16 <= 8 (fp32)
TILE = 128                  # bf16: query rows per block
KEYS = 128                  # bf16: keys per K or V tile
ATOM = 64                   # bf16 values in one 128-byte swizzled box row
MAP_BYTES = 128             # sizeof(CUtensorMap)
MAX_MAPS = 64               # tensor maps kept
_MAPS: collections.OrderedDict = collections.OrderedDict()


def _check(q, k, v, kv_len):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention takes q (B,S,H,D) and k, v "
                         "(B,S,Hkv,D)")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if h % k.shape[2] != 0:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if not 1 <= kv_len <= s:
        raise ValueError(f"kv_len must be in [1, {s}], got {kv_len}")


def _check_cuda(q, k, v):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {dev}")
    for t in (q, k, v):
        if t.device != dev or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError("flash_attention takes contiguous tensors of "
                             "one type on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention takes float32 or bfloat16, not "
                         f"{q.dtype}")
    d = q.shape[3]
    if d % 16 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes D % 16 == 0 and D <= "
                         f"{MAX_HEAD_DIM}, got {d}")
    if q.shape[0] > 65535 or q.shape[2] > 65535:
        raise ValueError("flash_attention takes at most 65535 sequences "
                         "and heads (the grid's y and z)")


def tensor_map_plan(t: torch.Tensor, rows: int = TILE):
    """The TMA view of a bf16 (B, S, heads, D) tensor with unit stride over
    D: its dims innermost first (D, heads, S, B), the byte strides of
    heads, S and B, and the box (ATOM, 1, rows, 1) that one load fills.
    TMA takes byte strides that are multiples of 16 below 2**40 and a
    16-byte aligned base; zeros fill the box past D and past S."""
    if t.dim() != 4 or t.stride(3) != 1:
        raise ValueError("a tensor map takes a 4-D tensor with unit stride "
                         "over its last dimension")
    b, s, h, d = t.shape
    es = t.element_size()
    strides = tuple(es * t.stride(i) for i in (2, 1, 0))
    if any(st % 16 or st >= 2 ** 40 for st in strides):
        raise ValueError(f"TMA takes byte strides that are multiples of 16 "
                         f"below 2**40, got {strides}")
    if t.data_ptr() % 16:
        raise ValueError("TMA takes a 16-byte aligned tensor")
    if not 1 <= rows <= 256:
        raise ValueError(f"a TMA box has 1..256 rows, got {rows}")
    return (d, h, s, b), strides, (ATOM, 1, rows, 1)


def _tensor_map(lib, t: torch.Tensor, rows: int) -> int:
    """The address of ``t``'s cached tensor map, encoded on first use."""
    dims, strides, box = tensor_map_plan(t, rows)
    key = (t.device.index, t.data_ptr(), dims, strides, box)
    buf = _MAPS.get(key)
    if buf is None:
        buf = (ctypes.c_ubyte * MAP_BYTES)()
        err = lib.flash_attention_tensor_map(
            ctypes.addressof(buf), t.data_ptr(),
            (ctypes.c_longlong * 4)(*dims), (ctypes.c_longlong * 3)(*strides),
            (ctypes.c_int * 4)(*box))
        _build.check(lib, err, f"{NAME} tensor map")
        _MAPS[key] = buf
        if len(_MAPS) > MAX_MAPS:
            _MAPS.popitem(last=False)
    else:
        _MAPS.move_to_end(key)
    return ctypes.addressof(buf)


def _check_aligned(*ts):
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("flash_attention reads its inputs in 16-byte "
                         "chunks: they must be 16-byte aligned")


def _launch_forward(q, k, v, causal, scale, kv_len, lse=None):
    """K4 on the card: out, and with ``lse`` (B, H, S) fp32 also each
    row's log-sum-exp (the training variant)."""
    _check_aligned(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load(NAME)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (b, s, h, k.shape[2], d, scale, int(causal), kv_len, stream)
    with torch.cuda.device(q.device):
        if q.dtype == torch.bfloat16:
            maps = (_tensor_map(lib, q, TILE), _tensor_map(lib, k, KEYS),
                    _tensor_map(lib, v, KEYS))
            if lse is None:
                err = lib.flash_attention_bf16(*maps, out.data_ptr(), *args)
            else:
                err = lib.flash_attention_lse_bf16(
                    *maps, out.data_ptr(), lse.data_ptr(), *args)
        else:
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
            if lse is None:
                err = lib.flash_attention_f32(*ptrs, *args)
            else:
                err = lib.flash_attention_lse_f32(*ptrs, lse.data_ptr(),
                                                  *args)
    name = NAME if lse is None else f"{NAME}_lse"
    _build.check(lib, err, name)
    KERNEL_LAUNCHES[name] += 1
    return out


def _launch_backward(q, k, v, o, dout, lse, causal, scale, kv_len):
    """K4's backward on the card: (dq, dk, dv) in the inputs' type. Two
    CUDA launches, dQ (with Delta) then dK and dV, each counted once in
    ``KERNEL_LAUNCHES`` under its own name; bf16 runs on the tensor cores,
    fp32 on the CUDA cores."""
    if dout.data_ptr() % 16:
        dout = dout.clone()
    b, s, h, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _build.load(NAME)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    dtype = 0 if q.dtype == torch.float32 else 1
    args = (b, s, h, k.shape[2], d, scale, int(causal), kv_len, stream)
    qkv = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_dq(
            dtype, *qkv, o.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), *args)
        _build.check(lib, err, f"{NAME}_bwd_dq")
        KERNEL_LAUNCHES[f"{NAME}_bwd_dq"] += 1
        err = lib.flash_attention_bwd_dkdv(
            dtype, *qkv, dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), *args)
    _build.check(lib, err, f"{NAME}_bwd_dkdv")
    KERNEL_LAUNCHES[f"{NAME}_bwd_dkdv"] += 1
    return dq, dk, dv


# ------------------------------------------------------- registered ops
# Defined through ``torch.library.Library`` with a CUDA kernel (the launch)
# and a fake kernel. Through ``torch.library.custom_op``'s Python dispatch
# a zamba2-7b decode step (27 calls of K5) took 78.0-86.8 ms on an H100's
# host, against 60.1-66.3 ms for the bare launches in the same run.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_ARGS = "bool causal, float scale, int kv_len"
_LIB.define(f"flash_attention(Tensor q, Tensor k, Tensor v, {_ARGS}) "
            f"-> Tensor")
_LIB.define(f"flash_attention_lse(Tensor q, Tensor k, Tensor v, {_ARGS}) "
            f"-> (Tensor, Tensor)")
_LIB.define(f"flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor o, "
            f"Tensor dout, Tensor lse, {_ARGS}) -> (Tensor, Tensor, Tensor)")


def _lse_launch(q, k, v, causal, scale, kv_len):
    b, s, h, _ = q.shape
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    return _launch_forward(q, k, v, causal, scale, kv_len, lse), lse


_LIB.impl("flash_attention", _launch_forward, "CUDA")
_LIB.impl("flash_attention_lse", _lse_launch, "CUDA")
_LIB.impl("flash_attention_bwd", _launch_backward, "CUDA")


@torch.library.register_fake("repro_torch::flash_attention")
def _(q, k, v, causal, scale, kv_len):
    return torch.empty_like(q)


@torch.library.register_fake("repro_torch::flash_attention_lse")
def _(q, k, v, causal, scale, kv_len):
    b, s, h, _ = q.shape
    return torch.empty_like(q), torch.empty((b, h, s), dtype=torch.float32,
                                            device=q.device)


@torch.library.register_fake("repro_torch::flash_attention_bwd")
def _(q, k, v, o, dout, lse, causal, scale, kv_len):
    b, s, h, _ = q.shape
    grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, s), dtype=torch.float32,  # noqa: F841
                        device=q.device)
    return grads


def _pairs_flops(work, q_shape, k_shape, causal, kv_len):
    b, s, h, d = q_shape
    return work(b, s, h, k_shape[2], d, 2, causal, kv_len)[1]


@register_flop_formula([torch.ops.repro_torch.flash_attention,
                        torch.ops.repro_torch.flash_attention_lse])
def _forward_flops(q_shape, k_shape, v_shape, causal, scale, kv_len, *,
                   out_shape=None, **kw):
    return _pairs_flops(kernel_costs.k4_work, q_shape, k_shape, causal,
                        kv_len)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _backward_flops(q_shape, k_shape, v_shape, o_shape, dout_shape,
                    lse_shape, causal, scale, kv_len, *, out_shape=None,
                    **kw):
    return _pairs_flops(kernel_costs.k4_bwd_work, q_shape, k_shape, causal,
                        kv_len)


class FlashAttention(torch.autograd.Function):
    """K4 with its hand-written backward, on CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kv_len):
        out, lse = torch.ops.repro_torch.flash_attention_lse(
            q, k, v, causal, scale, kv_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, kv_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
            q, k, v, out, dout, lse, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, kv_len: int | None = None):
    """q (B, S, H, D); k, v (B, S, Hkv, D) -> (B, S, H, D) in q's type:
    softmax(q k^T * scale) v over the keys < ``kv_len`` (all by default),
    causal unless asked otherwise; ``scale`` defaults to D ** -0.5.
    Differentiable in q, k and v (see the module's docstring)."""
    b, s, h, d = q.shape
    kv_len = s if kv_len is None else int(kv_len)
    _check(q, k, v, kv_len)
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     kv_len=kv_len)
    _check_cuda(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale, kv_len)
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, scale,
                                                kv_len)

