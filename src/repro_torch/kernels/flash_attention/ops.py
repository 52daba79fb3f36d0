"""Flash-attention wrapper: checks, output allocation and the launch.

``flash_attention`` takes the model's layout, q (B, S, H, D) and k, v
(B, S, Hkv, D). CPU tensors take the plain version (``ref.py``); CUDA
tensors launch the kernel in ``kernel.cu`` on the current stream, which
reads the tensors as they are (no padding of D or S, no transpose, no
repeated heads) and raises on what it does not take.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import KERNEL_LAUNCHES
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

NAME = "flash_attention"
MAX_HEAD_DIM = 128          # the kernel's register block: D / 16 <= 8
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
        if t.data_ptr() % 16:
            raise ValueError("flash_attention reads its inputs in 16-byte "
                             "chunks: they must be 16-byte aligned")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention takes float32 or bfloat16, not "
                         f"{q.dtype}")
    d = q.shape[3]
    if d % 16 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes D % 16 == 0 and D <= "
                         f"{MAX_HEAD_DIM}, got {d}")
    if q.shape[0] > 65535 or q.shape[2] > 65535:
        raise ValueError("flash_attention takes at most 65535 sequences "
                         "and heads (the grid's y and z)")


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, kv_len: int | None = None):
    """q (B, S, H, D); k, v (B, S, Hkv, D) -> (B, S, H, D) in q's type:
    softmax(q k^T * scale) v over the keys < ``kv_len`` (all by default),
    causal unless asked otherwise; ``scale`` defaults to D ** -0.5."""
    b, s, h, d = q.shape
    kv_len = s if kv_len is None else int(kv_len)
    _check(q, k, v, kv_len)
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     kv_len=kv_len)
    _check_cuda(q, k, v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load(NAME)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, s, h, k.shape[2], d, scale, int(causal),
            kv_len, stream)
    _build.check(lib, err, NAME)
    KERNEL_LAUNCHES[NAME] += 1
    return out
