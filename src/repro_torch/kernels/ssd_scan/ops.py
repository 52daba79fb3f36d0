"""SSD-scan wrapper: checks, output allocation and the launch.

``ssd_scan`` takes the model's layout: x (B, S, H, P) and B, C (B, S, N)
as the convolution gives them (slices with unit stride over the last
dimension), dt (B, S, H) already softplused and a = -exp(a_log). It
returns y and the final state. CPU tensors take the plain chunked version
(``ref.py``); CUDA tensors launch the kernel in ``kernel.cu`` on the
current stream, which reads the slices through their strides: in fp32 the
CUDA-core kernel, in bf16 the tensor-core kernel.

Training: when grad mode is on and an input requires a gradient, a CUDA
call goes through ``SsdScan`` (a ``torch.autograd.Function``). Its forward
is the serving launch, unchanged; its backward calls K6's backward
(``ssd_scan_bwd`` in ``kernel.cu``), which returns dx, dB and dC in the
inputs' type and ddt and da in fp32, and takes a gradient of the final
state or none. In fp32 that is two CUDA launches (one block per head and
sequence recomputes the chunk-entry states and walks the chunks back on
the CUDA cores, then a fixed-order sum of dB, dC and da over heads and
chunks); in bf16 four, chunk-parallel on the tensor cores (each chunk's
own state and dS term, the elementwise passing of states forward and of
dS backward, each chunk's gradient, the same fixed-order sum). On the CPU
the plain version's own autograd runs. ``KERNEL_LAUNCHES`` counts
``ssd_scan`` (every forward) and ``ssd_scan_bwd`` (one a backward call,
whatever its CUDA launches) apart.

Both launches are registered torch ops (``torch.ops.repro_torch.ssd_scan``
and ``ssd_scan_bwd``): the real implementation is the launch, the fake
one allocates the launch's outputs and scratch (the backward's chunk-entry
states among them) with their shapes and types and counts no launch, so
a step traced on fake tensors (``launch.dryrun``) goes through K6 without
a card; their FLOP formulas count ``analysis.kernel_costs``' products,
each once.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.analysis import kernel_costs
from repro_torch.kernels import KERNEL_LAUNCHES
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain

NAME = "ssd_scan"
MAX_CHUNK = 128             # fp32: 8 rows of 16 threads; bf16: 8 warps of 16
MAX_HEAD_DIM = 64           # fp32: 4 columns of 16; bf16: one 64-wide x tile
MAX_STATE = 128             # fp32: 8 columns of 16; bf16: two 64-wide tiles
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, dt, bmat, cmat, a, q_chunk):
    if x.dim() != 4 or dt.dim() != 3 or bmat.dim() != 3 \
            or bmat.shape != cmat.shape:
        raise ValueError("ssd_scan takes x (B,S,H,P), dt (B,S,H), B and C "
                         "(B,S,N), a (H,)")
    b, s, h, p = x.shape
    if tuple(dt.shape) != (b, s, h) or tuple(bmat.shape[:2]) != (b, s) \
            or tuple(a.shape) != (h,):
        raise ValueError(f"ssd_scan shapes disagree: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, B {tuple(bmat.shape)}, "
                         f"a {tuple(a.shape)}")
    if not 1 <= q_chunk <= MAX_CHUNK:
        raise ValueError(f"q_chunk must be in [1, {MAX_CHUNK}], got "
                         f"{q_chunk}")


def _check_cuda(x, dt, bmat, cmat, a, q_chunk):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"no ssd_scan kernel for device {dev}")
    if x.dtype not in DTYPES:
        raise ValueError(f"ssd_scan takes x in float32 or bfloat16, not "
                         f"{x.dtype}")
    for t in (bmat, cmat):
        if t.device != dev or t.dtype != x.dtype or t.stride(2) != 1:
            raise ValueError("ssd_scan takes B and C of x's type on its "
                             "device with unit stride over N")
    if x.stride(3) != 1:
        raise ValueError("ssd_scan takes x with unit stride over P")
    per16 = 16 // x.element_size()      # values per 16-byte load
    for t in (x, bmat, cmat):
        if t.shape[-1] % per16 or any(st % per16 for st in t.stride()[:-1]):
            raise ValueError("ssd_scan reads x, B and C in 16-byte chunks: "
                             "their rows must be 16-byte aligned")
    for t in (dt, a):
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("ssd_scan takes dt and a as contiguous float32 "
                             "on x's device")
    _, _, h, p = x.shape
    n = bmat.shape[2]
    if p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"ssd_scan takes P <= {MAX_HEAD_DIM} and N <= "
                         f"{MAX_STATE}, got P={p} N={n}")
    if x.shape[0] > 65535:
        raise ValueError("ssd_scan takes at most 65535 sequences")


def _check_aligned(x, bmat, cmat):
    if any(t.data_ptr() % 16 for t in (x, bmat, cmat)):
        raise ValueError("ssd_scan reads x, B and C in 16-byte chunks: "
                         "their rows must be 16-byte aligned")


def _launch_forward(x, dt, bmat, cmat, a, q_chunk):
    """K6 on the card: (y, final state), both fp32."""
    _check_aligned(x, bmat, cmat)
    b, s, h, p = x.shape
    n = bmat.shape[2]
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if b * h == 0:
        return y, final
    if s == 0:             # no positions: the state stays zero
        return y, final.zero_()
    lib = _build.load(NAME)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_fwd(
            DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), bmat.data_ptr(),
            cmat.data_ptr(), a.data_ptr(), y.data_ptr(), final.data_ptr(),
            b, s, h, p, n, q_chunk, *x.stride()[:3], *bmat.stride()[:2],
            *cmat.stride()[:2], stream)
    _build.check(lib, err, NAME)
    KERNEL_LAUNCHES[NAME] += 1
    return y, final


def backward_buffers(x, bmat, q_chunk):
    """The outputs (dx, ddt, dB, dC, da) of K6's backward and its fp32
    scratch: the chunk-entry states (B, H, chunks, P, N), in bf16 also dS
    per chunk (B, H, chunks, P, N), per-head dB and dC (B, S, H, N) and
    per-chunk da (B, H, chunks)."""
    b, s, h, p = x.shape
    n = bmat.shape[2]
    nc = -(-s // q_chunk)
    f32 = {"dtype": torch.float32, "device": x.device}
    outs = (torch.empty((b, s, h, p), dtype=x.dtype, device=x.device),
            torch.empty((b, s, h), **f32),
            torch.empty((b, s, n), dtype=x.dtype, device=x.device),
            torch.empty((b, s, n), dtype=x.dtype, device=x.device),
            torch.empty((h,), **f32))
    states = (b, h, nc, p, n)
    per_chunk = ((torch.empty(states, **f32),) if x.dtype == torch.float32
                 else (torch.empty(states, **f32), torch.empty(states, **f32)))
    scratch = (*per_chunk,
               torch.empty((b, s, h, n), **f32),
               torch.empty((b, s, h, n), **f32),
               torch.empty((b, h, nc), **f32))
    return outs, scratch


def backward_args(x, dt, bmat, cmat, a, dy, dfinal, q_chunk):
    """The outputs (dx, ddt, dB, dC, da), and the arguments of the C
    function ``ssd_scan_bwd`` before the stream (its scratch allocated
    here): dy fp32 contiguous (B, S, H, P), ``dfinal`` fp32 contiguous
    (B, H, P, N) or None."""
    b, s, h, p = x.shape
    n = bmat.shape[2]
    outs, scratch = backward_buffers(x, bmat, q_chunk)
    ptrs = (x, dt, bmat, cmat, a, dy)
    # fp32 takes no dS scratch: a null in its place
    per_chunk = [t.data_ptr() for t in scratch[:-3]] + [None] * (
        2 - len(scratch[:-3]))
    args = (DTYPES[x.dtype], *(t.data_ptr() for t in ptrs),
            None if dfinal is None else dfinal.data_ptr(),
            *per_chunk, *(t.data_ptr() for t in scratch[-3:]),
            *(t.data_ptr() for t in outs), b, s, h, p, n, q_chunk,
            *x.stride()[:3], *bmat.stride()[:2], *cmat.stride()[:2])
    return outs, scratch, args


def _launch_backward(x, dt, bmat, cmat, a, dy, dfinal, q_chunk):
    """K6's backward on the card: (dx, ddt, dB, dC, da). Two CUDA
    launches in fp32, four in bf16; ``KERNEL_LAUNCHES["ssd_scan_bwd"]``
    counts one a call."""
    _check_aligned(x, bmat, cmat)
    b, s, h, _ = x.shape
    if dy.shape != x.shape:
        raise ValueError(f"ssd_scan's dy {tuple(dy.shape)} is not x's "
                         f"{tuple(x.shape)}")
    dy = dy.to(torch.float32).contiguous()
    if dy.data_ptr() % 16:      # read in 16-byte units
        dy = dy.clone()
    if dfinal is not None:
        dfinal = dfinal.to(torch.float32).contiguous()
        if dfinal.data_ptr() % 16:
            dfinal = dfinal.clone()
    outs, scratch, args = backward_args(x, dt, bmat, cmat, a, dy, dfinal,
                                        q_chunk)
    if b * h == 0 or s == 0:
        return tuple(t.zero_() for t in outs)
    lib = _build.load(NAME)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_bwd(*args, stream)
    _build.check(lib, err, f"{NAME}_bwd")
    KERNEL_LAUNCHES[f"{NAME}_bwd"] += 1
    del scratch
    return outs


# ------------------------------------------------------- registered ops
# a CUDA kernel and a fake kernel each, through ``torch.library.Library``
# (its Python dispatch costs less host time a call than ``custom_op``'s:
# see ``kernels/flash_attention/ops.py``)
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("ssd_scan(Tensor x, Tensor dt, Tensor bmat, Tensor cmat, "
            "Tensor a, int q_chunk) -> (Tensor, Tensor)")
_LIB.define("ssd_scan_bwd(Tensor x, Tensor dt, Tensor bmat, Tensor cmat, "
            "Tensor a, Tensor dy, Tensor? dfinal, int q_chunk) -> (Tensor, "
            "Tensor, Tensor, Tensor, Tensor)")
_LIB.impl("ssd_scan", _launch_forward, "CUDA")
_LIB.impl("ssd_scan_bwd", _launch_backward, "CUDA")


@torch.library.register_fake("repro_torch::ssd_scan")
def _(x, dt, bmat, cmat, a, q_chunk):
    b, s, h, p = x.shape
    f32 = {"dtype": torch.float32, "device": x.device}
    return (torch.empty((b, s, h, p), **f32),
            torch.empty((b, h, p, bmat.shape[2]), **f32))


@torch.library.register_fake("repro_torch::ssd_scan_bwd")
def _(x, dt, bmat, cmat, a, dy, dfinal, q_chunk):
    dy = dy.to(torch.float32).contiguous()  # noqa: F841 (the launch's)
    outs, scratch = backward_buffers(x, bmat, q_chunk)  # noqa: F841
    return outs


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _forward_flops(x_shape, dt_shape, b_shape, c_shape, a_shape, q_chunk, *,
                   out_shape=None, **kw):
    b, s, h, p = x_shape
    return kernel_costs.k6_work(b, h, s, p, b_shape[2], q_chunk, 2)[1]


@register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd)
def _backward_flops(x_shape, dt_shape, b_shape, c_shape, a_shape, dy_shape,
                    dfinal_shape, q_chunk, *, out_shape=None, **kw):
    b, s, h, p = x_shape
    return kernel_costs.k6_bwd_work(b, h, s, p, b_shape[2], q_chunk, 2)[1]


class SsdScan(torch.autograd.Function):
    """K6 with its hand-written backward, on CUDA tensors."""

    @staticmethod
    def forward(ctx, x, dt, bmat, cmat, a, q_chunk):
        y, final = torch.ops.repro_torch.ssd_scan(x, dt, bmat, cmat, a,
                                                  q_chunk)
        ctx.save_for_backward(x, dt, bmat, cmat, a)
        ctx.q_chunk = q_chunk
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, bmat, cmat, a = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        grads = torch.ops.repro_torch.ssd_scan_bwd(x, dt, bmat, cmat, a, dy,
                                                   dfinal, ctx.q_chunk)
        return (*grads, None)


def ssd_scan(x, dt, bmat, cmat, a, *, q_chunk: int = 128):
    """x (B, S, H, P); dt (B, S, H) fp32; bmat, cmat (B, S, N); a (H,) fp32
    -> (y (B, S, H, P) fp32, final state (B, H, P, N) fp32), the chunked
    SSD scan in chunks of ``q_chunk`` positions. Differentiable in every
    input (see the module's docstring)."""
    q_chunk = int(q_chunk)
    _check(x, dt, bmat, cmat, a, q_chunk)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, bmat, cmat, a, q_chunk=q_chunk)
    _check_cuda(x, dt, bmat, cmat, a, q_chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, bmat, cmat, a)):
        return SsdScan.apply(x, dt, bmat, cmat, a, q_chunk)
    return torch.ops.repro_torch.ssd_scan(x, dt, bmat, cmat, a, q_chunk)
