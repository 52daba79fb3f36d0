"""K4's backward kernel rounds dS to bf16 before dQ = dS K and dK = dS^T Q
(the A operand of its tensor-core products), a rounding point the plain
backward (autograd of ``flash_attention_plain``, which keeps dS in fp32)
does not have. ``flash_attention_backward_rounded`` computes the backward
with the kernel's rounding points; here, on the CPU in bf16, it is held to
the plain backward within the card's bf16 tolerance for the kernel,
``chip_smoke.K4_BWD_TOL["bfloat16"]`` (3e-2 of each gradient's largest
|value|), at the reference's attention test shapes and at granite-3-2b's
training shape, causal and not, all keys and kv_len = S - 37; in fp32 the
two agree to fp32 rounding (2e-5), since nothing is rounded.

Inputs are made from a seed with numpy.
"""
import numpy as np
import pytest
import torch

from chip_smoke import K4_BWD_TOL, K4_SHAPES
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_backward_plain, flash_attention_backward_rounded)

GRANITE_TRAIN = (8, 256, 32, 8, 64)


def _inputs(shape, dtype, seed):
    b, s, h, hkv, d = shape
    rng = np.random.default_rng(seed)
    f = lambda *sh: torch.from_numpy(  # noqa: E731
        rng.standard_normal(sh).astype(np.float32)).to(dtype)
    return f(b, s, h, d), f(b, s, hkv, d), f(b, s, hkv, d), f(b, s, h, d)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


@pytest.mark.parametrize("shape", K4_SHAPES + [GRANITE_TRAIN])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rounded_backward_within_the_kernels_tolerance(shape, dtype):
    torch.set_num_threads(1)
    q, k, v, dout = _inputs(shape, dtype, 7)
    s = shape[1]
    tol = (K4_BWD_TOL["bfloat16"] if dtype == torch.bfloat16 else
           K4_BWD_TOL["float32"])
    for causal in (True, False):
        for kv_len in sorted({s, s - 37}):
            got = flash_attention_backward_rounded(q, k, v, dout,
                                                   causal=causal,
                                                   kv_len=kv_len)
            want = flash_attention_backward_plain(q, k, v, dout,
                                                  causal=causal,
                                                  kv_len=kv_len)
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                assert g.dtype == w.dtype == dtype, name
                assert _rel(g, w) <= tol, (name, causal, kv_len, _rel(g, w))
