"""K6's backward on the CPU: the plain chunked VJP
(``ssd_scan_backward_plain``, the oracle the CUDA backward kernel is held
to on the card) against
autograd of the plain scan and against ``jax.vjp`` of the reference's
``repro/models/ssm.py::_ssd_chunked``; the gradient ``ssd_scan`` gives on
the CPU; the wrapper's arguments against the kernel's C signature; and one
Mamba2 block's gradients, taken through a test-only autograd Function that
pairs the plain scan with the plain VJP (the shape of ``SsdScan`` on the
card), against ``jax.value_and_grad`` of the reference block.

Inputs are made from seeds with numpy. Tolerances, relative to each
gradient's largest |value|:
  * the plain VJP against autograd of the plain scan, both in fp64: 1e-12
    (the same sums in another order);
  * against the reference's fp32 ``jax.vjp``, the plain VJP in fp64:
    2e-5 (fp32 rounding of the reference: the decay exp(cum_t - cum_k)
    carries ~|cum| ulp, measured below 5e-6);
  * ``ssd_scan``'s CPU gradient (autograd of the fp32 plain scan) against
    the fp32 plain VJP: 1e-5 (summation order in fp32);
  * a Mamba2 block against the reference block, fp32: 1e-5 of the larger
    of 1 and each gradient's largest |value|, as ``tests/test_torch_train.py``
    holds every reduced config's gradients (dt_bias's small gradient, a sum
    over every position, lies 7e-6 from fp64 in the port and 1.2e-5 in the
    reference at zamba2-7b's reduced config and S = 256).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models import ssm as j_ssm
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_to_torch
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import (ssd_scan_backward_plain,
                                              ssd_scan_plain)
from repro_torch.models import ssm as t_ssm

torch.set_num_threads(1)
NAMES = ("dx", "ddt", "dB", "dC", "da")


def _inputs(b, s, h, p, n, seed, dtype=np.float64):
    """x, dt (softplused), B, C, a = -exp(a_log), a_log, dy, dfinal."""
    rng = np.random.default_rng(seed)
    a_log = rng.normal(0, 0.5, h)
    out = (rng.normal(0, 1, (b, s, h, p)),
           np.log1p(np.exp(rng.normal(0, 1, (b, s, h)) - 1.5)),
           rng.normal(0, 0.5, (b, s, n)), rng.normal(0, 0.5, (b, s, n)),
           -np.exp(a_log), a_log, rng.normal(0, 1, (b, s, h, p)),
           rng.normal(0, 1, (b, h, p, n)))
    return tuple(np.asarray(v, dtype) for v in out)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-30))


# (B, S, H, P, N, Q, dfinal): a ragged last chunk, more than one chunk,
# N = 128 (mamba2-780m's state), one chunk shorter than Q, one position
PLAIN_CASES = [(2, 200, 3, 8, 16, 64, True), (1, 256, 2, 16, 128, 128, False),
               (1, 256, 2, 16, 128, 128, True), (2, 37, 2, 4, 8, 16, True),
               (1, 1, 1, 4, 8, 16, False)]


@pytest.mark.parametrize("b,s,h,p,n,q,fin", PLAIN_CASES)
def test_plain_backward_is_autograd_of_the_plain_scan(b, s, h, p, n, q, fin):
    x, dt, bm, cm, a, _, dy, df = (torch.from_numpy(v) for v in
                                   _inputs(b, s, h, p, n, b * s + n))
    leaves = [t.clone().requires_grad_() for t in (x, dt, bm, cm, a)]
    y, final = ssd_scan_plain(*leaves, q_chunk=q, dtype=torch.float64)
    outs, grads = ([y, final], [dy, df]) if fin else ([y], [dy])
    want = torch.autograd.grad(outs, leaves, grads)
    got = ssd_scan_backward_plain(x, dt, bm, cm, a, dy, df if fin else None,
                                  q_chunk=q, dtype=torch.float64)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        assert _rel(g, w) <= 1e-12, (name, _rel(g, w))


# (B, S, H, P, N): the reference's chunk is min(128, S) and S a multiple
# of it: one chunk, two chunks with N = 128, three chunks
JAX_CASES = [(2, 64, 3, 8, 16), (1, 256, 2, 16, 128), (1, 384, 2, 8, 32)]


@pytest.mark.parametrize("fin", [False, True])
@pytest.mark.parametrize("b,s,h,p,n", JAX_CASES)
def test_plain_backward_matches_jax_vjp_of_the_reference_scan(b, s, h, p, n,
                                                              fin):
    x, dt, bm, cm, a, a_log, dy, df = _inputs(b, s, h, p, n, 7 * s + h)
    f32 = [v.astype(np.float32) for v in (x, dt, a_log, bm, cm, dy, df)]
    (yj, fj), vjp = jax.vjp(j_ssm._ssd_chunked, *(jnp.asarray(v)
                                                  for v in f32[:5]))
    dfj = jnp.asarray(f32[6]) if fin else jnp.zeros_like(fj)
    dxj, ddtj, da_logj, dbj, dcj = vjp((jnp.asarray(f32[5]), dfj))
    # the plain VJP on the same fp32 values, in fp64
    t = [torch.from_numpy(v.astype(np.float64)) for v in f32]
    a64 = -torch.exp(t[2])
    got = ssd_scan_backward_plain(t[0], t[1], t[3], t[4], a64, t[5],
                                  t[6] if fin else None,
                                  q_chunk=min(t_ssm.CHUNK, s),
                                  dtype=torch.float64)
    # a = -exp(a_log), so d a_log = da * a
    want = (dxj, ddtj, dbj, dcj, da_logj)
    got = (*got[:4], got[4] * a64)
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g, np.asarray(w)) <= 2e-5, (name, _rel(g, np.asarray(w)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_on_the_cpu_differentiates_through_the_plain_scan(dtype):
    x, dt, bm, cm, a, _, dy, df = _inputs(2, 200, 3, 16, 32, 3, np.float32)
    x, bm, cm = (torch.from_numpy(v).to(dtype) for v in (x, bm, cm))
    dt, a, dy, df = (torch.from_numpy(v) for v in (dt, a, dy, df))
    leaves = [t.clone().requires_grad_() for t in (x, dt, bm, cm, a)]
    y, final = ops.ssd_scan(*leaves, q_chunk=64)
    got = torch.autograd.grad([y, final], leaves, [dy, df])
    want = ssd_scan_backward_plain(x, dt, bm, cm, a, dy, df, q_chunk=64)
    for name, g, w, leaf in zip(NAMES, got, want, leaves):
        assert g.dtype == leaf.dtype, name
        tol = 1e-5 if g.dtype == torch.float32 else 8e-3   # bf16 rounding
        assert _rel(g.float(), w.to(g.dtype).float()) <= tol, name


@pytest.mark.parametrize("fin", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_arguments_fit_the_kernels_signature(dtype, fin):
    """``backward_args`` on CPU tensors (the kernel runs on the card only):
    one argument per C parameter before the stream, the strided slices'
    strides, the outputs' shapes and types, dfinal's null, and the
    scratch: the chunk-entry states, in bf16 also dS per chunk (a null in
    its place for fp32), the per-head dB and dC and the per-chunk da."""
    b, s, h, p, n, q = 2, 200, 3, 16, 32, 64
    xbc = torch.zeros((b, s, h * p + 2 * n), dtype=dtype)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.zeros((b, s, h))
    a = torch.zeros(h)
    dy = torch.zeros((b, s, h, p))
    df = torch.zeros((b, h, p, n)) if fin else None
    outs, scratch, args = ops.backward_args(x, dt, bm, cm, a, dy, df, q)
    sig = _build.SIGNATURES["ssd_scan"]["ssd_scan_bwd"]
    assert len(args) + 1 == len(sig)
    assert args[0] == ops.DTYPES[dtype]
    assert (args[7] is None) == (not fin)
    assert (args[9] is None) == (dtype == torch.float32)
    assert args[18:24] == (b, s, h, p, n, q)
    assert args[24:] == (*x.stride()[:3], *bm.stride()[:2],
                         *cm.stride()[:2])
    assert [tuple(t.shape) for t in outs] == [(b, s, h, p), (b, s, h),
                                              (b, s, n), (b, s, n), (h,)]
    assert [t.dtype for t in outs] == [dtype, torch.float32, dtype, dtype,
                                       torch.float32]
    per_chunk = [(b, h, 4, p, n)] * (1 if dtype == torch.float32 else 2)
    assert [tuple(t.shape) for t in scratch] == per_chunk + [
        (b, s, h, n), (b, s, h, n), (b, h, 4)]
    assert all(t.dtype == torch.float32 for t in scratch)


class _PlainSsdScan(torch.autograd.Function):
    """``ssd_scan_plain`` with ``ssd_scan_backward_plain`` as its backward:
    the structure of ``ops.SsdScan`` (kernel forward, kernel backward) with
    the plain versions in place of the kernels."""

    @staticmethod
    def forward(ctx, x, dt, bmat, cmat, a, q_chunk):
        ctx.save_for_backward(x, dt, bmat, cmat, a)
        ctx.q_chunk = q_chunk
        ctx.set_materialize_grads(False)
        return ssd_scan_plain(x, dt, bmat, cmat, a, q_chunk=q_chunk)

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, bmat, cmat, a = ctx.saved_tensors
        grads = ssd_scan_backward_plain(x, dt, bmat, cmat, a, dy, dfinal,
                                        q_chunk=ctx.q_chunk)
        return (*(g.to(t.dtype) for g, t in zip(grads, ctx.saved_tensors)),
                None)


@pytest.mark.parametrize("s", [64, 256])
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b"])
def test_a_mamba2_blocks_gradients_through_the_plain_vjp_match_the_reference(
        arch, s, monkeypatch):
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jp = jax.device_get(j_build_model(jcfg).init(jax.random.PRNGKey(0)))
    stack = (jp["blocks"] if jcfg.family == "ssm" else jp["mamba"])["ssm"]
    rng = np.random.default_rng(11)
    layer = {k: np.asarray(v[0], np.float32) for k, v in stack.items()}
    # move the constant vectors off their init, so their gradients see
    # more than one value
    for k, scale in (("a_log", 0.5), ("dt_bias", 0.5), ("conv_b", 0.1),
                     ("ssm_d", 0.5)):
        layer[k] = layer[k] + rng.normal(0, scale, layer[k].shape).astype(
            np.float32)
    x = rng.normal(0, 1, (2, s, jcfg.d_model)).astype(np.float32)
    r = rng.normal(0, 1, (2, s, jcfg.d_model)).astype(np.float32)

    def j_loss(params, xx):
        return jnp.sum(j_ssm.ssm_block(params, xx, jcfg) * r)
    jl, (jg, jgx) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in layer.items()}, jnp.asarray(x))

    monkeypatch.setattr(t_ssm, "ssd_scan",
                        lambda *a, q_chunk: _PlainSsdScan.apply(*a, q_chunk))
    tp = {k: v.requires_grad_() for k, v in
          lm_params_to_torch(layer, "cpu").items()}
    tx = torch.from_numpy(x).requires_grad_()
    loss = torch.sum(t_ssm.ssm_block(tp, tx, tcfg) * torch.from_numpy(r))
    names = sorted(tp)
    grads = torch.autograd.grad(loss, [*(tp[k] for k in names), tx])
    assert _rel(loss.detach(), np.asarray(jl)) <= 1e-5
    for name, g, want in zip([*names, "x"], grads, [*(jg[k] for k in names),
                                                    jgx]):
        want = np.asarray(want)
        err = float(np.max(np.abs(g.numpy() - want)))
        assert err <= 1e-5 * max(float(np.max(np.abs(want))), 1.0), (name,
                                                                     err)
