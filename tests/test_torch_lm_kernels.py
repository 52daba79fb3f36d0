"""The plain versions of the port's LM kernels (K4 flash_attention, K5
flash_decode, K6 ssd_scan) against the reference's Pallas kernels, run in
interpret mode as tests/test_kernels.py runs them, and against the
reference's oracles (``ref.py``), at tests/test_kernels.py's shapes, on
the same numpy inputs. The CUDA kernels themselves are held against these
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: fp32 2e-5 and bf16 the reference's own (2e-2 for K4, 3e-2
for K5 and K6); K4 and K5 elementwise (atol = rtol), K6 relative to the
largest value, as the reference's tests state them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.flash_decode.ops import flash_decode_attention
from repro.kernels.flash_decode.ref import decode_attention_ref
from repro.kernels.ssd_scan.ops import ssd_scan as j_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref
from repro.models.ssm import _ssd_chunked
from repro_torch.kernels import KERNEL_LAUNCHES
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.kernels.flash_decode.ref import flash_decode_plain
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import (ssd_scan_plain,
                                              ssd_scan_recurrence)

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FP32_TOL = 2e-5


def _both(a: np.ndarray, dtype: str):
    """The same values in both frameworks (bf16: one RNE cast each)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------- K4
@pytest.mark.parametrize("b,s,h,hkv,d", [
    (2, 256, 8, 8, 64), (2, 256, 8, 2, 64), (1, 384, 4, 1, 128),
    (1, 128, 4, 4, 112), (2, 200, 4, 2, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_reference_kernel(b, s, h, hkv, d,
                                                        dtype, causal):
    rng = np.random.default_rng(b * 1000 + s + h + hkv + d)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.standard_normal(shape).astype(np.float32), dtype)
        for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    kern = j_flash(jq, jk, jv, causal=causal, interpret=True)
    oracle = attention_ref(jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
                           jv.transpose(0, 2, 1, 3), scale=d ** -0.5,
                           causal=causal).transpose(0, 2, 1, 3)
    tol = 2e-2 if dtype == "bfloat16" else FP32_TOL
    for want in (kern, oracle):
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_flash_attention_kv_len_masks_the_tail():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 100, 2, 32))
                                .astype(np.float32)) for _ in range(3))
    got = flash_attention(q, k, v, causal=False, kv_len=70)
    want = attention_ref(*(jnp.asarray(t.numpy()).transpose(0, 2, 1, 3)
                           for t in (q, k, v)), scale=32 ** -0.5,
                         causal=False, kv_len=70).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_TOL,
                               rtol=FP32_TOL)
    # keys past kv_len do not matter
    k2 = k.clone()
    k2[:, 70:] = 1e3
    assert torch.equal(flash_attention(q, k2, v, causal=False, kv_len=70),
                       got)


# ------------------------------------------------------------------- K5
@pytest.mark.parametrize("b,s,h,hkv,d,pos", [
    (2, 1024, 8, 8, 64, 700), (2, 1024, 8, 2, 64, 1023),
    (1, 500, 4, 1, 112, 250), (2, 256, 4, 4, 128, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_matches_reference_kernel(b, s, h, hkv, d, pos,
                                                     dtype):
    rng = np.random.default_rng(s + pos + h + d)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.standard_normal(shape).astype(np.float32), dtype)
        for shape in ((b, 1, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    got = flash_decode(tq, tk, tv, torch.tensor(pos, dtype=torch.int32))
    # pos as a Python int gives the same
    assert torch.equal(got, flash_decode(tq, tk, tv, pos))
    kern = flash_decode_attention(jq, jk, jv, pos, interpret=True)
    oracle = decode_attention_ref(
        jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
        jv.transpose(0, 2, 1, 3), pos, scale=d ** -0.5).transpose(0, 2, 1, 3)
    tol = 3e-2 if dtype == "bfloat16" else FP32_TOL
    for want in (kern, oracle):
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_flash_decode_reads_a_layer_of_the_stacked_cache_and_ignores_the_tail():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 32)).astype(np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal((3, 2, 64, 2, 32))
                               .astype(np.float32)) for _ in range(2))
    got = flash_decode(q, kc[1], vc[1], torch.tensor(40, dtype=torch.int32))
    want = flash_decode(q, kc[1].contiguous()[:, :41], vc[1][:, :41].clone(),
                        40)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    kc[1, :, 41:] = 1e4
    assert torch.equal(got, flash_decode(q, kc[1], vc[1], 40))


# ------------------------------------------------------------------- K6
def _ssd_inputs(b, h, s, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.array(jax.nn.softplus(
        rng.standard_normal((b, s, h)).astype(np.float32) - 1.0))
    bm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    a_log = np.linspace(-1.0, 0.5, h).astype(np.float32)
    return x, dt, bm, cm, a_log


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


@pytest.mark.parametrize("b,h,s,p,n,qc", [
    (2, 4, 128, 32, 16, 64), (1, 2, 200, 16, 8, 64),
    (2, 3, 256, 64, 128, 128), (1, 7, 128, 64, 64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_plain_matches_reference_kernel(b, h, s, p, n, qc, dtype):
    x, dt, bm, cm, a_log = _ssd_inputs(b, h, s, p, n, seed=s + p + n)
    (jx, tx), (jb, tb), (jc, tc) = (_both(t, dtype) for t in (x, bm, cm))
    a = -np.exp(a_log)
    ta = torch.from_numpy(a)
    y, state = ssd_scan(tx, torch.from_numpy(dt), tb, tc, ta, q_chunk=qc)
    assert y.dtype == torch.float32 and y.shape == (b, s, h, p)
    assert state.shape == (b, h, p, n)
    # the reference's kernel and oracle take (B, H, S, P) and (B, H, S)
    jxt, jdt = jx.transpose(0, 2, 1, 3), jnp.asarray(dt).transpose(0, 2, 1)
    kern = j_ssd_scan(jxt, jdt, jb, jc, jnp.asarray(a), q_chunk=qc,
                      interpret=True).transpose(0, 2, 1, 3)
    oracle = ssd_scan_ref(jxt, jdt, jb, jc, jnp.asarray(a)) \
        .transpose(0, 2, 1, 3)
    tol = 3e-2 if dtype == "bfloat16" else FP32_TOL
    assert _rel(y, kern) < tol
    assert _rel(y, oracle) < tol
    # the literal recurrence, ported, against the reference's
    ry, rstate = ssd_scan_recurrence(tx, torch.from_numpy(dt), tb, tc, ta)
    assert _rel(ry, oracle) < tol
    assert _rel(state, rstate) < tol


@pytest.mark.parametrize("b,h,s,p,n", [
    (2, 4, 128, 32, 16), (1, 7, 128, 64, 64), (2, 3, 256, 64, 128),
    (2, 8, 512, 32, 16)])
def test_ssd_scan_final_state_matches_the_reference_model(b, h, s, p, n):
    """K6 writes the final state that seeds decode: the reference model's
    ``_ssd_chunked`` returns it; its y too (the model's chunk of 128)."""
    x, dt, bm, cm, a_log = _ssd_inputs(b, h, s, p, n, seed=7 * s + n)
    jy, jstate = _ssd_chunked(jnp.asarray(x), jnp.asarray(dt),
                              jnp.asarray(a_log), jnp.asarray(bm),
                              jnp.asarray(cm))
    ta = -torch.exp(torch.from_numpy(a_log))
    y, state = ssd_scan(*(torch.from_numpy(t) for t in (x, dt, bm, cm)), ta,
                        q_chunk=min(128, s))
    assert _rel(state, jstate) < FP32_TOL
    assert _rel(y, jy) < FP32_TOL


def test_ssd_scan_padding_rows_are_inert():
    """A sequence that is not a multiple of the chunk is scanned as if
    padded with dt = 0 rows (the reference wrapper's padding)."""
    x, dt, bm, cm, a_log = _ssd_inputs(1, 2, 200, 16, 8, seed=11)
    t = [torch.from_numpy(v) for v in (x, dt, bm, cm)]
    a = -torch.exp(torch.from_numpy(a_log))
    y, state = ssd_scan(*t, a, q_chunk=64)
    pad = [torch.nn.functional.pad(v, (0, 0) * (v.dim() - 2) + (0, 56))
           for v in t]
    yp, statep = ssd_scan(*pad, a, q_chunk=64)
    torch.testing.assert_close(yp[:, :200], y, rtol=0, atol=0)
    torch.testing.assert_close(statep, state, rtol=0, atol=0)


def test_ssd_scan_fp32_spread_is_that_of_two_fp32_evaluations():
    """The chunked scan in fp32 carries the rounding of the cumulative decay
    (exp(cum_q - cum_t) with |cum| up to ~60 in a chunk); the plain version
    and the reference's interpret-mode kernel each lie within 2e-5 of the
    scan computed in fp64, and of each other."""
    x, dt, bm, cm, a_log = _ssd_inputs(2, 3, 256, 64, 128, seed=3)
    t = [torch.from_numpy(v) for v in (x, dt, bm, cm)]
    a = -torch.exp(torch.from_numpy(a_log))
    y32, _ = ssd_scan_plain(*t, a)
    y64, _ = ssd_scan_plain(*t, a, dtype=torch.float64)
    kern = j_ssd_scan(jnp.asarray(x).transpose(0, 2, 1, 3),
                      jnp.asarray(dt).transpose(0, 2, 1), jnp.asarray(bm),
                      jnp.asarray(cm), jnp.asarray(a.numpy()),
                      interpret=True).transpose(0, 2, 1, 3)
    for got in (y32, kern):
        assert _rel(got, y64.numpy()) < FP32_TOL
    assert _rel(y32, kern) < FP32_TOL


# The bf16 CUDA kernel works in tiles of 16 chunk rows: a chunk Q that is
# not a multiple of 16 leaves rows Q..16 ceil(Q / 16) of its tile outside
# the chunk, and a ragged last chunk leaves rows past S; both must be
# inert. The plain version, which the CPU path runs and the kernel is held
# to on the card, agrees with the reference's oracle at such Q.
@pytest.mark.parametrize("s,qc", [(77, 16), (100, 40), (200, 64),
                                  (130, 128), (5, 128), (96, 24)])
def test_ssd_scan_plain_matches_the_reference_oracle_at_any_chunk(s, qc):
    x, dt, bm, cm, a_log = _ssd_inputs(1, 3, s, 16, 8, seed=s + qc)
    a = -np.exp(a_log)
    t = [torch.from_numpy(v) for v in (x, dt, bm, cm)]
    y, state = ssd_scan(*t, torch.from_numpy(a), q_chunk=qc)
    oracle = ssd_scan_ref(jnp.asarray(x).transpose(0, 2, 1, 3),
                          jnp.asarray(dt).transpose(0, 2, 1),
                          jnp.asarray(bm), jnp.asarray(cm),
                          jnp.asarray(a)).transpose(0, 2, 1, 3)
    assert _rel(y, oracle) < FP32_TOL
    _, rstate = ssd_scan_recurrence(*t, torch.from_numpy(a))
    assert _rel(state, rstate) < FP32_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_reads_the_slices_of_the_convolution_output(dtype):
    """models/ssm.py hands K6 x, B and C as strided views of one (B, S,
    H P + 2 N) buffer, which the kernels read in place (the bf16 kernel
    through tensor maps over the views): the CPU path gives the same
    result on the views as on contiguous copies, and the reference's
    kernel agrees."""
    b, h, s, p, n = 2, 3, 200, 16, 8
    rng = np.random.default_rng(5)
    xbc = rng.standard_normal((b, s, h * p + 2 * n)).astype(np.float32)
    dt = np.array(jax.nn.softplus(
        rng.standard_normal((b, s, h)).astype(np.float32) - 1.0))
    a = -np.exp(np.linspace(-1.0, 0.5, h).astype(np.float32))
    jbuf, tbuf = _both(xbc, dtype)
    di = h * p
    views = (tbuf[..., :di].reshape(b, s, h, p), tbuf[..., di:di + n],
             tbuf[..., di + n:])
    assert not any(v.is_contiguous() for v in views)
    tdt, ta = torch.from_numpy(dt), torch.from_numpy(a)
    tx, tb, tc = views
    y, state = ssd_scan(tx, tdt, tb, tc, ta, q_chunk=64)
    y2, state2 = ssd_scan(tx.contiguous(), tdt, tb.contiguous(),
                          tc.contiguous(), ta, q_chunk=64)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    torch.testing.assert_close(state, state2, rtol=0, atol=0)
    kern = j_ssd_scan(jbuf[..., :di].reshape(b, s, h, p).transpose(0, 2, 1, 3),
                      jnp.asarray(dt).transpose(0, 2, 1), jbuf[..., di:di + n],
                      jbuf[..., di + n:], jnp.asarray(a), q_chunk=64,
                      interpret=True).transpose(0, 2, 1, 3)
    assert _rel(y, kern) < (3e-2 if dtype == "bfloat16" else FP32_TOL)


# ------------------------------------------------------------ wrappers
def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    before = dict(KERNEL_LAUNCHES)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 16, 2, 32)).astype(np.float32))
    assert torch.equal(flash_attention(q, q, q), flash_attention_plain(q, q, q))
    assert torch.equal(flash_decode(q[:, :1], q, q, 7),
                       flash_decode_plain(q[:, :1], q, q, 7))
    assert dict(KERNEL_LAUNCHES) == before


@pytest.mark.parametrize("call", [
    lambda z: flash_attention(z((1, 8, 4, 32)), z((1, 8, 3, 32)),
                              z((1, 8, 3, 32))),       # 4 heads over 3 kv
    lambda z: flash_attention(z((1, 8, 2, 32)), z((1, 9, 2, 32)),
                              z((1, 9, 2, 32))),       # S differs
    lambda z: flash_attention(z((1, 8, 2, 32)), z((1, 8, 2, 32)),
                              z((1, 8, 2, 32)), kv_len=9),
    lambda z: flash_decode(z((1, 2, 2, 32)), z((1, 8, 2, 32)),
                           z((1, 8, 2, 32)), 3),      # two query tokens
    lambda z: ssd_scan(z((1, 8, 2, 4)), z((1, 8, 2)), z((1, 8, 4)),
                       z((1, 8, 4)), z((2,)), q_chunk=256),
    lambda z: ssd_scan(z((1, 8, 2, 4)), z((1, 8, 3)), z((1, 8, 4)),
                       z((1, 8, 4)), z((2,))),
])
def test_wrappers_refuse_what_they_do_not_take(call):
    with pytest.raises(ValueError):
        call(torch.zeros)


# ------------------------------------------- the kernels' host planning
@pytest.mark.parametrize("s_max,groups,want", [
    (1, 1, (1, 64)), (64, 1, (1, 64)), (65, 1, (2, 64)), (500, 2, (8, 64)),
    (513, 16, (5, 128)), (2080, 256, (2, 1088)), (2080, 1024, (1, 2112)),
    (4096, 32, (8, 512)), (4096, 64, (5, 832))])
def test_flash_decode_split_plan_covers_s_max_with_at_most_8_splits(
        s_max, groups, want):
    """About two blocks per SM of a 132-SM card, from the shapes alone."""
    from repro_torch.kernels.flash_decode.ops import (MAX_SPLITS, TILE,
                                                      split_plan)
    splits, span = split_plan(s_max, groups, 132)
    assert (splits, span) == want
    assert 1 <= splits <= MAX_SPLITS and span % TILE == 0
    # the splits cover S_max and none starts past it
    assert splits * span >= s_max > (splits - 1) * span


@pytest.mark.parametrize("args", [(0, 8, 132), (64, 0, 132), (64, 8, 0)])
def test_flash_decode_split_plan_refuses_empty_sizes(args):
    from repro_torch.kernels.flash_decode.ops import split_plan
    with pytest.raises(ValueError):
        split_plan(*args)


@pytest.mark.parametrize("shape", [(8, 2048, 32, 112), (2, 200, 2, 64),
                                   (1, 384, 1, 128), (2, 256, 8, 32)])
@pytest.mark.parametrize("rows", ["TILE", "KEYS"])
def test_flash_attention_tensor_map_is_4d_over_d_heads_s_b(shape, rows):
    from repro_torch.kernels.flash_attention import ops
    b, s, h, d = shape
    t = torch.zeros(shape, dtype=torch.bfloat16)
    dims, strides, box = ops.tensor_map_plan(t, getattr(ops, rows))
    assert dims == (d, h, s, b)
    assert strides == (2 * d, 2 * h * d, 2 * s * h * d)
    # one box is 64 values (128 bytes, one swizzle row) of one head over
    # the query or key positions of a tile: it never reaches into the next
    # head
    assert box == (ops.ATOM, 1, getattr(ops, rows), 1) and ops.ATOM * 2 == 128


def test_flash_attention_tensor_map_follows_a_view_s_strides():
    """A layer's slice of a stacked (B, L, S, H, D) tensor is described
    through its own strides, not copied."""
    from repro_torch.kernels.flash_attention.ops import tensor_map_plan
    t = torch.zeros(2, 3, 64, 4, 32, dtype=torch.bfloat16)[:, 1]
    dims, strides, _ = tensor_map_plan(t)
    assert dims == (32, 4, 64, 2)
    assert strides == (2 * 32, 2 * 4 * 32, 2 * 3 * 64 * 4 * 32)


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(1, 8, 2, 36, dtype=torch.bfloat16)[..., :32],
    lambda: torch.zeros(1, 8, 3, 36, dtype=torch.bfloat16).transpose(2, 3),
    lambda: torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)[..., 1:],
])
def test_flash_attention_tensor_map_refuses_what_tma_does_not_take(make):
    from repro_torch.kernels.flash_attention.ops import tensor_map_plan
    with pytest.raises(ValueError):
        tensor_map_plan(make())
