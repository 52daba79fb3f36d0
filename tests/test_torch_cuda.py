"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one (a CUDA
kernel has no CPU mode); on the GPU run ``pytest -m cuda
tests/test_torch_cuda.py``. Imports nothing of JAX."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# the segment-DP profiles, kinds and grid of chip_smoke.py
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import (K1_TOL, K3_EDGE_MG, K3_GS, K3_KINDS,  # noqa: E402
                        K3_MS, K4_BWD_SHAPES,
                        K4_SHAPES, K5_SHAPES, K6_BWD_SHAPES, K6_SHAPES,
                        LM_TOL, _composed_predict, _mlp_predict_inputs,
                        check_k4_backward, check_k6_backward,
                        check_lm_kernels, k3_profiles, k6_fp32_distance,
                        lm_kernel_inputs, to_cpu)

from repro_torch.kernels import KERNEL_LAUNCHES  # noqa: E402
from repro_torch.kernels.ensemble_mlp.ops import (ensemble_mlp_forward,  # noqa: E402
                                                  mlp_predict)
from repro_torch.kernels.ensemble_mlp.ref import (ensemble_mlp_ref,  # noqa: E402
                                                  mlp_predict_ref)
from repro_torch.kernels.knn.ops import (SPLITS, knn_predict,  # noqa: E402
                                         pairwise_sq_dists)
from repro_torch.kernels.knn.ref import (knn_predict_ref,  # noqa: E402
                                         pairwise_sq_dists_ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _randn(rng, *shape, scale=1.0, device):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("m,t,d,h", [(1, 1, 1, 32), (1, 128, 1, 32),
                                     (1, 1000, 1, 32), (3, 300, 4, 32)])
def test_ensemble_mlp_kernel_matches_plain(cuda, m, t, d, h):
    rng = np.random.default_rng(t)
    args = (_randn(rng, m, t, d, device=cuda),
            _randn(rng, m, d, h, scale=0.5, device=cuda),
            _randn(rng, m, h, scale=0.1, device=cuda),
            _randn(rng, m, h, 1, scale=0.5, device=cuda),
            _randn(rng, m, 1, scale=0.1, device=cuda))
    before = KERNEL_LAUNCHES["ensemble_mlp"]
    got = ensemble_mlp_forward(*args)
    want = ensemble_mlp_ref(*args)
    assert KERNEL_LAUNCHES["ensemble_mlp"] == before + 1
    # fp32 sums over h in another order, and CUDA's tanhf
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
# k <= 5 and k > 5 run different register lists in the kernel
@pytest.mark.parametrize("q,t,d,ties,k", [(1, 128, 1, False, 5),
                                          (64, 128, 1, True, 5),
                                          (37, 300, 4, True, 5),
                                          (37, 300, 2, True, 1),
                                          (37, 300, 2, True, 6),
                                          (37, 300, 2, True, 32)])
def test_knn_kernels_equal_plain(cuda, q, t, d, ties, k):
    rng = np.random.default_rng(q)
    if ties:
        qs = torch.from_numpy(rng.integers(0, 5, (q, d)).astype(np.float32))
        hist = torch.from_numpy(rng.integers(0, 5, (t, d)).astype(np.float32))
        qs, hist = qs.to(cuda), hist.to(cuda)
    else:
        qs, hist = _randn(rng, q, d, device=cuda), _randn(rng, t, d,
                                                          device=cuda)
    ys = _randn(rng, t, scale=10.0, device=cuda)
    mask = (torch.rand(t, generator=torch.Generator().manual_seed(q)) > 0.3
            ).to(torch.float32).to(cuda)
    scale = torch.linspace(0.5, 2.0, d, device=cuda)
    before = KERNEL_LAUNCHES["knn_predict"]
    assert torch.equal(knn_predict(qs, hist, ys, mask, scale, k),
                       knn_predict_ref(qs, hist, ys, mask, scale, k))
    assert KERNEL_LAUNCHES["knn_predict"] == before + 1
    assert torch.equal(pairwise_sq_dists(qs, hist, mask),
                       pairwise_sq_dists_ref(qs, hist, mask))


# the fused predict at the replays' (T, d) and ragged ones: within K1_TOL
# of its plain version and bitwise the five launches it replaces
@pytest.mark.cuda
@pytest.mark.parametrize("t,d", [(1, 1), (128, 1), (256, 1), (4, 2),
                                 (128, 2), (256, 2), (512, 2), (1024, 2),
                                 (7, 3), (300, 4)])
def test_fused_mlp_predict_matches_plain(cuda, t, d):
    args = _mlp_predict_inputs(t, d, 32, t + d, cuda)
    before = KERNEL_LAUNCHES["ensemble_mlp"]
    got = mlp_predict(*args)
    assert KERNEL_LAUNCHES["ensemble_mlp"] == before + 1
    want = mlp_predict_ref(*args)
    assert bool(((got - want).abs() <= K1_TOL * (1 + want.abs())).all())
    assert torch.equal(got, _composed_predict(*args))


# K2 at every (Q, T, d) the peak and temporal replays launch, and at T not a
# multiple of 32, Q from 1 to 1024: bitwise its plain version with and
# without ties, k of 1, 5 and 32, every number of warps a query
K2_REPLAY = [(1, 128, 1), (128, 128, 1), (256, 256, 1), (4, 128, 2),
             (4, 256, 2), (4, 512, 2), (128, 128, 2), (256, 256, 2),
             (512, 512, 2), (1024, 1024, 2), (1024, 1024, 1), (1, 33, 1),
             (2, 95, 2), (9, 161, 2), (65, 300, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("q,t,d", K2_REPLAY)
def test_knn_kernel_is_bitwise_plain_at_the_replay_shapes(cuda, q, t, d,
                                                          ties):
    from chip_smoke import _k2_inputs
    qs, hist, ys, mask, scale = _k2_inputs(q, t, d, q + t, cuda, ties)
    for k in (1, 5, 32):
        want = knn_predict_ref(qs, hist, ys, mask, scale, k)
        for s in SPLITS:
            assert torch.equal(knn_predict(qs, hist, ys, mask, scale, k,
                                           splits=s), want), (k, s)


@pytest.mark.cuda
@pytest.mark.parametrize("valid", [0, 1, 3, 4])
@pytest.mark.parametrize("k", [1, 5, 32])
def test_knn_kernel_with_fewer_valid_rows_than_k(cuda, valid, k):
    from chip_smoke import _k2_inputs
    qs, hist, ys, _mask, scale = _k2_inputs(6, 200, 2, valid, cuda, True)
    mask = torch.zeros(200, device=cuda)
    mask[torch.arange(valid, device=cuda) * 37 + 5] = 1.0
    want = knn_predict_ref(qs, hist, ys, mask, scale, k)
    if valid == 0:
        assert not bool(want.any())
    for s in SPLITS:
        assert torch.equal(knn_predict(qs, hist, ys, mask, scale, k,
                                       splits=s), want)


@pytest.mark.cuda
def test_wrappers_refuse_non_contiguous_input(cuda):
    x = torch.zeros((1, 4, 2), device=cuda)[:, :, :1]
    with pytest.raises(ValueError):
        ensemble_mlp_forward(x, torch.zeros((1, 1, 8), device=cuda),
                             torch.zeros((1, 8), device=cuda),
                             torch.zeros((1, 8, 1), device=cuda),
                             torch.zeros((1, 1), device=cuda))


def _segment_dp_equals_plain(cuda, kind, m, g):
    from repro_torch.kernels.segment_dp.ops import fit_cuts, segment_cost
    from repro_torch.kernels.segment_dp.ref import (cost_matrix_plain,
                                                    cost_matrix_ref,
                                                    fit_cuts_plain,
                                                    fit_cuts_ref)
    P = k3_profiles(kind, m, g, seed=m * 100 + g)
    tP = torch.from_numpy(P).to(cuda)
    before = KERNEL_LAUNCHES["segment_dp"]
    for k in sorted({1, 2, 4, g}):
        got = fit_cuts(tP, k)
        assert torch.equal(got, fit_cuts_plain(tP, k))
        np.testing.assert_array_equal(got.cpu().numpy(), fit_cuts_ref(P, k))
    assert KERNEL_LAUNCHES["segment_dp"] == before + len({1, 2, 4, g})
    cost = segment_cost(tP)
    assert torch.equal(cost, cost_matrix_plain(tP))
    np.testing.assert_array_equal(cost.cpu().numpy(), cost_matrix_ref(P))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", K3_KINDS)
@pytest.mark.parametrize("g", K3_GS)
@pytest.mark.parametrize("m", K3_MS)
def test_segment_dp_kernel_equals_plain_bitwise(cuda, kind, m, g):
    """chip_smoke.py's phase 3 for one (M, G) and profile kind: its
    profiles, seeds and grid."""
    _segment_dp_equals_plain(cuda, kind, m, g)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", K3_KINDS)
@pytest.mark.parametrize("m,g", K3_EDGE_MG)
def test_segment_dp_kernel_at_its_plan_edges_equals_plain_bitwise(cuda, kind,
                                                                  m, g):
    """The same at the edges of the kernel's tiling plan (chip_smoke.py's
    K3_EDGES): M around one tile of profiles, the cost matrix in shared
    memory and in device scratch, one band of start columns and two, and
    G = 1024."""
    _segment_dp_equals_plain(cuda, kind, m, g)


@pytest.mark.cuda
def test_temporal_replay_on_the_card_launches_one_fit_per_boundary_fit(
        cuda):
    """sizey_temporal at methylseq scale 0.05 on the card: one segment-DP
    launch per boundary fit, and the boundaries of the CPU replay."""
    from repro_torch.baselines import make_method
    from repro_torch.core.temporal.predictor import BOUNDARY_COUNTS
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.workflow import generate_workflow, simulate
    bounds = {}
    for dev in ("cuda", "cpu"):
        method = make_method("sizey_temporal", device=dev)
        seen = bounds.setdefault(dev, [])
        pb = method.predictor.predict_batch
        method.predictor.predict_batch = lambda ts, pb=pb, seen=seen: [
            seen.append(d.boundaries) or d for d in pb(ts)]
        BOUNDARY_COUNTS.clear()
        reset_launch_counts()
        res = simulate(generate_workflow("methylseq", scale=0.05), method)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert KERNEL_LAUNCHES["segment_dp"] == BOUNDARY_COUNTS["fit"] \
                == 17
            assert KERNEL_LAUNCHES["ensemble_mlp"] > 0
            assert KERNEL_LAUNCHES["knn_predict"] > 0
        else:
            assert KERNEL_LAUNCHES["segment_dp"] == 0
        assert len(res.outcomes) == 44
    assert bounds["cuda"] == bounds["cpu"]


# K4-K6 at the reference's test shapes and at the serve phase's full-width
# shapes, fp32 and bf16, with chip_smoke.py's checks and tolerances; K4 also
# at the edges of its 128-row query and 128-key tiles (S = 200 and 1,000),
# D = 32, 64, 112 and 128, GQA 8/2 and 4/1, and enough blocks for several
# waves; K5 at GQA groups of 4 and 8
LM_CASES = ([("flash_attention", s) for s in K4_SHAPES
             + [(8, 2048, 32, 32, 112), (3, 200, 4, 1, 32),
                (2, 1000, 8, 2, 112), (2, 1000, 4, 1, 128),
                (4, 512, 32, 32, 64), (2, 1000, 8, 8, 64)]]
            + [("flash_decode", s) for s in K5_SHAPES
               + [(8, 2080, 32, 32, 112, 2047), (2, 4096, 32, 8, 128, 3000),
                  (2, 4096, 32, 4, 128, 4000), (1, 500, 8, 1, 64, 499)]]
            + [("ssd_scan", s) for s in K6_SHAPES
               + [(8, 112, 2048, 64, 64, 128)]])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", LM_CASES)
def test_lm_kernels_match_their_plain_versions(cuda, kind, shape):
    before = KERNEL_LAUNCHES[kind]
    check_lm_kernels(*([shape] if k == kind else [] for k in
                       ("flash_attention", "flash_decode", "ssd_scan")))
    # fp32 and bf16, K4 causal and not, K6's fp32 kernel also fed the bf16
    # inputs' values
    assert KERNEL_LAUNCHES[kind] == before + {"flash_attention": 4,
                                              "flash_decode": 2,
                                              "ssd_scan": 3}[kind]


# K6's bf16 path on the tensor cores, fed by TMA: x, B and C as the strided
# slices of one (B, S, H P + 2 N) buffer that models/ssm.py makes, at a
# ragged last chunk (S = 200, Q = 64), N = 8 and 128, P = 16 and 64, B x H
# of 1 and 2 (below the SM count), odd head counts, chunks that are not a
# multiple of 16 rows (Q = 40, 24) and the serve's shape; y and the final
# state each held to chip_smoke.py's LM_TOL
K6_TC_CASES = [(1, 2, 200, 16, 8, 64), (2, 3, 200, 64, 128, 64),
               (1, 1, 256, 64, 64, 128), (1, 2, 384, 16, 64, 128),
               (2, 7, 300, 64, 8, 128), (3, 5, 100, 32, 128, 40),
               (1, 3, 96, 24, 16, 24), (8, 112, 2048, 64, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K6_TC_CASES)
def test_ssd_scan_bf16_kernel_reads_the_convolution_output(cuda, shape):
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain
    b, h, s, p, n, q = shape
    rng = np.random.default_rng(sum(shape))
    di = h * p
    xbc = _randn(rng, b, s, di + 2 * n, device=cuda).to(torch.bfloat16)
    x = xbc[..., :di].reshape(b, s, h, p)
    bm, cm = xbc[..., di:di + n], xbc[..., di + n:]
    assert x.data_ptr() == xbc.data_ptr()          # views, not copies
    dt = torch.nn.functional.softplus(_randn(rng, b, s, h, device=cuda)
                                      - 1.0)
    a = -torch.exp(torch.linspace(-1.0, 0.5, h, device=cuda))
    before = KERNEL_LAUNCHES["ssd_scan"]
    y, state = ssd_scan(x, dt, bm, cm, a, q_chunk=q)
    want_y, want_state = ssd_scan_plain(x, dt, bm, cm, a, q_chunk=q)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["ssd_scan"] == before + 1
    assert y.shape == (b, s, h, p) and state.shape == (b, h, p, n)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())
    tol = LM_TOL["ssd_scan"][1]
    assert float((y - want_y).abs().max()) <= tol * float(
        want_y.abs().max())
    assert float((state - want_state).abs().max()) <= tol * float(
        want_state.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K6_TC_CASES)
def test_ssd_scan_bf16_kernel_does_fp32_math(cuda, shape):
    """K6's bf16 kernel lies no farther from the fp32 plain version,
    relative to the largest |y|, than twice the fp32 kernel fed the same
    values (three bf16 passes for every fp32 operand)."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain
    x, dt, bm, cm, a = lm_kernel_inputs("ssd_scan", shape, torch.bfloat16,
                                        sum(shape), cuda)
    q = shape[5]
    y, _st = ssd_scan(x, dt, bm, cm, a, q_chunk=q)
    wy, wst = ssd_scan_plain(x, dt, bm, cm, a, q_chunk=q)
    ry32, _ = k6_fp32_distance(x, dt, bm, cm, a, q, wy, wst)
    assert float((y - wy).abs().max() / wy.abs().max()) <= 2 * ry32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_of_no_positions_leaves_a_zero_state(cuda, dtype):
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    x, dt, bm, cm, a = lm_kernel_inputs("ssd_scan", (2, 3, 0, 16, 8, 64),
                                        dtype, 0, cuda)
    y, state = ssd_scan(x, dt, bm, cm, a, q_chunk=64)
    assert y.shape == (2, 0, 3, 16)
    assert state.shape == (2, 3, 16, 8) and not bool(state.any())


@pytest.mark.cuda
@pytest.mark.parametrize("kv_len", [1, 64, 127, 128, 129, 999])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_masks_keys_past_kv_len(cuda, kv_len, causal):
    """kv_len < S: the tail tile is masked and keys past it never count,
    causal or not, bf16 (the wgmma path) and fp32."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        q, k, v = lm_kernel_inputs("flash_attention", (2, 1000, 8, 2, 112),
                                   dtype, kv_len, cuda)
        got = flash_attention(q, k, v, causal=causal, kv_len=kv_len)
        want = flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len)
        assert ((got.float() - want.float()).abs()
                <= tol * (1 + want.float().abs())).all()
        k[:, kv_len:] = 1e4
        v[:, kv_len:] = 1e4
        assert torch.equal(flash_attention(q, k, v, causal=causal,
                                           kv_len=kv_len), got)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2080, 8, 8, 112),
                                   (8, 2080, 32, 32, 112),
                                   (2, 4096, 32, 8, 128),
                                   (2, 4096, 32, 4, 128)])
def test_flash_decode_kernel_at_the_split_boundaries(cuda, shape):
    """pos = 0, each split's first and last position and its neighbours,
    and S_max - 1, with the split plan the wrapper takes on this card."""
    from repro_torch.kernels.flash_decode.ops import _sm_count, split_plan
    b, smax, h, hkv, d = shape
    splits, span = split_plan(smax, b * hkv, _sm_count(cuda.index or 0))
    assert splits >= 2
    edges = sorted({0, smax - 1} | {p for i in range(1, splits)
                                    for p in (i * span - 1, i * span,
                                              i * span + 1) if p < smax})
    before = KERNEL_LAUNCHES["flash_decode"]
    check_lm_kernels([], [(*shape, p) for p in edges], [],
                     label="split edges")
    assert KERNEL_LAUNCHES["flash_decode"] == before + 2 * len(edges)


@pytest.mark.cuda
def test_flash_decode_kernel_reads_a_strided_layer_view(cuda):
    """One layer of a (B, L, S_max, Hkv, D) stack: non-contiguous over B,
    read through its strides with no copy."""
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_plain
    g = torch.Generator(device=cuda).manual_seed(1)
    kc = torch.randn(2, 3, 2080, 8, 112, generator=g, device=cuda)
    vc = torch.randn(2, 3, 2080, 8, 112, generator=g, device=cuda)
    q = torch.randn(2, 1, 32, 112, generator=g, device=cuda)
    for dtype, tol in ((torch.bfloat16, 3e-2), (torch.float32, 2e-5)):
        kl, vl = kc.to(dtype)[:, 1], vc.to(dtype)[:, 1]
        assert not kl.is_contiguous()
        for pos in (0, 1029, 2079):
            p = torch.tensor(pos, dtype=torch.int32, device=cuda)
            got = flash_decode(q.to(dtype), kl, vl, p)
            want = flash_decode_plain(q.to(dtype), kl, vl, p)
            assert ((got.float() - want.float()).abs()
                    <= tol * (1 + want.float().abs())).all()
            # the same every run: the splits merge in a fixed order
            assert torch.equal(flash_decode(q.to(dtype), kl, vl, p), got)


@pytest.mark.cuda
def test_lm_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    q, k, v = lm_kernel_inputs("flash_attention", (1, 64, 2, 2, 64),
                               torch.float16, 0, cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(q, k, v)
    q, k, v = lm_kernel_inputs("flash_attention", (1, 64, 2, 2, 120),
                               torch.float32, 0, cuda)
    with pytest.raises(ValueError, match="D % 16"):
        flash_attention(q, k, v)
    q, kc, vc, _ = lm_kernel_inputs("flash_decode", (1, 64, 2, 2, 64, 3),
                                    torch.float32, 0, cuda)
    with pytest.raises(ValueError, match="int32"):
        flash_decode(q, kc, vc, 3)       # pos must live on the card
    q, kc, vc, pos = lm_kernel_inputs("flash_decode", (1, 64, 32, 2, 64, 3),
                                      torch.float32, 0, cuda)
    with pytest.raises(ValueError, match="at most 8 query heads"):
        flash_decode(q, kc, vc, pos)     # G = 16
    q, k, v = lm_kernel_inputs("flash_attention", (1, 64, 2, 2, 64),
                               torch.bfloat16, 0, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                        v)
    x, dt, bm, cm, a = lm_kernel_inputs("ssd_scan", (1, 2, 128, 64, 256, 128),
                                        torch.float32, 0, cuda)
    with pytest.raises(ValueError, match="N <= 128"):
        ssd_scan(x, dt, bm, cm, a)


@pytest.mark.cuda
def test_reduced_zamba2_serves_the_same_tokens_on_the_card_and_the_cpu(
        cuda):
    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Request, ServeEngine
    cfg = get_config("zamba2-7b").reduced()
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    rng = np.random.default_rng(4)
    reqs = [Request(i, rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=6) for i, n in enumerate((128, 256, 128))]
    out = {}
    for dev, p in (("cuda", params), ("cpu", to_cpu(params))):
        reset_launch_counts()
        eng = ServeEngine(model, p, max_batch=2, max_seq=512, device=dev)
        out[dev] = [c.tokens.tolist() for c in eng.serve(reqs)]
        if dev == "cuda":
            torch.cuda.synchronize()
            # 2 batches: 2 shared-block and 2 Mamba2 layers each, 5 steps
            assert KERNEL_LAUNCHES["flash_attention"] == 4
            assert KERNEL_LAUNCHES["ssd_scan"] == 4
            assert KERNEL_LAUNCHES["flash_decode"] == 2 * 2 * 5
    assert out["cuda"] == out["cpu"]


@pytest.mark.cuda
def test_gumbel_draws_on_the_card_are_the_host_bits(cuda):
    """The serving sampler's Gumbel noise drawn on the card is bit for bit
    the host's (and so JAX's) at the full vocabulary's width."""
    from repro_torch.core import prng, prng_device
    for seed in (0, 3, 2**31 - 1):
        key = prng.split(prng.prng_key(seed))[1]
        u = prng.uniform(key, (8, 32256), prng_device.F32_TINY, 1.0)
        want = -prng.log_f32(-prng.log_f32(u))
        got = prng_device.gumbel(key, (8, 32256), cuda)
        assert np.array_equal(got.cpu().numpy(), want)


# K4's backward (the autograd Function that training calls) against the
# plain backward, with chip_smoke.py's check: fp32 and bf16, causal and
# not, kv_len = S and S - 37, a repeat bitwise, the training forward's
# output bitwise the serving kernel's and the serving call launching the
# original kernel. The reference's test shapes, G = 6 and 8, the training
# shapes of granite-3-2b, phi3.5-moe and internvl2-26b at full width, and a
# ragged S with D = 32
@pytest.mark.cuda
@pytest.mark.parametrize("shape", K4_BWD_SHAPES + [
    (8, 256, 32, 8, 64), (2, 256, 32, 8, 128), (2, 512, 48, 8, 128),
    (3, 200, 4, 1, 32)])
def test_flash_attention_backward_matches_the_plain_backward(cuda, shape):
    check_k4_backward([shape])


@pytest.mark.cuda
def test_a_train_step_on_the_card_runs_k4_and_its_backward(cuda):
    """One reduced granite-3-2b step under remat "block": K4's training
    forward twice per layer, each backward kernel once, and the step's
    loss and gradient norm within 1e-5 of the CPU's from the same
    parameters."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step
    from repro_torch.utils.misc import tree_map
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(),
                              remat="block")
    base = build_model(cfg).init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))
    out = {}
    for dev in ("cpu", cuda):
        params = tree_map(lambda t: t.clone().to(dev), base)
        opt = make_optimizer("adamw")
        before = {k: KERNEL_LAUNCHES[k] for k in (
            "flash_attention_lse", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkdv")}
        m, _, _ = make_train_step(cfg, opt)(params, opt.init(params),
                                            {"tokens": toks.to(dev)})
        out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]))
        moved = {k: KERNEL_LAUNCHES[k] - v for k, v in before.items()}
    assert moved == {"flash_attention_lse": 2 * cfg.n_layers,
                     "flash_attention_bwd_dq": cfg.n_layers,
                     "flash_attention_bwd_dkdv": cfg.n_layers}
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-5)


# K6's backward through its autograd Function against the plain backward
# in fp64, with chip_smoke.py's check: fp32 and bf16, with and without a
# gradient of the final state, on the strided slices of one tensor, a
# repeat bitwise, the gradients in the inputs' types. The reference's scan
# test shapes, the training shapes of mamba2-780m and zamba2-7b, and a
# ragged S with N = 48 and Q = 32
@pytest.mark.cuda
@pytest.mark.parametrize("shape", K6_BWD_SHAPES + [(3, 5, 77, 32, 48, 32)])
def test_ssd_scan_backward_matches_the_plain_backward(cuda, shape):
    check_k6_backward([shape])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b"])
def test_a_train_step_on_the_card_runs_k6_and_its_backward(cuda, arch):
    """One reduced step under remat "block": K6's forward twice per Mamba2
    layer, its backward once, and the step's loss and gradient norm
    within 1e-5 of the CPU's from the same parameters."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step
    from repro_torch.utils.misc import tree_map
    cfg = dataclasses.replace(get_config(arch).reduced(), remat="block")
    base = build_model(cfg).init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 256)).astype(np.int32))
    out = {}
    for dev in ("cpu", cuda):
        params = tree_map(lambda t: t.clone().to(dev), base)
        opt = make_optimizer("adamw")
        before = {k: KERNEL_LAUNCHES[k] for k in ("ssd_scan", "ssd_scan_bwd")}
        m, _, _ = make_train_step(cfg, opt)(params, opt.init(params),
                                            {"tokens": toks.to(dev)})
        out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]))
        moved = {k: KERNEL_LAUNCHES[k] - v for k, v in before.items()}
    assert moved == {"ssd_scan": 2 * cfg.n_ssm_layers(),
                     "ssd_scan_bwd": cfg.n_ssm_layers()}
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-5)
