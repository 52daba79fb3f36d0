"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one (a CUDA
kernel has no CPU mode); on the GPU run ``pytest -m cuda
tests/test_torch_cuda.py``. Imports nothing of JAX."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import KERNEL_LAUNCHES  # noqa: E402
from repro_torch.kernels.ensemble_mlp.ops import ensemble_mlp_forward  # noqa: E402
from repro_torch.kernels.ensemble_mlp.ref import ensemble_mlp_ref  # noqa: E402
from repro_torch.kernels.knn.ops import knn_predict, pairwise_sq_dists  # noqa: E402
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


@pytest.mark.cuda
def test_wrappers_refuse_non_contiguous_input(cuda):
    x = torch.zeros((1, 4, 2), device=cuda)[:, :, :1]
    with pytest.raises(ValueError):
        ensemble_mlp_forward(x, torch.zeros((1, 1, 8), device=cuda),
                             torch.zeros((1, 8), device=cuda),
                             torch.zeros((1, 8, 1), device=cuda),
                             torch.zeros((1, 1), device=cuda))
