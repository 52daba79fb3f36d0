"""The work of K4, K5 and K6, counted once for their bounds and the dry run.

Each ``*_work`` function returns the bytes a launch must move (each input
read once, each output written once) and the FLOPs of its products; the
``*_bound`` functions turn them into the least time (ms) an H100 could
take, the larger of the bytes over the HBM rate and the operations over
the peak rate for their type. ``chip_smoke.py`` times the kernels against
these bounds, and the kernels' FLOP formulas (registered beside each
launch for ``torch.utils.flop_counter``) count these FLOPs, so a dry run's
compute term and a kernel's bound read one count.

Each product is counted once. K6's bf16 kernel runs every product with
an fp32 operand as three bf16 passes (hi, mid, lo); that is a cost of the
implementation, not model work, and only ``k6_bound`` applies it.
"""
from __future__ import annotations

from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16

# fp32 FMA rate outside the tensor cores (NVIDIA H100 SXM data sheet, at
# the 700 W power limit)
PEAK_FLOPS_FP32 = 67e12


def bound_at(nbytes, flops, rate):
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and ``flops`` over ``rate``."""
    by_bytes = 1e3 * nbytes / HBM_BW
    by_ops = 1e3 * flops / rate
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def attention_pairs(s: int, kv_len: int, causal: bool) -> int:
    """The (query, key) pairs of one head: below the diagonal and under
    ``kv_len`` when causal (the tiles above it are skipped), else every
    key under ``kv_len``."""
    if not causal:
        return s * kv_len
    return kv_len * (kv_len + 1) // 2 + (s - kv_len) * kv_len


def k4_work(b, s, h, hkv, d, itemsize, causal=True, kv_len=None):
    """K4's forward: q, k, v read and out written once; Q.K^T and P.V over
    the pairs."""
    pairs = attention_pairs(s, s if kv_len is None else kv_len, causal)
    nbytes = itemsize * (2 * b * s * h * d + 2 * b * s * hkv * d)
    return nbytes, 4 * b * h * pairs * d


def k4_bound(b, s, h, hkv, d, itemsize):
    """K4 causal over all keys, at the bf16 tensor rate."""
    return bound_at(*k4_work(b, s, h, hkv, d, itemsize), PEAK_FLOPS_BF16)


def k4_bwd_work(b, s, h, hkv, d, itemsize, causal=True, kv_len=None):
    """K4's backward: q, k, v, o, dO and lse read once, dq, dk and dv
    written once; 2.5 times the forward's products over the pairs."""
    pairs = attention_pairs(s, s if kv_len is None else kv_len, causal)
    nbytes = itemsize * (3 * b * s * h * d + 2 * b * s * hkv * d) \
        + 4 * b * h * s + itemsize * (b * s * h * d + 2 * b * s * hkv * d)
    return nbytes, 10 * b * h * pairs * d


def k4_bwd_bound(b, s, h, hkv, d, itemsize):
    return bound_at(*k4_bwd_work(b, s, h, hkv, d, itemsize),
                    PEAK_FLOPS_BF16)


def k5_work(b, h, hkv, d, live, itemsize, cache_itemsize=None,
            lse=False):
    """K5: the ``live`` cache positions of K and V read once (in the
    cache's type, ``cache_itemsize``: 1 for an e4m3 cache), q read and out
    written (with ``lse``, the log-sum-exp variant's fp32 output and one
    fp32 log-sum-exp a row); a dot and a multiply-add per live value."""
    cache_itemsize = itemsize if cache_itemsize is None else cache_itemsize
    out = 4 * (b * h * d + b * h) if lse else itemsize * b * h * d
    nbytes = cache_itemsize * 2 * b * live * hkv * d + itemsize * b * h * d \
        + out
    return nbytes, 4 * b * h * live * d


def k5_bound(b, h, hkv, d, pos, itemsize):
    """K5 at ``pos``, the last live position, at the bf16 tensor rate."""
    return bound_at(*k5_work(b, h, hkv, d, pos + 1, itemsize),
                    PEAK_FLOPS_BF16)


def k6_work(b, h, s, p, n, q, itemsize):
    """K6: x, B and C (compute type), dt, a read once; y and the state
    written (fp32). Per (b, chunk) C.B^T over the causal pairs (shared by
    the heads); per (b, h, chunk) M.xs over the causal pairs, C.state and
    the state update. Returns (bytes, the products' FLOPs, the FLOPs of
    the products with an fp32 operand)."""
    nc = -(-s // q)
    pairs = q * (q + 1) // 2
    shared = 2 * b * nc * pairs * n
    per_head = 2 * b * nc * h * (pairs * p + 2 * q * p * n)
    nbytes = itemsize * (b * s * h * p + 2 * b * s * n) + 4 * (b * s * h + h) \
        + 4 * (b * s * h * p + b * h * p * n)
    return nbytes, shared + per_head, per_head


def k6_bound(b, h, s, p, n, q, itemsize):
    """At the route's rates: bf16 on the tensor cores, where C.B^T takes
    one pass and each product with an fp32 operand (M, the state, x w dt)
    three; fp32 on the CUDA cores."""
    nbytes, flops, fp32_op = k6_work(b, h, s, p, n, q, itemsize)
    if itemsize == 2:
        return bound_at(nbytes, flops + 2 * fp32_op, PEAK_FLOPS_BF16)
    return bound_at(nbytes, flops, PEAK_FLOPS_FP32)


def k6_bound_fp32_rate(b, h, s, p, n, q, itemsize):
    """The products at the fp32 CUDA-core rate."""
    nbytes, flops, _ = k6_work(b, h, s, p, n, q, itemsize)
    return bound_at(nbytes, flops, PEAK_FLOPS_FP32)


def k6_bwd_work(b, h, s, p, n, q, itemsize):
    """K6's backward: x, B and C (compute type), dt, a and dy (fp32) read
    once; dx, dB and dC (compute type), ddt and da (fp32) written once.
    Products: C.B^T over the causal pairs per (b, chunk), shared by the
    heads; per (b, h, chunk) dy.xs^T, M^T.dy, (D o L).B and (D o L)^T.C
    over the causal pairs, and five (Q, P, N) products (the chunk state
    recomputed, dy^T.prev, x^T.dS, B.dS^T and the dS update). Returns
    (bytes, FLOPs, the FLOPs of products with an fp32 operand)."""
    nc = -(-s // q)
    pairs = q * (q + 1) // 2
    shared = 2 * b * nc * pairs * n
    per_head = 2 * b * nc * h * (pairs * (2 * p + 2 * n) + 5 * q * p * n)
    nbytes = itemsize * (2 * b * s * h * p + 4 * b * s * n) \
        + 4 * (2 * b * s * h + 2 * h + b * s * h * p)
    return nbytes, shared + per_head, per_head
