"""Mamba2 blocks via SSD, state-space duality (arXiv:2405.21060).

The prefill path runs the chunked SSD scan through the SSD-scan kernel
(K6, ``kernels.ssd_scan``): the CUDA kernel for tensors on the card, its
plain chunked version on the CPU. Like the reference's ``_ssd_chunked``
(``repro/models/ssm.py``) it returns the final (B, H, P, N) state that
seeds decode. Decode keeps an O(1) recurrent state and runs one token's
recurrence in plain tensor code (the reference has no kernel there).

Layout: d_inner = expand * d_model, split into H = d_inner / P heads of
width P; B and C are shared across heads (ngroups = 1); A is a scalar per
head. The SSD runs in fp32 and casts back to the compute type.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tp
from repro_torch.distributed.sharding import shard
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.layers import INIT_STD, as_type, dense_init

CHUNK = 128


def ssm_params(gen, cfg: ModelConfig, dtype, n: tuple = ()):
    """Mamba2 weights, with a leading stack of shape ``n``."""
    d, di, ns, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * ns
    dev = gen.device
    return {
        "in_proj": dense_init(gen, (*n, d, 2 * di + 2 * ns + h), dtype),
        "conv_w": dense_init(gen, (*n, cfg.ssm_conv, conv_ch), dtype,
                             std=0.1),
        "conv_b": torch.zeros((*n, conv_ch), dtype=dtype, device=dev),
        "a_log": torch.zeros((*n, h), dtype=torch.float32, device=dev),
        "dt_bias": torch.full((*n, h), -2.0, dtype=torch.float32,
                              device=dev),
        "ssm_d": torch.ones((*n, h), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones((*n, di), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (*n, di, d), dtype,
                               std=INIT_STD / (2 * max(cfg.n_layers, 1))
                               ** 0.5),
    }


def _split_proj(params, x, di: int, n: int):
    """x (B, S, d) -> z (B, S, di), xBC (B, S, di + 2N), dt (B, S, H)."""
    zxbcdt = x @ as_type(params["in_proj"], x.dtype)
    return (zxbcdt[..., :di], zxbcdt[..., di: 2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


def _causal_conv(params, xbc, cfg: ModelConfig):
    """Depthwise causal convolution of width K (the prefill path)."""
    k = cfg.ssm_conv
    w = as_type(params["conv_w"], xbc.dtype)                 # (K, C)
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    s = xbc.shape[1]
    y = pad[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        y = y + pad[:, i: i + s, :] * w[i][None, None, :]
    return F.silu(y + as_type(params["conv_b"], xbc.dtype))


def ssm_block(params, x, cfg: ModelConfig, return_cache: bool = False):
    """Full-sequence Mamba2 block body, x (B, S, d) -> (B, S, d).

    With ``return_cache`` also returns (final_state (B, H, P, N) fp32,
    conv_tail (B, K-1, C)) to seed decode after a prefill.

    Under TP (``distributed.tp``) the rank computes its heads: its z, x
    and dt columns of ``in_proj`` and all of B and C (``tp.ssm_shard``),
    K6 on its heads, the gated norm's sum of squares over "model", and
    ``out_proj`` row-parallel. Under ``cfg.seq_shard`` ``x`` and the
    output are the rank's slice of the sequence: gathered before
    ``in_proj`` (the convolution and the scan run over all of it), the
    output reduce-scattered.
    """
    x = tp.copy_to_tp(x, cfg.seq_shard)
    b, s, _ = x.shape
    n, p = cfg.ssm_state, cfg.ssm_head_dim
    params, h = tp.ssm_shard(params, cfg.d_inner, n, cfg.ssm_heads)
    di = cfg.d_inner // tp.model_size()
    cd = x.dtype
    q = min(CHUNK, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")

    z, xbc_raw, dt = _split_proj(params, x, di, n)
    xbc = _causal_conv(params, xbc_raw, cfg)
    xc, bmat, cmat = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + params["dt_bias"][None, None, :])
    a = -torch.exp(params["a_log"])

    xh = xc.reshape(b, s, h, p)
    xh = shard(xh, ("batch", None, "ssm_heads", None))
    y, final_state = ssd_scan(xh, dt, bmat, cmat, a, q_chunk=q)
    y = y + params["ssm_d"][None, None, :, None] * xh.float()
    y = y.reshape(b, s, di).to(cd)

    y = tp.rmsnorm(y * F.silu(z), params["norm_scale"])
    out = tp.reduce_from_tp(y @ as_type(params["out_proj"], cd),
                            cfg.seq_shard)
    if return_cache:
        return out, final_state, xbc_raw[:, s - (cfg.ssm_conv - 1):, :]
    return out


# ------------------------------------------------------------------ decode
def ssm_cache_init(cfg: ModelConfig, batch: int, n_layers: int, dtype,
                   device):
    """Recurrent decode state for ``n_layers`` SSM layers; under TP this
    rank's heads of the state and its chunk of the convolution tail's
    channels (``cache_specs``' layout)."""
    di, n = cfg.d_inner, cfg.ssm_state
    return {
        "state": torch.zeros((n_layers, batch,
                              cfg.ssm_heads // tp.model_size(),
                              cfg.ssm_head_dim, n), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((n_layers, batch, cfg.ssm_conv - 1,
                             tp.chunk_width(di + 2 * n)),
                            dtype=dtype, device=device),
    }


def ssm_decode_block(params, x, cfg: ModelConfig, state, conv_state):
    """One-token step. x (B, 1, d); state (B, H, P, N); conv (B, K-1, C).
    Returns (out (B, 1, d), state', conv_state').

    Under TP the rank steps its heads, as ``ssm_block`` computes them
    (``tp.ssm_shard``), on its heads of the state; the cached tail is its
    chunk of the channels, from which it takes the channels it computes
    and to which it returns the step's new values (``tp.conv_from_cache``,
    ``tp.conv_step``)."""
    b = x.shape[0]
    n, p = cfg.ssm_state, cfg.ssm_head_dim
    params, h = tp.ssm_shard(params, cfg.d_inner, n, cfg.ssm_heads)
    di = cfg.d_inner // tp.model_size()
    cd = x.dtype

    z, xbc, dt = _split_proj(params, tp.copy_to_tp(x), di, n)  # (B, 1, *)
    xbc = xbc.to(conv_state.dtype)
    tail = tp.conv_from_cache(conv_state, cfg.d_inner, n)
    window = torch.cat([tail, xbc], 1)
    w = as_type(params["conv_w"], cd)                        # (K, C)
    conv_out = torch.einsum("bkc,kc->bc", window.to(cd), w) \
        + as_type(params["conv_b"], cd)
    conv_out = F.silu(conv_out)
    new_conv = window[:, 1:, :] if tp.model_size() == 1 else \
        tp.conv_step(conv_state, xbc, cfg.d_inner, n)

    xc, bmat, cmat = (conv_out[:, :di], conv_out[:, di:di + n],
                      conv_out[:, di + n:])
    dt = F.softplus(dt[:, 0].float() + params["dt_bias"][None, :])  # (B, H)
    a = -torch.exp(params["a_log"])
    da = torch.exp(dt * a[None, :])

    xh = xc.reshape(b, h, p).float()
    dtx = xh * dt[..., None]
    state = state * da[..., None, None] \
        + dtx[..., None] * bmat.float()[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", state, cmat.float())
    y = y + params["ssm_d"][None, :, None] * xh
    y = y.reshape(b, 1, di).to(cd)

    y = tp.rmsnorm(y * F.silu(z), params["norm_scale"])
    return (tp.reduce_from_tp(y @ as_type(params["out_proj"], cd)), state,
            new_conv)
