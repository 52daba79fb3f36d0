"""Plain PyTorch version of the fused ensemble-MLP forward."""
from __future__ import annotations

import torch


def ensemble_mlp_ref(x, w1, b1, w2, b2):
    """x (M,T,d), w1 (M,d,h), b1 (M,h), w2 (M,h,1), b2 (M,1) -> (M,T)."""
    hid = torch.tanh(torch.einsum("mtd,mdh->mth", x, w1) + b1[:, None, :])
    out = torch.einsum("mth,mho->mto", hid, w2)
    return out[..., 0] + b2.reshape(-1, 1)
