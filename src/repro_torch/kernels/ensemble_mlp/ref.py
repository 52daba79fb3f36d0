"""Plain PyTorch versions of the fused ensemble-MLP forward and of the MLP
model's whole prediction."""
from __future__ import annotations

import torch


def ensemble_mlp_ref(x, w1, b1, w2, b2):
    """x (M,T,d), w1 (M,d,h), b1 (M,h), w2 (M,h,1), b2 (M,1) -> (M,T)."""
    hid = torch.tanh(torch.einsum("mtd,mdh->mth", x, w1) + b1[:, None, :])
    out = torch.einsum("mth,mho->mto", hid, w2)
    return out[..., 0] + b2.reshape(-1, 1)


def mlp_predict_ref(x, w1, b1, w2, b2, mu_x, sd_x, mu_y, sd_y):
    """x (T,d) -> (T,): the four eager steps around ``ensemble_mlp_ref``,
    as the MLP model's predict took them before the fused entry."""
    xn = ((x - mu_x) / sd_x).contiguous()
    yn = ensemble_mlp_ref(xn[None], w1[None], b1[None], w2[None],
                          b2[None])[0]
    return yn * sd_y + mu_y
