"""Optimizers: AdamW (default) and Adafactor (memory-lean option for the
largest MoE cells), the reference's (``repro/train/optimizer.py``) on
tensors.

States keep the reference's trees, leaf names and types: AdamW
``{"m", "v", "step"}`` with fp32 moments shaped as the parameters;
Adafactor ``{"vr", "vc", "step"}`` with the row factors (the last axis
averaged away) and the column factors (the second last), and for a leaf
of at most one dimension its full second moment in ``vr`` and a
zero-size placeholder in ``vc``; ``step`` a 0-d int32. So
``tree_bytes`` of a state, and a checkpoint of it, are the reference's.

An update follows the reference's arithmetic operation for operation,
the bias corrections in fp32 from the int32 step (``b1 ** step`` as
``float32``). It writes the new values into the parameter and state
tensors in place and returns them, where JAX returns new arrays: holding
both would cost one more copy of the parameters and moments (31.6 GB at
granite-3-2b's full width). AdamW's update is elementwise, so it runs one
layer of a stacked leaf at a time and its temporaries stay one layer
large; Adafactor's needs a whole leaf's RMS and runs leaf by leaf.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.misc import tree_map


class OptimizerDef(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]   # (grads, state, params) -> ...
    name: str


def _device(tree):
    for v in tree.values():
        return _device(v) if isinstance(v, dict) else v.device
    raise ValueError("empty parameter tree")


def _slices(*ts):
    """Views of ``ts`` one layer at a time for a stacked (>= 3-D) leaf,
    else the whole tensors."""
    if ts[0].dim() >= 3:
        return zip(*(t.unbind(0) for t in ts))
    return [ts]


# ---------------------------------------------------------------- AdamW
def adamw_init(params):
    moments = tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
    return {"m": moments, "v": tree_map(torch.zeros_like, moments),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_device(params))}


@torch.no_grad()
def adamw_update(grads, state, params, *, lr=3e-4, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1):
    step = state["step"] + 1
    stepf = step.float()
    b1c = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=step.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=step.device), stepf)

    def upd(p, g, m, v):
        for ps, gs, ms, vs in _slices(p, g, m, v):
            g32 = gs.float()
            m_new = b1 * ms + (1 - b1) * g32
            v_new = b2 * vs + (1 - b2) * g32 * g32
            u = (m_new / b1c) / (torch.sqrt(v_new / b2c) + eps)
            p32 = ps.float()
            p32 = p32 - lr * (u + weight_decay * p32)
            ms.copy_(m_new)
            vs.copy_(v_new)
            ps.copy_(p32)
        return p

    tree_map(upd, params, grads, state["m"], state["v"])
    return params, {"m": state["m"], "v": state["v"], "step": step}


# ------------------------------------------------------------- Adafactor
def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params):
    """Factored state: two parallel trees (vr over rows, vc over cols);
    unfactored (<=1D) leaves keep a full second moment in ``vr`` and a
    zero-size placeholder in ``vc`` (keeps tree structures identical)."""
    def vr_of(p):
        return torch.zeros(p.shape[:-1] if _factored(p.shape) else p.shape,
                           dtype=torch.float32, device=p.device)

    def vc_of(p):
        return torch.zeros((*p.shape[:-2], p.shape[-1])
                           if _factored(p.shape) else (0,),
                           dtype=torch.float32, device=p.device)

    return {"vr": tree_map(vr_of, params), "vc": tree_map(vc_of, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_device(params))}


@torch.no_grad()
def adafactor_update(grads, state, params, *, lr=3e-4, decay=0.8,
                     eps=1e-30, clip=1.0, weight_decay=0.0):
    step = state["step"] + 1
    beta = 1.0 - step.float() ** -decay

    def upd(p, g, vr, vc):
        g32 = g.float()
        g2 = g32 * g32 + eps
        if _factored(p.shape):
            vr_new = beta * vr + (1 - beta) * torch.mean(g2, dim=-1)
            vc_new = beta * vc + (1 - beta) * torch.mean(g2, dim=-2)
            denom = torch.clamp_min(torch.mean(vr_new, -1, keepdim=True), eps)
            u = g32 * torch.rsqrt(vr_new / denom)[..., None] \
                * torch.rsqrt(vc_new[..., None, :])
            vc.copy_(vc_new)
        else:
            vr_new = beta * vr + (1 - beta) * g2
            u = g32 * torch.rsqrt(vr_new)
        vr.copy_(vr_new)
        # update clipping (RMS <= clip)
        rms = torch.sqrt(torch.mean(u * u) + 1e-12)
        u = u / torch.clamp_min(rms / clip, 1.0)
        p32 = p.float() - lr * (u + weight_decay * p.float())
        p.copy_(p32)
        return p

    tree_map(upd, params, grads, state["vr"], state["vc"])
    return params, {"vr": state["vr"], "vc": state["vc"], "step": step}


def make_optimizer(name: str, **hyper) -> OptimizerDef:
    if name == "adamw":
        return OptimizerDef(adamw_init,
                            functools.partial(adamw_update, **hyper),
                            "adamw")
    if name == "adafactor":
        return OptimizerDef(adafactor_init,
                            functools.partial(adafactor_update, **hyper),
                            "adafactor")
    raise ValueError(f"unknown optimizer {name!r}")
