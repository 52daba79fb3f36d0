"""The reference's own spread at the tensor-parallel train tests' inputs.

``tests/test_torch_tp.py`` holds the port's sharded step of each reduced
config (granite-3-2b, phi3.5-moe, mamba2-780m, zamba2-7b; the parameters
of the port's ``init(0)``, tokens (4, 32) from ``default_rng(0)``, AdamW at
lr 3e-4) to the single-device step: the loss, the gradient norm and every
gradient within 1e-6 of the leaf's largest |value|, the parameters after
the AdamW step within 0.05 x lr. Summation order alone moves both: a
gradient element near AdamW's eps turns a 1e-7 difference into a fraction
of lr. This script runs the JAX reference's step (``repro.train.step``)
on the same parameters and tokens, then again with every weight moved one
ulp up and one ulp down (``np.nextafter``), and prints, per config, the
largest relative change of the loss, the gradient norm and any gradient
leaf, and the largest move of a parameter after AdamW in units of lr,
apart for the elements whose gradient is near AdamW's eps (at most
``NEAR_EPS``) and for the others. The test holds the others to 0.05 lr,
and takes twice these numbers where they exceed its other limits.

Run:  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/port_tp_spread.py
"""
from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.train import optimizer as j_opt
from repro.train.step import make_train_step as j_make_train_step

ARCHS = ("granite-3-2b", "phi3.5-moe-42b-a6.6b", "mamba2-780m",
         "zamba2-7b")
LR = 3e-4
# an element's first AdamW update g / (|g| + eps) is the sign of its
# gradient within 1e-3 when |g| exceeds this (eps 1e-8)
NEAR_EPS = 1e3 * 1e-8


def _port_params(arch):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_to_numpy
    from repro_torch.models import build_model
    torch.set_num_threads(1)
    return lm_params_to_numpy(build_model(get_config(arch).reduced()).init(
        0, device="cpu"))


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def spread(arch: str) -> dict:
    cfg = j_get_config(arch).reduced()
    model = j_build_model(cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32))
    batch = {"tokens": jnp.asarray(tokens.astype(np.int32))}
    opt = j_opt.make_optimizer("adamw", lr=LR)
    step = jax.jit(j_make_train_step(cfg, opt))
    grad = jax.jit(jax.value_and_grad(model.loss))
    base = _port_params(arch)
    runs = []
    for move in (None, np.inf, -np.inf):
        p = base if move is None else jax.tree_util.tree_map(
            lambda a, m=move: np.nextafter(a, np.float32(m)), base)
        p = jax.tree_util.tree_map(jnp.asarray, p)
        loss, g = grad(p, batch)
        metrics, p2, _ = step(p, opt.init(p), batch)
        runs.append((float(loss), float(metrics["grad_norm"]),
                     _leaves(jax.device_get(g)),
                     _leaves(jax.device_get(p2))))
    (l0, n0, g0, p0), out = runs[0], {"loss": 0.0, "grad_norm": 0.0,
                                      "grads": 0.0, "params_lr_far": 0.0,
                                      "params_lr_near": 0.0}
    near = [np.abs(np.asarray(g, np.float64)) <= NEAR_EPS for g in g0]
    for l1, n1, g1, p1 in runs[1:]:
        out["loss"] = max(out["loss"], abs(l1 - l0) / abs(l0))
        out["grad_norm"] = max(out["grad_norm"], abs(n1 - n0) / abs(n0))
        out["grads"] = max([out["grads"]] + [_rel(a, b)
                                             for a, b in zip(g1, g0)])
        for a, b, n in zip(p1, p0, near):
            moved = np.abs(np.asarray(a, np.float64) - b) / LR
            for key, part in (("params_lr_far", moved[~n]),
                              ("params_lr_near", moved[n])):
                if part.size:
                    out[key] = max(out[key], float(part.max()))
    return out


def main(argv=None) -> None:
    archs = (argv if argv else sys.argv[1:]) or ARCHS
    for arch in archs:
        print(json.dumps({"arch": arch, **spread(arch)}), flush=True)


if __name__ == "__main__":
    main()
