"""Fused train step: grad (+ optional microbatch accumulation, gradient
clipping, gradient compression hook) + optimizer update.

The reference's ``make_train_step`` (``repro/train/step.py``): autograd
takes the place of ``jax.value_and_grad`` and a loop the place of the
microbatch ``lax.scan``, adding each microbatch's loss and gradients in
the scan's order in fp32 and scaling by ``1 / microbatches`` after.

On a CUDA device the gradient of attention comes from K4's backward
kernel. K6 (the Mamba2 scan) has none yet, so the ``ssm`` and ``hybrid``
families train only on the CPU: on the card the step raises (ROADMAP
queue 1: K6's backward, then ``ssm``/``hybrid`` training on the card).
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import loss_fn
from repro_torch.train.optimizer import OptimizerDef
from repro_torch.utils.misc import (tree_flatten_with_path, tree_map,
                                    tree_unflatten)

NO_BACKWARD_ON_CUDA = ("ssm", "hybrid")


def check_trainable(cfg: ModelConfig, device) -> None:
    """Raise for a family whose kernels have no backward on ``device``."""
    if torch.device(device).type == "cuda" \
            and cfg.family in NO_BACKWARD_ON_CUDA:
        raise NotImplementedError(
            f"family {cfg.family!r} does not train on a CUDA device yet: "
            f"K6 (ssd_scan) has no backward kernel (ROADMAP queue 1, "
            f"'K6 backward, then ssm/hybrid training on the card'); train "
            f"it with device='cpu'")


def _clip_by_global_norm(grads, max_norm: float):
    """The reference's clip, written into the gradients in place (they are
    the step's own tensors), so no second copy of them is held."""
    _, leaves = tree_flatten_with_path(grads)
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp_min(gnorm, 1e-6), max=1.0)
    for g in leaves:
        g.copy_(g * scale)
    return grads, gnorm


def _value_and_grad(loss, params, batch):
    """(loss, gradient tree) of ``loss(params, batch)`` by autograd."""
    leaf = tree_map(lambda p: p.detach().requires_grad_(), params)
    _, ps = tree_flatten_with_path(leaf)
    with torch.enable_grad():
        value = loss(leaf, batch)
        grads = torch.autograd.grad(value, ps, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(ps, grads)]
    return value.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, opt: OptimizerDef,
                    *, microbatches: int = 1, max_grad_norm: float = 1.0,
                    grad_transform: Callable | None = None):
    """Build train_step(params, opt_state, batch) -> (metrics, params, opt).

    ``microbatches`` > 1 accumulates gradients over equal splits of the
    leading batch dim (activation memory / throughput knob).
    ``grad_transform`` hooks in gradient compression (train/compression.py).
    The optimizer updates ``params`` and ``opt_state`` in place.
    """
    loss = functools.partial(loss_fn, cfg=cfg)

    def grads_of(params, batch):
        if microbatches == 1:
            return _value_and_grad(loss, params, batch)

        def split(x):
            b = x.shape[0]
            assert b % microbatches == 0
            return x.reshape(microbatches, b // microbatches, *x.shape[1:])

        micro = {k: split(v) for k, v in batch.items()}
        acc_l = torch.zeros((), dtype=torch.float32,
                            device=batch["tokens"].device)
        acc_g = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        for i in range(microbatches):
            l, g = _value_and_grad(loss, params,
                                   {k: v[i] for k, v in micro.items()})
            acc_l = acc_l + l
            acc_g = tree_map(torch.add, acc_g, g)
        inv = 1.0 / microbatches
        return acc_l * inv, tree_map(lambda x: x * inv, acc_g)

    def train_step(params, opt_state, batch):
        _, leaves = tree_flatten_with_path(params)
        check_trainable(cfg, leaves[0].device)
        l, grads = grads_of(params, batch)
        grads, gnorm = _clip_by_global_norm(grads, max_grad_norm)
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state = opt.update(grads, opt_state, params)
        metrics = {"loss": l, "grad_norm": gnorm}
        return metrics, params, opt_state

    return train_step
