"""Fused train step: grad (+ optional microbatch accumulation, gradient
clipping, gradient compression hook) + optimizer update.

The reference's ``make_train_step`` (``repro/train/step.py``): autograd
takes the place of ``jax.value_and_grad`` and a loop the place of the
microbatch ``lax.scan``, adding each microbatch's loss and gradients in
the scan's order in fp32 and scaling by ``1 / microbatches`` after.

On a CUDA device the gradients of attention and of the Mamba2 scan come
from the backward kernels of K4 and K6 (each an autograd Function).

With a ``mesh`` (a ``DeviceMesh`` with the reference's axes, see
``distributed.sharding``) the step computes as the reference's GSPMD
layout does: ``params`` are DTensors placed by ``param_specs`` (every
weight spread over the FSDP axes and "model"), ``batch`` DTensors placed
by ``batch_specs`` (the batch over the FSDP axes), and ``opt_state`` the
optimizer's state of the local shards (``opt.init(local_tree(params))``).
The loss and gradients run through ``local_map`` on each parameter's own
shard and this rank's batch shard, under ``distributed.tp.sharded``: each
layer gathers its weights' FSDP dims only while it runs (and again for its
backward, whose reduce-scatter hands each shard its gradient summed over
the FSDP ranks), and the blocks compute tensor-parallel over "model"
(each rank its own heads, ``ff`` columns, experts' ``ff`` columns, vocab
slice and Mamba2 heads; ``distributed.tp``). No rank holds a whole
weight that ``param_specs`` shards. Each rank's loss and gradients are
scaled by 1 / (FSDP ranks); the gradients come back as the shards' own,
in the weights' placements. The clip takes the global norm over the
local shards (each counted once over the ranks that hold a copy) and
scales them, and the optimizer updates each rank's shards in place: no
DTensor op touches a whole weight's shape. Needs an elementwise optimizer
(AdamW) and takes no ``grad_transform``; on a one-device mesh every
number is the unsharded step's.
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


def _clip_by_global_norm(grads, max_norm: float, mesh=None):
    """The reference's clip, written into the gradients in place (they are
    the step's own tensors), so no second copy of them is held. With a
    ``mesh`` the gradients are DTensors, clipped on their local shards:
    each shard's sum of squares over the ranks that hold a copy of it,
    summed over the mesh (``tp.mesh_sum``)."""
    _, leaves = tree_flatten_with_path(grads)
    if mesh is None:
        gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))
    else:
        from repro_torch.distributed import tp
        gnorm = torch.sqrt(tp.mesh_sum(sum(
            torch.sum(g.to_local().float() ** 2) / tp.copies(g)
            for g in leaves), mesh))
        leaves = [g.to_local() for g in leaves]
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


def _sharded(grads_of, mesh):
    """``grads_of`` over DTensors: run on each parameter's local shard and
    this rank's batch shard through ``local_map``, under
    ``tp.sharded(mesh)``; the gradients come back in the parameters'
    placements."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    from torch.utils import _pytree as pytree

    from repro_torch.distributed import tp
    from repro_torch.distributed.sharding import (FSDP_AXES, axis_names,
                                                  batch_specs, param_specs,
                                                  placements)
    names = axis_names(mesh)
    fsdp = [i for i, a in enumerate(names) if a in FSDP_AXES]
    ranks = 1
    for i in fsdp:
        ranks *= mesh.size(i)
    summed = tuple(Partial() if i in fsdp else Replicate()
                   for i in range(len(names)))

    def local(params, batch):
        with tp.sharded(mesh):
            l, g = grads_of(params, batch)
        # in the parameters' key order, which the placements follow
        return l / ranks, tree_map(lambda _, t: t / ranks, params, g)

    def run(params, batch):
        leaves = pytree.tree_leaves(params)
        p_place = tuple(tuple(t.placements) for t in leaves)
        want = tuple(placements(s, mesh, t.ndim) for s, t in zip(
            pytree.tree_leaves(param_specs(params, mesh),
                               is_leaf=lambda x: isinstance(x, tuple)),
            leaves))
        if p_place != want:
            raise ValueError("the sharded step takes parameters placed by "
                             "param_specs")
        b_place = [placements(s, mesh) for s in pytree.tree_leaves(
            batch_specs(batch, mesh),
            is_leaf=lambda x: isinstance(x, tuple))]
        fn = local_map(local, out_placements=(summed,) + p_place,
                       in_placements=p_place + tuple(b_place),
                       device_mesh=mesh, redistribute_inputs=True)
        l, grads = fn(params, batch)
        return l.full_tensor(), grads

    return run


def make_train_step(cfg: ModelConfig, opt: OptimizerDef,
                    *, microbatches: int = 1, max_grad_norm: float = 1.0,
                    grad_transform: Callable | None = None, mesh=None):
    """Build train_step(params, opt_state, batch) -> (metrics, params, opt).

    ``microbatches`` > 1 accumulates gradients over equal splits of the
    leading batch dim (activation memory / throughput knob).
    ``grad_transform`` hooks in gradient compression (train/compression.py).
    The optimizer updates ``params`` and ``opt_state`` in place. With a
    ``mesh``, the ZeRO-3 step over DTensors of the module's docstring.
    """
    if mesh is not None and (opt.name != "adamw"
                             or grad_transform is not None):
        raise ValueError(f"a sharded step updates each rank's shards alone, "
                         f"and under tensor parallelism a shard holds only "
                         f"a slice of a row or column: it takes an "
                         f"elementwise optimizer (adamw, not {opt.name}) and "
                         f"no grad_transform")
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

    if mesh is not None:
        grads_of = _sharded(grads_of, mesh)

    def train_step(params, opt_state, batch):
        l, grads = grads_of(params, batch)
        grads, gnorm = _clip_by_global_norm(grads, max_grad_norm, mesh)
        if grad_transform is not None:
            grads = grad_transform(grads)
        if mesh is None:
            params, opt_state = opt.update(grads, opt_state, params)
        else:
            from repro_torch.distributed.sharding import local_tree
            _, opt_state = opt.update(local_tree(grads), opt_state,
                                      local_tree(params))
        metrics = {"loss": l, "grad_norm": gnorm}
        return metrics, params, opt_state

    return train_step
