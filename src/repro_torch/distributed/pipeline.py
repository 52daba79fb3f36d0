"""Pipeline parallelism: the GPipe schedule over a "stage" process group.

The reference's ``repro/distributed/pipeline.py`` on torch, with
point-to-point sends in place of ``shard_map`` + ``collective_permute``.
Layers are split into S stages laid out on the mesh's ``axis``, one stage
per rank; microbatches stream through with one shift per tick (T = M + S -
1 ticks in all). Every rank runs every tick, as the reference's scan does:
stage 0 takes microbatch t, the others the activation the stage before
them sent, and each sends its output one stage on. Only the last stage's
outputs are kept, then summed over the group with zeros elsewhere (the
reference's ``psum``), so every rank returns them.

The schedule is the textbook fill-drain GPipe: bubble fraction
(S - 1) / (M + S - 1); choose M >= 4 S to keep it under 20%.
"""
from __future__ import annotations

import torch

from repro_torch.utils.misc import tree_map


def pipeline_apply(stage_fn, stage_params, x_microbatches, *, mesh,
                   axis: str = "stage"):
    """Run microbatches through S pipeline stages.

    stage_fn:          (params_one_stage, x (mb, d)) -> (mb, d)
    stage_params:      tree stacked on the leading STAGE dim (S, ...): this
                       rank takes its stage's slice (or, for DTensors
                       sharded over ``axis``, its local shard)
    x_microbatches:    (M, mb, d), the same on every rank
    Returns (M, mb, d) outputs after all S stages, on every rank.
    """
    import torch.distributed as dist
    group = mesh.get_group(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    stage = mesh.get_local_rank(axis)
    m, mb, d = x_microbatches.shape
    ticks = m + n_stages - 1

    def mine(a):
        if hasattr(a, "to_local"):
            return a.to_local()[0]
        return a[stage]
    params_here = tree_map(mine, stage_params)
    nxt = dist.get_global_rank(group, stage + 1) \
        if stage + 1 < n_stages else None
    prev = dist.get_global_rank(group, stage - 1) if stage > 0 else None

    buf = torch.zeros((mb, d), dtype=x_microbatches.dtype,
                      device=x_microbatches.device)
    out = torch.zeros((m, mb, d), dtype=x_microbatches.dtype,
                      device=x_microbatches.device)
    for t in range(ticks):
        # stage 0 ingests microbatch t (a repeat past M; never kept)
        x_in = x_microbatches[min(t, m - 1)] if stage == 0 else buf
        y = stage_fn(params_here, x_in)
        # the last stage retires microbatch t - S + 1
        if stage == n_stages - 1 and t >= n_stages - 1:
            out[t - (n_stages - 1)] = y
        # shift activations one stage down the line
        ops = []
        if nxt is not None:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), nxt, group))
        if prev is not None:
            buf = torch.empty_like(buf)
            ops.append(dist.P2POp(dist.irecv, buf, prev, group))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
    # only the last stage holds real outputs; share them by a sum
    if stage != n_stages - 1:
        out.zero_()
    dist.all_reduce(out, group=group)
    return out


def split_stages(layer_params, n_stages: int):
    """Reshape (L, ...)-stacked layer params into (S, L/S, ...) stages."""
    def one(a):
        l = a.shape[0]
        assert l % n_stages == 0, (l, n_stages)
        return a.reshape(n_stages, l // n_stages, *a.shape[1:])

    return tree_map(one, layer_params)


def make_stage_fn(layer_fn):
    """Stage = sequential application of this stage's layer slice."""
    def stage_fn(stage_params, x):
        leaf = stage_params
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        h = x
        for i in range(leaf.shape[0]):
            h = layer_fn(tree_map(lambda a: a[i], stage_params), h)
        return h

    return stage_fn
