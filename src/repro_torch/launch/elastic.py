"""Elastic scaling: rebuild the mesh from the live ranks and reshard the
training state onto it.

The reference's ``repro/launch/elastic.py`` on process groups. There a
device loss shows as a changed ``jax.devices()``; here the "devices" are
the global ranks of the default group that are still live, and every rank
of the world calls each function (ranks outside a mesh hold empty
shards). The controller picks the largest usable mesh, moves the state
through whole tensors (the reference's pull to the host, which survives
any change of topology) and reshards it. Tested by shrinking and growing
an 8-rank gloo world (8 -> 4 -> 8).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import distribute, param_specs


def _world() -> list[int]:
    import torch.distributed as dist
    return list(range(dist.get_world_size()))


def largest_mesh(devices=None, *, model_axis: int | None = None,
                 device_type: str = "cuda"):
    """Largest ("data", "model") mesh over ``devices`` (global ranks; every
    rank of the world by default). Prefers the widest model axis that
    divides the rank count (capped at 16, the production rules')."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = _world() if devices is None else list(devices)
    n = len(ranks)
    if model_axis is None:
        model_axis = 1
        for m in (16, 8, 4, 2):
            if n % m == 0 and n >= m:
                model_axis = m
                break
    data = n // model_axis
    grid = torch.tensor(ranks[: data * model_axis]).reshape(data, model_axis)
    return DeviceMesh(device_type, grid, mesh_dim_names=("data", "model"))


def _whole(tree):
    """Each DTensor of a state tree as the whole tensor on every rank:
    gathered on its mesh's ranks, then sent from the first of them to the
    rest of the world; other leaves as they are."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    if not isinstance(tree, DTensor):
        return tree
    owners = sorted(tree.device_mesh.mesh.flatten().tolist())
    if dist.get_rank() in owners:
        full = tree.full_tensor()
    else:
        full = torch.empty(tree.shape, dtype=tree.dtype,
                           device=tree.to_local().device)
    dist.broadcast(full, src=owners[0])
    return full


def reshard(tree, mesh, specs=None):
    """A state tree as DTensors on ``mesh`` (a possibly different one)."""
    tree = _whole(tree)
    specs = param_specs(tree, mesh) if specs is None else specs
    return distribute(tree, mesh, specs)


class ElasticController:
    """Watches the live ranks; on a change, rebuilds the mesh and reshards."""

    def __init__(self, state, mesh=None, *, device_type: str = "cuda"):
        self.device_type = device_type
        self.mesh = mesh or largest_mesh(device_type=device_type)
        self.state = reshard(state, self.mesh)
        self.events: list[tuple[int, int]] = []

    def maybe_rescale(self, devices=None) -> bool:
        devices = _world() if devices is None else list(devices)
        if len(devices) == self.mesh.size():
            return False
        old = self.mesh.size()
        self.mesh = largest_mesh(devices, device_type=self.device_type)
        self.state = reshard(self.state, self.mesh)
        self.events.append((old, self.mesh.size()))
        return True
