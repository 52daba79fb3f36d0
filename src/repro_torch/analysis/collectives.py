"""Collective bytes of a traced step, counted as they are dispatched.

The port's counterpart of ``analysis.hlo.collective_bytes``: nothing in
torch produces HLO, so ``CollectiveCounter`` (a ``TorchDispatchMode``)
sums the result bytes of every ``c10d_functional`` collective dispatched
while it is active (the ops that DTensor's redistributions and
``torch.distributed._functional_collectives`` issue, on real or fake
tensors), under the parser's five kinds:

  all_gather_into_tensor -> all-gather      all_reduce -> all-reduce
  reduce_scatter_tensor  -> reduce-scatter  all_to_all_single -> all-to-all
  irecv (point to point) -> collective-permute

A coalesced op counts once, with the bytes of all its results (an HLO
tuple). ``wait_tensor`` completes an op already counted and is skipped,
as the parser skips ``-done``. ``result()`` returns the parser's dict:
``bytes_by_kind``, ``counts`` and ``total_bytes``.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.hlo import COLLECTIVE_KINDS

NAMESPACES = ("_c10d_functional", "c10d_functional")
KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "irecv": "collective-permute",
}


def kind_of(func) -> str | None:
    """The parser's kind of a dispatched op, or None if it is not one of
    the counted collectives."""
    if func.namespace not in NAMESPACES:
        return None
    return KINDS.get(func._opname)


def result_bytes(out) -> int:
    return sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(out)
               if isinstance(t, torch.Tensor))


class CollectiveCounter(TorchDispatchMode):
    """Counts collectives by kind while active. Subclass tensors (DTensor)
    are passed on, so the counter sees the collectives they issue on
    their local tensors."""

    def __init__(self):
        super().__init__()
        self.bytes_by_kind = {k: 0 for k in COLLECTIVE_KINDS}
        self.counts = {k: 0 for k in COLLECTIVE_KINDS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if DTensor in types:
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = kind_of(func)
        if kind is not None:
            self.bytes_by_kind[kind] += result_bytes(out)
            self.counts[kind] += 1
        return out

    def result(self) -> dict:
        return {"bytes_by_kind": dict(self.bytes_by_kind),
                "counts": dict(self.counts),
                "total_bytes": sum(self.bytes_by_kind.values())}

