"""Segment-DP wrappers: checks, the plan, output allocation, the launches.

``fit_cuts`` is what the temporal path's boundary fit computes: the k cut
columns minimising the total over-reservation of a pool's (M, G) profile
history (the reference's ``repro.kernels.segment_dp.ops.fit_cuts``, whose
jitted path is bitwise ``ref.fit_cuts_ref``). ``segment_cost`` is the
reference TPU kernel's own function, the (G+1, G+1) cost matrix with
``inf`` where ``j <= i``. CPU tensors take the plain versions (``ref.py``);
CUDA tensors launch the kernels in ``kernel.cu`` on the current stream.
The reference pads M to a power of two only to bound its compiles; zero
rows cost exactly 0.0, so the kernel runs on the real M.

:func:`plan` sizes the kernel's tiles from one block's shared memory:
``kernel.cu`` reads the same layout from the plan's ``mt`` and ``cap``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import KERNEL_LAUNCHES
from repro_torch.kernels import _build
from repro_torch.kernels.segment_dp.ref import (cost_matrix_plain,
                                                fit_cuts_plain)

NAME = "segment_dp"
MAX_GRID = 1024        # the widest grid the plan is checked for
SMEM_BYTES = 232_448   # an H100 block's shared memory (227 KB)


class Plan(NamedTuple):
    """How ``kernel.cu`` tiles a fit of (M, G) profiles: ``mt`` profiles a
    tile, bands of start columns of at most ``cap`` cost entries
    (``bands`` as (first, end, entries)), and the cost matrix and the back
    pointers in shared memory (``cost_in_smem``) or in device scratch."""
    mt: int
    cap: int
    cost_in_smem: bool
    bands: tuple

    def smem_bytes(self, g: int, k: int, fit: bool = True) -> int:
        """The dynamic shared memory of a launch (``kernel.cu`` computes the
        same): a tile's rows of P and triangles at their strides; for a fit
        also the DP's two rows and, with ``cost_in_smem``, the cost matrix,
        the back pointers taking the tile's place."""
        n = g + 1
        build = 4 * self.mt * tile_floats(g, self.bands)
        if not fit:
            return build
        if self.cost_in_smem:
            return 4 * (n * n + 2 * n) + max(build, 4 * k * n)
        return 4 * 2 * n + build


def tile_floats(g: int, bs: tuple) -> int:
    """One profile's share of the staging area: its row of P and its
    triangle of the largest band, each at an odd stride (``kernel.cu``'s
    ``p_stride`` and ``t_stride``: 32 profiles side by side fall in 32
    banks)."""
    return ((g + 1) | 1) + (max(e for _, _, e in bs) | 1)


def bands(g: int, cap: int) -> tuple:
    """The runs of start columns ``kernel.cu::band_end`` walks: from column
    0, the most rows whose entries (``g - i`` for row i) stay within
    ``cap``, at least one row each."""
    out, i0 = [], 0
    while i0 < g:
        i1, e = i0, 0
        while i1 < g and (i1 == i0 or e + g - i1 <= cap):
            e += g - i1
            i1 += 1
        out.append((i0, i1, e))
        i0 = i1
    return tuple(out)


@functools.lru_cache(maxsize=None)
def plan(m: int, g: int) -> Plan:
    """The tiling of an (M, G) fit, a function of (M, G) only. The cost
    matrix and the back pointers (at k = G) stay in shared memory where
    they fit (G <= 169). The rest of the budget holds a tile: ``mt`` rows
    of P and their triangles, one band of start columns each; one band
    holds every start column while a single profile's triangle fits (G <=
    337), and ``mt`` is as many profiles as fit, at most M."""
    n = g + 1
    in_smem = 4 * (n * n + 2 * n + g * n) <= SMEM_BYTES
    room = SMEM_BYTES // 4 - (n * n + 2 * n if in_smem else 2 * n)
    cap = min(g * (g + 1) // 2, room - ((g + 1) | 1) - 1)
    bs = bands(g, cap)
    mt = max(1, min(m, room // tile_floats(g, bs)))
    return Plan(mt, cap, in_smem, bs)


def _check(P, k: int | None = None):
    if P.dim() != 2:
        raise ValueError(f"profiles must be (M, G), got {tuple(P.shape)}")
    m, g = P.shape
    if not 1 <= g <= MAX_GRID:
        raise ValueError(f"segment_dp takes 1 <= G <= {MAX_GRID}, got {g}")
    if m * g >= 2**31:
        raise ValueError(f"segment_dp: M*G={m * g} exceeds int32 indexing")
    if k is not None and not 1 <= k <= g:
        raise ValueError(f"k must be in [1, G={g}], got {k}")
    return m, g


def _device_index(P) -> int:
    """The CUDA device ``P`` lies on; raises unless it is a contiguous
    float32 CUDA tensor."""
    if not P.is_cuda:
        raise ValueError(f"no segment_dp kernel for device {P.device}")
    if P.dtype != torch.float32 or not P.is_contiguous():
        raise ValueError("segment_dp takes a contiguous float32 tensor")
    return P.get_device()


def fit_cuts(P: torch.Tensor, k: int) -> torch.Tensor:
    """(M, G) float32 profiles -> the (k,) int64 cut columns (segment
    ends, the last == G) on ``P``'s device. ``k`` must be in [1, G]."""
    k = int(k)
    m, g = _check(P, k)
    if P.device.type == "cpu":
        return fit_cuts_plain(P.to(torch.float32), k)
    idx = _device_index(P)
    p = plan(m, g)
    cuts = torch.empty((k,), dtype=torch.int64, device=P.device)
    scratch = (None, None)       # the cost and back pointers in shared memory
    if not p.cost_in_smem:
        cost = torch.empty((g + 1, g + 1), dtype=torch.float32,
                           device=P.device)
        back = torch.empty((k, g + 1), dtype=torch.int32, device=P.device)
        scratch = (cost.data_ptr(), back.data_ptr())
    lib = _build.load(NAME)
    err = _build.launch(lib.segment_dp_fit_f32, idx, P.data_ptr(), *scratch,
                        cuts.data_ptr(), m, g, k, p.mt, p.cap)
    _build.check(lib, err, "segment_dp_fit")
    KERNEL_LAUNCHES[NAME] += 1
    return cuts


def segment_cost(P: torch.Tensor) -> torch.Tensor:
    """(M, G) float32 profiles -> (G+1, G+1) float32 over-reservation
    cost, ``inf`` where ``j <= i``, on ``P``'s device."""
    m, g = _check(P)
    if P.device.type == "cpu":
        return cost_matrix_plain(P.to(torch.float32))
    idx = _device_index(P)
    p = plan(m, g)
    cost = torch.empty((g + 1, g + 1), dtype=torch.float32, device=P.device)
    lib = _build.load(NAME)
    err = _build.launch(lib.segment_cost_f32, idx, P.data_ptr(),
                        cost.data_ptr(), m, g, p.mt, p.cap)
    _build.check(lib, err, "segment_cost")
    KERNEL_LAUNCHES["segment_cost"] += 1
    return cost
