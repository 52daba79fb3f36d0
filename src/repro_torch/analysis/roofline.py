"""Roofline terms from the dry run, against an H100's rates.

    compute term    = FLOPs / peak_FLOP/s              (per card)
    memory term     = bytes / HBM_bw                   (per card)
    collective term = collective_bytes / link_bw       (per card)

The reference's ``repro/analysis/roofline.py`` with the port's constants
(``launch.mesh``: ``PEAK_FLOPS_BF16``, ``HBM_BW`` and ``NVLINK_BW`` in
place of the TPU's ICI rate). The dry run counts each card's own FLOPs,
bytes and collective bytes, so the terms are per card; MODEL_FLOPS (6ND
train / 2ND inference, N_active for MoE) is a global quantity and is
divided by the card count for the useful-compute ratio.

The link term takes every collective at NVLink's rate. A 16-wide "model"
axis crosses the 8-GPU NVLink domain of an H100 node, so its collectives
run partly over the slower network between nodes: the collective term is
then a lower bound.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful model FLOPs per step (global, not per chip)."""
    n = cfg.active_param_count() if cfg.family == "moe" else cfg.param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence per step
    return 2.0 * n * shape.global_batch


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    collective_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_global: float
    useful_ratio: float          # MODEL_FLOPS / (FLOPs * chips)
    roofline_fraction: float     # compute_s / max(all terms)
    peak_memory_gb: float | None = None

    @property
    def step_time_lower_bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline_terms(arch: str, shape_cfg: ShapeConfig, cfg: ModelConfig,
                   mesh_name: str, chips: int, flops_per_chip: float,
                   bytes_per_chip: float, coll_bytes_per_chip: float,
                   peak_memory_gb: float | None = None) -> RooflineReport:
    compute_s = flops_per_chip / PEAK_FLOPS_BF16
    memory_s = bytes_per_chip / HBM_BW
    collective_s = coll_bytes_per_chip / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape_cfg)
    useful = mf / max(flops_per_chip * chips, 1.0)
    frac = compute_s / max(max(terms.values()), 1e-30)
    return RooflineReport(
        arch=arch, shape=shape_cfg.name, mesh=mesh_name, chips=chips,
        hlo_flops_per_chip=flops_per_chip, hlo_bytes_per_chip=bytes_per_chip,
        collective_bytes_per_chip=coll_bytes_per_chip, compute_s=compute_s,
        memory_s=memory_s, collective_s=collective_s, bottleneck=bottleneck,
        model_flops_global=mf, useful_ratio=useful, roofline_fraction=frac,
        peak_memory_gb=peak_memory_gb)
