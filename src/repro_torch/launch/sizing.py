"""Sizey <-> framework integration: online memory sizing for LM jobs.

The reference's integration (``repro/launch/sizing.py``) on the port's
predictor: a job's features are deployment-known scalars (parameter GB,
tokens per step, context length) and the target its peak device memory;
``KVCacheSizer`` sizes each serving batch's KV cache from (batch, context)
and learns from the cache's actual bytes. The predictor runs on ``device``
(CUDA unless asked otherwise), so its ensemble MLP and k-NN go through the
port's kernels K1 and K2 there.

The default memory cap is the device's own: its total memory in GiB on a
CUDA device. The reference's default is a TPU chip's 16 GB
(``repro/launch/mesh.py``), kept here as the CPU's default; the tests pass
``cap_gb=16.0`` to both packages.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import SizeyConfig
from repro_torch.core.predictor import SizeyPredictor, SizingDecision
from repro_torch.utils.misc import resolve_device

CPU_CAP_GB = 16.0


def device_cap_gb(device) -> float:
    """Total memory of ``device`` in GiB; ``CPU_CAP_GB`` on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory / 1024**3
    return CPU_CAP_GB


def job_features(cfg: ModelConfig, shape: ShapeConfig, chips: int):
    """Deployment-known scalars describing one job, per chip."""
    param_gb = cfg.param_count() * 4 / 1024**3 / chips
    tokens_m = shape.global_batch * shape.seq_len / 1e6 / chips
    ctx_k = shape.seq_len / 1024.0
    return (param_gb, tokens_m, ctx_k)


@dataclasses.dataclass
class JobDecision:
    sizing: SizingDecision
    arch: str
    shape: str
    mesh: str


class SizeyJobSizer:
    """Sizes LM jobs' per-device memory with the paper's predictor."""

    def __init__(self, cfg: SizeyConfig | None = None,
                 hbm_cap_gb: float | None = None,
                 preset_gb: float | None = None, device=None):
        dev = resolve_device(device)
        cap = device_cap_gb(dev) if hbm_cap_gb is None else hbm_cap_gb
        self.predictor = SizeyPredictor(
            cfg or SizeyConfig(min_history=2), n_features=3,
            default_machine_cap_gb=cap, device=dev)
        self.preset_gb = cap if preset_gb is None else preset_gb
        self.hbm_cap_gb = cap

    def size_job(self, arch: str, cfg: ModelConfig, shape: ShapeConfig,
                 mesh_name: str, chips: int) -> JobDecision:
        feats = job_features(cfg, shape, chips)
        dec = self.predictor.predict(
            task_type=f"{arch}/{shape.kind}", machine=mesh_name,
            features=feats, user_preset_gb=self.preset_gb,
            machine_cap_gb=self.hbm_cap_gb)
        return JobDecision(dec, arch, shape.name, mesh_name)

    def observe_job(self, job: JobDecision, peak_gb: float,
                    runtime_h: float = 1.0, attempts: int = 1):
        self.predictor.observe(job.sizing, peak_gb, runtime_h, attempts,
                               workflow=job.mesh)

    def retry_allocation(self, job: JobDecision, attempt: int,
                         last_alloc_gb: float) -> float:
        return self.predictor.retry_allocation(job.sizing, attempt,
                                               last_alloc_gb)


class KVCacheSizer:
    """ServeEngine hook: sizes a batch's KV cache online."""

    def __init__(self, cfg: SizeyConfig | None = None,
                 cap_gb: float | None = None, device=None):
        dev = resolve_device(device)
        self.predictor = SizeyPredictor(
            cfg or SizeyConfig(min_history=2), n_features=2,
            default_machine_cap_gb=(device_cap_gb(dev) if cap_gb is None
                                    else cap_gb),
            device=dev)
        self.decisions: list[SizingDecision] = []
        self._pending: SizingDecision | None = None

    def before_batch(self, batch: int, max_seq: int):
        self._pending = self.predictor.predict(
            "kv_cache", "serve", (batch / 8.0, max_seq / 1024.0),
            user_preset_gb=4.0)
        self.decisions.append(self._pending)
        return self._pending.allocation_gb

    def after_batch(self, batch: int, max_seq: int, kv_bytes: int):
        if self._pending is not None:
            self.predictor.observe(self._pending, kv_bytes / 1024**3,
                                   runtime_h=0.01)
            self._pending = None
