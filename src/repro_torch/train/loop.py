"""Training loop: checkpoint/restart, straggler mitigation, metrics.

The reference's (``repro/train/loop.py``) on tensors. Fault-tolerance
model:
  * checkpoint every N steps with atomic rename + async write; a restart
    seeks the data pipeline to the restored step (deterministic shards);
  * straggler mitigation: per-step wall times feed a robust deadline
    (k x running median); a host breaching it gets flagged and its NEXT
    data shard is regenerated by a healthy host (the counter-based
    pipeline makes any shard recomputable anywhere) -- simulated
    single-host here, the decision logic is real and unit-tested;
  * OOM-kill + retry ladder: when a memory budget is configured (Sizey
    integration), a step whose footprint exceeds the allocation raises
    SimulatedOOM so the launcher can restart from the last checkpoint with
    the paper's ladder (max-observed -> doubling).

The footprint is the reference's, ``tree_bytes`` of the parameters and
the optimizer state, so ``SimulatedOOM`` fires at the same budgets; the
card's own peak (``torch.cuda.max_memory_allocated``) is printed beside it
on the first step's log line and checked against nothing.

``Trainer`` runs on ``device`` (CUDA unless asked otherwise). Its initial
parameters are the port's own draws (``models.init_params``); pass
``params`` (e.g. the reference's, through ``convert.lm_params_to_torch``)
to start from given ones.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.models.model import init_params
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.step import make_train_step
from repro_torch.utils.misc import resolve_device, tree_bytes


class SimulatedOOM(RuntimeError):
    """Step footprint exceeded the allocated memory budget."""


class StragglerMonitor:
    """Flags hosts whose step time exceeds factor x running median."""

    def __init__(self, factor: float = 3.0, window: int = 32,
                 min_samples: int = 5):
        self.factor = factor
        self.min_samples = min_samples
        self.durations: dict[int, collections.deque] = {}
        self.events: list[tuple[int, int, float]] = []  # (step, host, dur)
        self._window = window

    def observe(self, step: int, host: int, duration_s: float) -> bool:
        dq = self.durations.setdefault(
            host, collections.deque(maxlen=self._window))
        all_durs = [d for q in self.durations.values() for d in q]
        is_straggler = False
        if len(all_durs) >= self.min_samples:
            deadline = self.factor * float(np.median(all_durs))
            if duration_s > deadline:
                self.events.append((step, host, duration_s))
                is_straggler = True
        dq.append(duration_s)
        return is_straggler


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 256
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    async_ckpt: bool = True
    optimizer: str = "adamw"
    lr: float = 3e-4
    microbatches: int = 1
    compress_grads: bool = False
    memory_budget_gb: float | None = None   # Sizey-allocated budget
    log_every: int = 10
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainerConfig,
                 *, hooks: list[Callable] | None = None, device=None,
                 params: dict | None = None):
        self.device = resolve_device(device)
        self.cfg, self.tc = cfg, tc
        self.monitor = StragglerMonitor()
        self.hooks = hooks or []
        self.pipeline = SyntheticTokenPipeline(
            cfg.vocab, tc.seq_len, tc.global_batch, seed=tc.seed,
            name=cfg.name)
        opt = make_optimizer(tc.optimizer, lr=tc.lr)
        grad_transform = None
        if tc.compress_grads:
            from repro_torch.train.compression import make_compressor
            grad_transform = make_compressor(tc.seed)
        self._step_fn = make_train_step(
            cfg, opt, microbatches=tc.microbatches,
            grad_transform=grad_transform)

        self.start_step = 0
        self.params = init_params(cfg, tc.seed, self.device) \
            if params is None else params
        self.opt_state = opt.init(self.params)
        if tc.ckpt_dir and ckpt_lib.latest_step(tc.ckpt_dir) is not None:
            self.start_step, state = ckpt_lib.restore(
                tc.ckpt_dir, {"params": self.params, "opt": self.opt_state})
            self.params, self.opt_state = state["params"], state["opt"]
        self.history: list[dict] = []
        self._pending_ckpt = None

    # -------------------------------------------------------------- train
    def footprint_gb(self) -> float:
        return tree_bytes({"p": self.params, "o": self.opt_state}) / 1024**3

    def _batch(self, step: int) -> dict:
        tokens = torch.from_numpy(self.pipeline.batch_at(step))
        return {"tokens": tokens.to(self.device)}

    def train(self) -> list[dict]:
        tc = self.tc
        cuda = self.device.type == "cuda"
        for step in range(self.start_step, tc.steps):
            batch = self._batch(step)
            t0 = time.perf_counter()
            metrics, self.params, self.opt_state = self._step_fn(
                self.params, self.opt_state, batch)
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            dur = time.perf_counter() - t0

            if tc.memory_budget_gb is not None \
                    and self.footprint_gb() > tc.memory_budget_gb:
                raise SimulatedOOM(
                    f"step {step}: footprint {self.footprint_gb():.2f}GB "
                    f"> budget {tc.memory_budget_gb:.2f}GB")

            straggled = self.monitor.observe(step, host=0, duration_s=dur)
            if straggled:
                # regenerate the straggler's shard on a healthy host --
                # deterministic pipeline makes this a pure recompute
                _ = self.pipeline.batch_at(step, host_id=0)

            row = {"step": step, "loss": loss, "grad_norm": gnorm,
                   "step_s": dur, "straggled": straggled}
            self.history.append(row)
            for hook in self.hooks:
                hook(self, row)
            if tc.log_every and step % tc.log_every == 0:
                peak = (f"; footprint {self.footprint_gb():.2f} GB, card "
                        f"peak {torch.cuda.max_memory_allocated(self.device) / 1024**3:.2f} GB"
                        if cuda and step == self.start_step else "")
                print(f"step {step:5d} loss {row['loss']:.4f} "
                      f"({dur*1e3:.0f} ms){peak}", flush=True)

            if tc.ckpt_dir and (step + 1) % tc.ckpt_every == 0:
                if self._pending_ckpt is not None:
                    self._pending_ckpt.join()
                self._pending_ckpt = ckpt_lib.save(
                    tc.ckpt_dir, step + 1,
                    {"params": self.params, "opt": self.opt_state},
                    async_write=tc.async_ckpt)

        if self._pending_ckpt is not None:
            self._pending_ckpt.join()
        if tc.ckpt_dir:
            ckpt_lib.save(tc.ckpt_dir, tc.steps,
                          {"params": self.params, "opt": self.opt_state})
        return self.history
