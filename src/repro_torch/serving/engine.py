"""Batched serving engine: slot-based prefill + decode.

The reference's engine (``repro/serving/engine.py``) on a device: requests
are grouped into batches of up to ``max_batch`` slots; each batch shares
one KV cache; shorter prompts are right-padded with their own last token;
per-slot done flags (EOS or max tokens) end a batch early. With a sizer
(``launch.sizing.KVCacheSizer``) the engine asks Sizey for each batch's
KV-cache memory before prefill and reports the cache's actual bytes after
the batch, so cache sizing improves online as task sizing does.

The weights the model casts to the compute type at each matmul are cast
once here (``models.cast_weights``; bitwise the same results). Sampling
at a temperature draws ``jax.random.categorical``'s Gumbel noise from the
port's copy of JAX's threefry generator, on the logits' device
(``core.prng_device``), so a seed gives the reference's tokens.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import prng, prng_device
from repro_torch.models.model import Model, cast_weights
from repro_torch.utils.misc import resolve_device, tree_bytes


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (prompt_len,) int32
    max_new_tokens: int = 32
    eos_id: int | None = None


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray
    prompt_len: int


def _params_device(params) -> torch.device:
    for v in params.values():
        return _params_device(v) if isinstance(v, dict) else v.device
    raise ValueError("empty parameter tree")


class ServeEngine:
    def __init__(self, model: Model, params, *, max_batch: int = 8,
                 max_seq: int = 512, temperature: float = 0.0,
                 sizer=None, seed: int = 0, device=None):
        self.device = resolve_device(device)
        if _params_device(params).type != self.device.type:
            raise ValueError(f"parameters on {_params_device(params)}, "
                             f"engine on {self.device}")
        self.model = model
        self.params = params
        self._params = cast_weights(params, model.cfg)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.temperature = temperature
        self.sizer = sizer
        self._key = prng.prng_key(seed)
        self.stats = {"batches": 0, "requests": 0, "tokens": 0,
                      "kv_bytes": 0}

    def _sample(self, logits) -> torch.Tensor:
        last = logits[:, -1, :]
        if self.temperature <= 0.0:
            return torch.argmax(last, dim=-1)
        self._key, sub = prng.split(self._key)
        noise = prng_device.gumbel(sub, tuple(last.shape), last.device)
        return torch.argmax(noise + last / self.temperature, dim=-1)

    def serve(self, requests: list[Request]) -> list[Completion]:
        out: list[Completion] = []
        for i in range(0, len(requests), self.max_batch):
            out.extend(self._serve_batch(requests[i: i + self.max_batch]))
        return out

    def _serve_batch(self, batch: list[Request]) -> list[Completion]:
        b = len(batch)
        plen = max(len(r.prompt) for r in batch)
        budget = max(r.max_new_tokens for r in batch)
        max_seq = min(self.max_seq, plen + budget)
        prompts = np.stack([
            np.pad(r.prompt, (0, plen - len(r.prompt)), mode="edge")
            for r in batch]).astype(np.int32)

        if self.sizer is not None:
            self.sizer.before_batch(b, max_seq)

        tokens = torch.from_numpy(prompts).to(self.device)
        logits, cache = self.model.prefill(self._params, {"tokens": tokens},
                                           max_seq=max_seq)
        kv_bytes = tree_bytes(cache)
        tok = self._sample(logits)
        produced = [[t] for t in tok.tolist()]
        done = np.zeros(b, bool)

        for _ in range(budget - 1):
            logits, cache = self.model.decode_step(self._params, cache,
                                                   tok[:, None])
            tok = self._sample(logits)
            toks = tok.tolist()
            for i, r in enumerate(batch):
                if done[i]:
                    continue
                t = toks[i]
                if r.eos_id is not None and t == r.eos_id:
                    done[i] = True
                elif len(produced[i]) >= r.max_new_tokens:
                    done[i] = True
                else:
                    produced[i].append(t)
            if bool(done.all()):
                break

        self.stats["batches"] += 1
        self.stats["requests"] += b
        self.stats["tokens"] += sum(len(p) for p in produced)
        self.stats["kv_bytes"] = kv_bytes
        if self.sizer is not None:
            self.sizer.after_batch(b, max_seq, kv_bytes)
        return [Completion(r.rid, np.asarray(p, np.int32), len(r.prompt))
                for r, p in zip(batch, produced)]
