"""Deterministic sharded synthetic-token pipeline with host prefetch.

Each (step, host) pair derives its batch shard from a counter-based PRNG —
no coordination, bit-reproducible restarts (the loop just seeks to the
resume step), and any host can regenerate any other host's shard, which is
what makes the straggler-mitigation reassignment in train/loop.py safe.

Tokens follow a Zipf-like marginal with a Markov bigram mixture so the CE
loss has learnable structure (the quickstart shows loss going down).

A copy of the reference's numpy-only ``repro.data.pipeline``: the batches,
and the prefetch thread's order, are bitwise the reference's.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.utils.misc import stable_hash


class SyntheticTokenPipeline:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 *, n_hosts: int = 1, host_id: int = 0, seed: int = 0,
                 prefetch: int = 2, name: str = "synth"):
        assert global_batch % n_hosts == 0
        self.vocab = vocab
        self.seq_len = seq_len
        self.local_batch = global_batch // n_hosts
        self.n_hosts = n_hosts
        self.host_id = host_id
        self.base_seed = (seed + stable_hash(name)) % (2 ** 31)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._next_step = 0

    # ---------------------------------------------------------- batch gen
    def batch_at(self, step: int, host_id: int | None = None) -> np.ndarray:
        """Deterministic (local_batch, seq_len) int32 token shard."""
        host = self.host_id if host_id is None else host_id
        rng = np.random.default_rng(
            (self.base_seed, step, host))
        b, s, v = self.local_batch, self.seq_len, self.vocab
        # zipf marginal, clipped into vocab
        base = rng.zipf(1.3, size=(b, s)).astype(np.int64) % v
        # markov structure: with p=0.5 the next token = f(prev)
        shift = (base * 31 + 7) % v
        use_prev = rng.random((b, s)) < 0.5
        tokens = np.where(use_prev, np.roll(shift, 1, axis=1), base)
        return tokens.astype(np.int32)

    # ----------------------------------------------------------- prefetch
    def start(self, from_step: int = 0):
        self._next_step = from_step
        self._stop.clear()

        def worker():
            step = from_step
            while not self._stop.is_set():
                batch = self.batch_at(step)
                self._q.put((step, batch))
                step += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        return self

    def next(self) -> tuple[int, np.ndarray]:
        if self._thread is None:
            step = self._next_step
            self._next_step += 1
            return step, self.batch_at(step)
        return self._q.get()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            while not self._q.empty():
                self._q.get_nowait()
            self._thread = None
