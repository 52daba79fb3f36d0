"""Checkpoint/restart: sharded npz snapshots with atomic rename.

The reference's (``repro/train/checkpoint.py``) with the same files, so
either package restores the other's checkpoints. Layout:
<dir>/step_<N>/ with one ``shard_<p>.npz`` per host process (arrays
``a0..aN`` in JAX's leaf order: dict keys sorted at every level) plus a
``meta.json`` (the leaves' paths as ``jax.tree_util`` prints them, step,
leaf count). Writes go to a ``.tmp`` directory renamed into place only
after fsync: a crashed save can never corrupt the latest checkpoint.
Saves can run asynchronously: the host snapshot (a copy of every leaf) is
taken synchronously, the serialization happens on a writer thread so the
train loop overlaps checkpoint I/O with compute; the copy matters here,
because the port's optimizer updates its tensors in place.

numpy has no bfloat16: a bf16 leaf is written as float32 (exactly) and
restored into the type of the leaf it replaces.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.utils.misc import tree_flatten_with_path, tree_unflatten

META = "meta.json"


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.array(t)


def save(ckpt_dir: str, step: int, tree, *, async_write: bool = False,
         process_index: int = 0, extra_meta: dict | None = None):
    """Snapshot ``tree`` at ``step``. Returns a join()-able handle."""
    paths, leaves = tree_flatten_with_path(tree)
    host_leaves = [_host(x) for x in leaves]
    step = int(step)

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"shard_{process_index}.npz"),
                 **{f"a{i}": a for i, a in enumerate(host_leaves)})
        meta = {"step": step, "paths": paths,
                "n_leaves": len(host_leaves), **(extra_meta or {})}
        with open(os.path.join(tmp, META), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_write:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, META))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, tree_like, *, step: int | None = None,
            process_index: int = 0, device=None):
    """Restore into the structure of ``tree_like``. Returns (step, tree):
    each leaf a tensor in the type of ``tree_like``'s leaf, on ``device``
    (by default where that leaf lies)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, META)) as f:
        meta = json.load(f)
    data = np.load(os.path.join(d, f"shard_{process_index}.npz"))
    arrays = [data[f"a{i}"] for i in range(meta["n_leaves"])]
    paths, likes = tree_flatten_with_path(tree_like)
    if len(likes) != len(arrays):
        raise ValueError(f"checkpoint holds {len(arrays)} leaves, the tree "
                         f"{len(likes)}")
    leaves = []
    for a, like in zip(arrays, likes):
        # a tensor of PyTorch's own allocation (not numpy's buffer): the
        # CPU's vectorized kernels round by the data's alignment, and a
        # restored run is bitwise an uninterrupted one only on tensors
        # aligned as the uninterrupted run's are
        t = torch.empty(a.shape, dtype=like.dtype,
                        device=like.device if device is None else device)
        leaves.append(t.copy_(torch.from_numpy(np.array(a))))
    return step, tree_unflatten(tree_like, leaves)
