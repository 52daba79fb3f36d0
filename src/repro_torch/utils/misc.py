"""Small shared utilities."""
from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

GB = 1024**3
MB = 1024**2


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    """Round x up to the next multiple of m."""
    return ceil_div(x, m) * m


def _leaves(tree):
    if tree is None:
        return
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tree_bytes(tree) -> int:
    """Total bytes of all tensors / arrays in a nested tuple/list/dict
    (NamedTuple states included)."""
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
    return total


def stable_hash(s: str) -> int:
    """Deterministic 63-bit hash (python's hash() is salted per-process)."""
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "big") >> 1


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, device: torch.device) -> torch.Tensor:
    """A float32 constant vector on ``device``, uploaded once and shared
    (callers must not write to it): a fresh host->device copy on every
    call would make the host wait for the device's queue."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for (or defaulted to) and there is
    no GPU, instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and this machine "
            "has none; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU")
    return dev
