"""Carry state between the JAX reference and the port, as numpy arrays.

The reference's model states are NamedTuples of arrays and its provenance
pools hold arrays as attributes; fetched to the host (``jax.device_get``,
``np.asarray``) they are numpy. These functions turn such numpy states
into the port's tensors on a device and back, field by field in the
reference's order, so both packages can compute from the same state:

    t_state = state_to_torch("mlp", jax.device_get(j_state), "cuda")
    j_state = repro.core.models.mlp.MLPState(*state_to_numpy("mlp", t_state))

Nothing here imports JAX or ``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.models import MODEL_MODULES

_STATE_CLASSES = {
    "linear": MODEL_MODULES["linear"].LinearState,
    "knn": MODEL_MODULES["knn"].KNNState,
    "forest": MODEL_MODULES["forest"].ForestState,
    "mlp": MODEL_MODULES["mlp"].MLPState,
}
# integer fields: int32 in the reference, int64 (index dtype) in the port
_INT_FIELDS = {("forest", "feat")}

POOL_ARRAYS = ("xs", "ys", "runtimes", "mask", "insample_preds",
               "log_model_preds", "log_agg", "log_actual", "log_runtime",
               "log_mask")
POOL_SCALARS = ("cap", "count", "log_cap", "log_count", "max_seen_gb")


def _to_torch(a, device, integer: bool):
    if isinstance(a, (tuple, list)):
        return tuple(_to_torch(x, device, integer) for x in a)
    dtype = torch.int64 if integer else torch.float32
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def _to_numpy(a, integer: bool):
    if isinstance(a, (tuple, list)):
        return tuple(_to_numpy(x, integer) for x in a)
    out = a.detach().cpu().numpy()
    return out.astype(np.int32 if integer else np.float32)


def state_to_torch(model: str, arrays, device="cpu"):
    """A reference model state (any sequence of numpy arrays in field
    order, NamedTuples included) -> the port's state on ``device``."""
    cls = _STATE_CLASSES[model]
    return cls(*(_to_torch(a, device, (model, f) in _INT_FIELDS)
                 for f, a in zip(cls._fields, arrays)))


def state_to_numpy(model: str, state) -> tuple:
    """A port model state -> a tuple of numpy arrays in the reference's
    field order and dtypes (pass it to the reference's state class)."""
    return tuple(_to_numpy(a, (model, f) in _INT_FIELDS)
                 for f, a in zip(type(state)._fields, state))


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def pool_to_numpy(pool) -> dict:
    """Either package's provenance pool -> a dict of its buffers (numpy)
    and host-side scalars."""
    out = {k: np.asarray(_host(getattr(pool, k)), np.float32)
           for k in POOL_ARRAYS}
    out.update({k: getattr(pool, k) for k in POOL_SCALARS})
    return out


def pool_from_numpy(db, key: tuple[str, str], arrays: dict):
    """Load ``arrays`` (see :func:`pool_to_numpy`) into the port pool
    ``key`` of ``db``, replacing its buffers. Returns the pool."""
    pool = db.pool(*key)
    for k in POOL_ARRAYS:
        setattr(pool, k, torch.tensor(np.asarray(arrays[k], np.float32),
                                      device=db.device))
    for k in POOL_SCALARS:
        setattr(pool, k, type(getattr(pool, k))(arrays[k]))
    return pool
