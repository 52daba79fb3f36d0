"""Carry state between the JAX reference and the port, as numpy arrays.

The reference's model states are NamedTuples of arrays, its provenance
pools hold arrays as attributes and its LM parameters are nested dicts of
arrays; fetched to the host (``jax.device_get``, ``np.asarray``) they are
numpy. These functions turn such numpy states into the port's tensors on a
device (CUDA unless the caller asks for another) and back, field by field
in the reference's order, so both packages can compute from the same state:

    t_state = state_to_torch("mlp", jax.device_get(j_state), "cuda")
    j_state = repro.core.models.mlp.MLPState(*state_to_numpy("mlp", t_state))
    t_params = lm_params_to_torch(jax.device_get(j_params), "cuda")
    t_opt = opt_state_to_torch(jax.device_get(j_opt_state), "cuda")

Nothing here imports JAX or ``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.models import MODEL_MODULES
from repro_torch.utils.misc import resolve_device

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


def state_to_torch(model: str, arrays, device=None):
    """A reference model state (any sequence of numpy arrays in field
    order, NamedTuples included) -> the port's state on ``device`` (CUDA
    unless asked otherwise)."""
    device = resolve_device(device)
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


def _leaf_to_torch(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: exact via fp32
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def lm_params_to_torch(np_tree, device=None, dtype=None) -> dict:
    """The reference's LM parameter pytree (nested dicts of numpy arrays,
    per-layer stacks on a leading axis) -> the port's dict of tensors on
    ``device`` (CUDA unless asked otherwise), in each array's own type, or
    in ``dtype`` for the floating ones."""
    device = resolve_device(device)
    return {k: lm_params_to_torch(v, device, dtype) if isinstance(v, dict)
            else _leaf_to_torch(v, device, dtype) for k, v in np_tree.items()}


def lm_params_to_numpy(tree) -> dict:
    """The port's LM parameters (or decode cache) -> nested dicts of numpy
    arrays in the reference's layout; bfloat16 leaves come back as float32
    (exactly: numpy has no bfloat16)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return {k: lm_params_to_numpy(v) if isinstance(v, dict) else leaf(v)
            for k, v in tree.items()}


def opt_state_to_torch(np_state, device=None) -> dict:
    """The reference's optimizer state (numpy) -> the port's tensors on
    ``device``, leaf for leaf in each array's own type: AdamW's fp32
    ``m`` and ``v`` trees and int32 ``step``, or Adafactor's ``vr`` and
    ``vc`` factor trees and ``step`` (train/optimizer.py keeps the
    reference's trees)."""
    return lm_params_to_torch(np_state, device)


def opt_state_to_numpy(state) -> dict:
    """The port's optimizer state -> nested dicts of numpy arrays in the
    reference's layout (``step`` a 0-d int32 array)."""
    return lm_params_to_numpy(state)
