"""Sizey's model pool (paper Fig. 5): four regression models in torch.

Every model follows the same functional API over fixed-capacity masked
buffers (CAP, d) / (CAP,) on one device:

    state = fit(xs, ys, mask, key, cfg)                    # full retrain
    state = update(state, xs, ys, mask, new_idx, key, cfg) # online step
    yhat  = predict_batch(state, xq)                       # (K, d) -> (K,)

``key`` is a host-side threefry key (:mod:`repro_torch.core.prng`): the
forest and the MLP draw from it exactly as the reference draws from
``jax.random``. States are NamedTuples of tensors.
"""
from repro_torch.core.models import forest, knn, linear, mlp

MODEL_MODULES = {
    "linear": linear,
    "knn": knn,
    "mlp": mlp,
    "forest": forest,
}
