"""LM substrate in PyTorch: the reference's model zoo (``repro.models``)
for all six families (dense, moe, ssm, hybrid, vlm, audio). Parameters are nested dicts
of tensors that mirror the reference's pytrees; blocks are plain
functions on tensors."""
from repro_torch.models.model import (AUX_WEIGHT, Model, build_model,
                                      cast_weights, init_params, loss_fn)
