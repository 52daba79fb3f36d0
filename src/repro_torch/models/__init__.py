"""LM substrate in PyTorch: the reference's model zoo (``repro.models``)
for the families dense, audio, ssm and hybrid. Parameters are nested dicts
of tensors that mirror the reference's pytrees; blocks are plain
functions on tensors."""
from repro_torch.models.model import (Model, build_model, cast_weights,
                                      init_params)
