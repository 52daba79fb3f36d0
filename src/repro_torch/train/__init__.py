"""Training runtime: optimizers, fused train step, checkpointing, loops."""
from repro_torch.train.optimizer import (adafactor_init, adafactor_update,
                                         adamw_init, adamw_update,
                                         make_optimizer)
from repro_torch.train.step import make_train_step
