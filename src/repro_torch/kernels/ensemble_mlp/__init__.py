from repro_torch.kernels.ensemble_mlp.ops import (ensemble_mlp_forward,
                                                  mlp_predict)
