from repro_torch.utils.misc import (GB, MB, ceil_div, device_constant,
                                   resolve_device, round_up, stable_hash,
                                   tree_bytes)
