"""Distribution layer: logical-axis sharding rules over DTensor placements,
and the GPipe pipeline schedule over process groups."""
from repro_torch.distributed.sharding import (DEFAULT_RULES, FSDP_AXES,
                                              axis_rules, batch_specs,
                                              logical_to_spec, param_specs,
                                              shard)
