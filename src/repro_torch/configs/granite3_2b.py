"""granite-3-2b — dense GQA [hf:ibm-granite/granite-3.0-2b-base; hf].

40L, d_model=2048, 32 heads (kv=8), d_ff=8192, vocab=49155 (padded to
49664 for even sharding).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense", n_layers=40, d_model=2048,
    n_heads=32, n_kv=8, d_ff=8192, vocab=49155)
