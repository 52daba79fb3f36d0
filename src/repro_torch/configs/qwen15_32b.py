"""qwen1.5-32b — dense GQA decoder [hf:Qwen/Qwen1.5-32B; hf].

64L, d_model=5120, 40 heads (kv=40 => MHA), d_ff=27392, vocab=152064,
QKV bias (the Qwen1.5 signature), rope_theta=1e6.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv=40, d_ff=27392, vocab=152064, qkv_bias=True,
    rope_theta=1e6)
