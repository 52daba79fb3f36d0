"""zamba2-7b — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified].

81 layer positions, d_model=3584: every 3rd position applies ONE shared
GQA attention+MLP block (32 heads, kv=32, d_ff=14336, weights reused across
all 27 applications — the Zamba shared-block scheme, LoRA-per-invocation
omitted, see DESIGN.md); the other 54 positions are Mamba2 blocks with
ssm_state=64 (head_dim 64 => 112 SSM heads). Hybrid => long_500k runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv=32, head_dim=112, d_ff=14336, vocab=32000,
    ssm_state=64, attn_every=3)
