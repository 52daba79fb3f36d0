"""grok-1-314b — MoE 8 experts top-2 [hf:xai-org/grok-1; unverified].

64L, d_model=6144, 48 heads (kv=8), d_ff=32768 per expert, vocab=131072.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv=8, d_ff=32768, vocab=131072, n_experts=8, top_k=2)
