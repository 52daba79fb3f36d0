"""mamba2-780m — attention-free SSD [arXiv:2405.21060; unverified].

48L, d_model=1536, ssm_state=128, d_inner=3072 (expand 2), head_dim 64
=> 48 SSM heads. vocab=50280 (padded 50688). No attention layers: the
long_500k cell runs with O(1)-state decode.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm", n_layers=48, d_model=1536,
    n_heads=0, n_kv=0, d_ff=0, vocab=50280, ssm_state=128)
