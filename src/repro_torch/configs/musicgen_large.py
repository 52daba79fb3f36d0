"""musicgen-large — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].

48L, d_model=2048, 32 heads (kv=32), d_ff=8192, vocab=2048 (EnCodec
codebook). The EnCodec frontend is a STUB per the assignment: the backbone
consumes precomputed token streams (one interleaved codebook stream).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio", n_layers=48, d_model=2048,
    n_heads=32, n_kv=32, d_ff=8192, vocab=2048)
