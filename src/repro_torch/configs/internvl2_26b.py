"""internvl2-26b — VLM backbone (InternLM2-20B side) [arXiv:2404.16821; hf].

48L, d_model=6144, 48 heads (kv=8), d_ff=16384, vocab=92553 (padded 92672).
The InternViT frontend is a STUB per the assignment: input_specs() provides
256 precomputed patch embeddings per sample, prepended to the text tokens.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm", n_layers=48, d_model=6144,
    n_heads=48, n_kv=8, d_ff=16384, vocab=92553, n_patches=256)
