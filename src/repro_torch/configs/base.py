"""Model/run configuration for the 10 assigned architectures.

Every architecture ships as ``repro_torch/configs/<id>.py`` exposing CONFIG;
``repro_torch.configs.registry.get_config(arch_id)`` resolves them. Vocabulary
sizes are padded to a multiple of 512 (Megatron-style) so embedding/logit
shardings divide the 16-way model axis and the 32-way FSDP axes evenly; the
true vocab is kept for loss masking.
"""
from __future__ import annotations

import dataclasses

from repro_torch.utils.misc import round_up

VOCAB_PAD = 512


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int              # 0 for attention-free
    n_kv: int
    d_ff: int
    vocab: int                # true vocab (loss masking)
    head_dim: int = 0         # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    # hybrid (zamba2): one shared attention block applied every
    # ``attn_every`` layers (counted as layers themselves)
    attn_every: int = 0
    # VLM stub frontend: number of image-patch embeddings prepended
    n_patches: int = 0
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "block"      # none | block | dots
    # attention implementation: auto (chunked beyond threshold) | naive |
    # chunked. The cost probes force "naive": identical FLOPs, but no
    # internal lax.map/scan whose trip counts cost_analysis would drop.
    attn_impl: str = "auto"
    # ---- §Perf optimization knobs (EXPERIMENTS.md) ----
    # decode KV cache dtype: "compute" | "float8_e4m3fn" (halves KV HBM)
    kv_dtype: str = "compute"
    # keep the decode cache in the layer-scan CARRY (in-place
    # dynamic-update aliasing) instead of xs/ys staging (3x temp copies).
    # Default ON after §Perf cells A/C (bit-exact, -40% decode peak HBM).
    decode_carry_cache: bool = True
    # MoE position-in-expert: "flat" global cumsum over the (sharded)
    # token dim vs "rowwise" per-sequence cumsum + tiny row-offset scan vs
    # "grouped" per-row capacity (all dispatch traffic shard-local).
    # Default "grouped" after §Perf cell B (-10% train collectives, and
    # it is the standard GShard/Switch group-capacity semantics).
    moe_dispatch: str = "grouped"
    # sequence parallelism: residual-stream activations sharded over
    # "model" on the seq dim between blocks (all-reduce -> RS+AG pattern)
    seq_shard: bool = False

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ------------------------------------------------------------- derived
    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab, VOCAB_PAD)

    @property
    def d_inner(self) -> int:          # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """long_500k runs only for sub-quadratic archs (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def n_ssm_layers(self) -> int:
        if self.family == "ssm":
            return self.n_layers
        if self.family == "hybrid":
            return self.n_layers - self.n_attn_layers()
        return 0

    def n_attn_layers(self) -> int:
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            # every attn_every-th layer position is the shared attention block
            return self.n_layers // self.attn_every
        return self.n_layers

    # rough parameter count (reported in DESIGN / used for 6ND)
    def param_count(self) -> int:
        V, D, F = self.padded_vocab, self.d_model, self.d_ff
        emb = V * D + D * V  # embed + lm_head (untied)
        n = emb
        attn = (D * self.n_heads * self.head_dim
                + 2 * D * self.n_kv * self.head_dim
                + self.n_heads * self.head_dim * D)
        dense_ff = 3 * D * F  # SwiGLU
        moe_ff = self.n_experts * 3 * D * F + D * self.n_experts
        if self.family in ("dense", "vlm", "audio"):
            n += self.n_layers * (attn + dense_ff + 2 * D)
        elif self.family == "moe":
            n += self.n_layers * (attn + moe_ff + 2 * D)
        elif self.family == "ssm":
            di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            zxbcdt = 2 * di + 2 * N + H
            ssm = D * zxbcdt + di * D + 3 * H + self.ssm_conv * (di + 2 * N)
            n += self.n_layers * (ssm + 2 * D)
        elif self.family == "hybrid":
            di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            zxbcdt = 2 * di + 2 * N + H
            ssm = D * zxbcdt + di * D + 3 * H + self.ssm_conv * (di + 2 * N)
            n += self.n_ssm_layers() * (ssm + 2 * D)
            n += attn + dense_ff + 2 * D  # ONE shared attn+mlp block
        return n

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        V, D, F = self.padded_vocab, self.d_model, self.d_ff
        attn = (D * self.n_heads * self.head_dim
                + 2 * D * self.n_kv * self.head_dim
                + self.n_heads * self.head_dim * D)
        act = 2 * V * D + self.n_layers * (
            attn + self.top_k * 3 * D * F + 2 * D)
        return act

    def with_layers(self, n: int) -> "ModelConfig":
        """Same config at a different depth (cost-probe lowering)."""
        return dataclasses.replace(self, n_layers=n)

    @property
    def layer_unit(self) -> int:
        """Smallest homogeneous depth unit (hybrid: one mamba+shared group)."""
        return self.attn_every if self.family == "hybrid" else 1

    # ------------------------------------------------------------- reduced
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dataclasses.asdict(self)
        attn_every_r = min(self.attn_every, 2) if self.attn_every else 0
        kw.update(
            n_layers=2 * attn_every_r if self.family == "hybrid" else 2,
            d_model=128,
            n_heads=4 if self.n_heads else 0,
            n_kv=min(self.n_kv, 2) if self.n_heads else 0,
            head_dim=32 if self.n_heads else 0,
            d_ff=256 if self.d_ff else 0,
            vocab=256,
            n_experts=min(self.n_experts, 4),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32 if self.ssm_state else 64,
            attn_every=attn_every_r,
            n_patches=min(self.n_patches, 4),
            param_dtype="float32",
            compute_dtype="float32",
            remat="none",
        )
        return ModelConfig(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    def reduced(self) -> "ShapeConfig":
        return ShapeConfig(self.name, min(self.seq_len, 64),
                           min(self.global_batch, 2), self.kind)


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_is_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch x shape) cell."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("SKIP(attention): O(S^2) full attention at 524288 — "
                       "arch has no sub-quadratic path (DESIGN.md "
                       "§Arch-applicability)")
    return True, ""
