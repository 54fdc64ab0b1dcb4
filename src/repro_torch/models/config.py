"""Model architecture configuration (the port's copy of
``repro.models.config``).

The fields match the reference dataclass one for one, so a configuration
reads the same in both packages.  The port's model code runs the dense
GQA family with SwiGLU MLPs (one attention layer and one dense MLP per
layer, no MoE, no MLA); :meth:`ModelConfig.check_supported` refuses the
others, which are still to be ported (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # Attention flavour.
    qk_norm: bool = False
    rope_theta: float = 1e4
    mlp_act: str = "silu"  # "silu" (SwiGLU) | "gelu" (GeGLU)

    # MoE.
    num_experts: int = 0
    experts_top_k: int = 0
    moe_period: int = 1
    num_shared_experts: int = 0
    moe_d_ff: int = 0

    # MLA.
    use_mla: bool = False
    mla_absorb: bool = False
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # SSM / hybrid.
    attn_period: int = 0
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4

    # IO.
    embed_input: bool = False
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    def num_params(self) -> int:
        """Parameter count of the dense GQA family, counted as the
        reference counts it (embedding, attention, MLP, per-layer norms)."""
        d, hd = self.d_model, self.head_dim
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = (d * self.num_heads * hd
                     + 2 * d * self.num_kv_heads * hd
                     + self.num_heads * hd * d
                     + 3 * d * self.d_ff + 2 * d)
        return total + per_layer * self.num_layers

    def check_supported(self) -> None:
        """Raise unless the port's model code runs this configuration."""
        if (self.family != "dense" or self.num_experts or self.use_mla
                or self.embed_input or self.qk_norm or self.mlp_act != "silu"):
            raise NotImplementedError(
                f"{self.name}: the port runs dense GQA decoders with SwiGLU "
                "only (MoE, MLA, SSM, qk-norm, GeGLU and embed-input models "
                "are still to be ported; see ROADMAP.md)")
