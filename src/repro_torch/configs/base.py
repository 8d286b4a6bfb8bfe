"""Architecture configuration schema (copy of ``repro/configs/base.py``).

The port keeps its own copy so that it imports nothing of the JAX package.
``to_modelspec`` (the analytical estimator's view) is left out: it pulls in
``core/modelspec.py`` and is only needed by the ``victim_policy="cost"``
preemption rule, which this slice does not port yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 => d_model // n_heads
    # attention details
    qkv_bias: bool = False
    o_bias: bool = False
    mlp_bias: bool = False
    swa_window: Optional[int] = None
    rope_theta: float = 10000.0
    m_rope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    # hybrid (zamba2)
    hybrid_period: int = 0
    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    # misc
    frontend: str = "none"          # none | audio_frames | vision_embeds
    tie_embeddings: bool = False
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    gated_ffn: bool = True
    act: str = "silu"               # silu | gelu
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 128
    supports_decode: bool = True
    subquadratic: bool = False
    max_position: int = 1 << 20
    source: str = ""

    # ----- derived ---------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab + m - 1) // m * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    def shared_attn_positions(self) -> Tuple[int, ...]:
        """Trunk indices after which the shared block fires (zamba2)."""
        if self.hybrid_period <= 0:
            return ()
        return tuple(range(self.hybrid_period - 1, self.n_layers,
                           self.hybrid_period))

    # ----- reduced config for CPU smoke tests -------------------------------
    def reduced(self) -> "ArchConfig":
        """Same family/features, toy size, float32 (CPU smoke tests)."""
        n_layers = min(self.n_layers, 4 if self.hybrid_period == 0
                       else 2 * max(2, self.hybrid_period // 2))
        hybrid_period = 0 if self.hybrid_period == 0 else 2
        if hybrid_period:
            n_layers = 4
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, 2)) if self.n_kv_heads else 0
        if self.n_kv_heads == self.n_heads:        # MHA stays MHA
            n_kv = n_heads
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=64,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=16,
            d_ff=96 if self.n_experts == 0 else 32,
            vocab=503,                      # deliberately odd: exercises pad
            n_experts=min(self.n_experts, 8),
            moe_top_k=min(self.moe_top_k, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            hybrid_period=hybrid_period,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            swa_window=(8 if self.swa_window else None),
            dtype="float32",
            vocab_pad_multiple=8,
            mrope_sections=(4, 2, 2),
        )
