"""Analytical model specification consumed by the roofline estimator.

This is the *estimator-side* view of an architecture: just enough structure
to evaluate paper Table 2 (FLOPs + memory-scan per operation) for every layer
and phase. The executable PyTorch modules live in ``repro_torch.models``;
both are constructed from the same ``repro_torch.configs`` entries so the
analytical plane and the execution plane can never drift apart.

Layer kinds:
  * "attn+ffn"   — standard transformer decoder layer (GQA dense FFN)
  * "attn+moe"   — transformer layer with top-k MoE FFN
  * "mamba2"     — Mamba2 SSD mixer block (attention-free)
  * "shared_attn"— Zamba2-style full transformer block spliced into the
                   Mamba2 trunk (own KV cache per application)
  * "enc"        — encoder self-attn layer (whisper encoder; no KV growth)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str                     # see module docstring
    hidden: int                   # H
    n_heads: int
    n_kv_heads: int
    head_dim: int
    ffn_dim: int                  # dense FFN intermediate (0 for mamba2)
    gated_ffn: bool = True        # SwiGLU-style (up+gate) vs plain MLP
    window: Optional[int] = None  # sliding-window attention width
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    conv_dim: int = 4

    @property
    def kv_hidden(self) -> int:
        """H_kv in paper Table 2 = n_kv_heads * head_dim."""
        return self.n_kv_heads * self.head_dim

    @property
    def q_hidden(self) -> int:
        return self.n_heads * self.head_dim

    def weight_bytes(self, e: int = 2) -> float:
        """Parameter bytes of this layer (all experts counted — Eq 6 uses
        *capacity*, not active compute)."""
        h = self.hidden
        if self.kind == "mamba2":
            d_inner = self.ssm_heads * self.ssm_head_dim
            # in_proj (z,x,B,C,dt) + conv + out_proj + norms (approx exact
            # per mamba2 param layout).
            in_proj = h * (2 * d_inner + 2 * self.ssm_state + self.ssm_heads)
            conv = self.conv_dim * (d_inner + 2 * self.ssm_state)
            out_proj = d_inner * h
            return (in_proj + conv + out_proj + 2 * h) * e
        attn = h * self.q_hidden + 2 * h * self.kv_hidden + self.q_hidden * h
        if self.n_experts > 0:
            per_expert = (3 if self.gated_ffn else 2) * h * self.ffn_dim
            ffn = self.n_experts * per_expert + h * self.n_experts  # + router
        else:
            ffn = (3 if self.gated_ffn else 2) * h * self.ffn_dim
        return (attn + ffn + 2 * h) * e

    def kv_bytes_per_token(self, e: int = 2) -> float:
        """KV-cache bytes one token adds on this layer (Eq 6 denominator).

        mamba2 layers contribute 0 here — their state is constant-size and
        accounted separately via ``state_bytes_per_seq``.
        """
        if self.kind == "mamba2":
            return 0.0
        return 2 * self.kv_hidden * e

    def state_bytes_per_seq(self, e: int = 2) -> float:
        """Constant per-sequence state (SSM state + conv buffer)."""
        if self.kind != "mamba2":
            return 0.0
        d_inner = self.ssm_heads * self.ssm_head_dim
        return (self.ssm_heads * self.ssm_head_dim * self.ssm_state
                + self.conv_dim * (d_inner + 2 * self.ssm_state)) * e


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    layers: Tuple[LayerSpec, ...]
    hidden: int
    vocab: int
    dtype_bytes: int = 2
    tie_embeddings: bool = False
    encoder_layers: Tuple[LayerSpec, ...] = ()   # enc-dec models

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    def weight_bytes_total(self) -> float:
        e = self.dtype_bytes
        emb = self.vocab * self.hidden * e
        head = 0 if self.tie_embeddings else self.vocab * self.hidden * e
        enc = sum(l.weight_bytes(e) for l in self.encoder_layers)
        return emb + head + enc + sum(l.weight_bytes(e) for l in self.layers)

    def params_total(self) -> float:
        return self.weight_bytes_total() / self.dtype_bytes

    def params_active(self) -> float:
        """Active params per token (MoE: top_k experts only)."""
        e = self.dtype_bytes
        tot = self.vocab * self.hidden * (1 if self.tie_embeddings else 2)
        for l in self.layers + self.encoder_layers:
            if l.n_experts > 0:
                per_expert = (3 if l.gated_ffn else 2) * l.hidden * l.ffn_dim
                dense = l.weight_bytes(e) / e - l.n_experts * per_expert
                tot += dense + l.top_k * per_expert
            else:
                tot += l.weight_bytes(e) / e
        return tot


def uniform_decoder(name: str, n_layers: int, hidden: int, n_heads: int,
                    n_kv_heads: int, ffn_dim: int, vocab: int,
                    head_dim: Optional[int] = None, gated: bool = True,
                    window: Optional[int] = None, n_experts: int = 0,
                    top_k: int = 0, dtype_bytes: int = 2,
                    tie_embeddings: bool = False) -> ModelSpec:
    hd = head_dim or hidden // n_heads
    kind = "attn+moe" if n_experts else "attn+ffn"
    layer = LayerSpec(kind, hidden, n_heads, n_kv_heads, hd, ffn_dim,
                      gated_ffn=gated, window=window, n_experts=n_experts,
                      top_k=top_k)
    return ModelSpec(name, (layer,) * n_layers, hidden, vocab,
                     dtype_bytes=dtype_bytes, tie_embeddings=tie_embeddings)
