"""Registry of the configs the port serves: dense GQA, MoE, SSM, hybrid,
the M-RoPE VLM and the encoder-decoder (values copied from
``repro/configs/<id>.py``; the key set equals the reference's)."""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig

QWEN3_32B = ArchConfig(
    name="qwen3-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=25600, vocab=151936,
    norm="rmsnorm", gated_ffn=True, act="silu", rope_theta=1_000_000.0,
    supports_decode=True, subquadratic=False,
    source="arXiv:2505.09388 (paper eval model)")

LLAMA31_70B = ArchConfig(
    name="llama-3.1-70b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=28672, vocab=128256, norm="rmsnorm",
    gated_ffn=True, act="silu", rope_theta=500_000.0, supports_decode=True,
    subquadratic=False, source="arXiv:2407.21783 (paper eval model)")

QWEN2_0_5B = ArchConfig(
    name="qwen2-0.5b", family="dense", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, d_ff=4864, vocab=151936, qkv_bias=True,
    norm="rmsnorm", gated_ffn=True, act="silu", tie_embeddings=True,
    rope_theta=1_000_000.0, supports_decode=True, subquadratic=False,
    source="arXiv:2407.10671; hf")

INTERNLM2_1_8B = ArchConfig(
    name="internlm2-1.8b", family="dense", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, d_ff=8192, vocab=92544, norm="rmsnorm",
    gated_ffn=True, act="silu", rope_theta=1_000_000.0,
    supports_decode=True, subquadratic=False,
    source="arXiv:2403.17297; hf")

H2O_DANUBE3_4B = ArchConfig(
    name="h2o-danube-3-4b", family="dense", n_layers=24, d_model=3840,
    n_heads=32, n_kv_heads=8, d_ff=10240, vocab=32000, swa_window=4096,
    norm="rmsnorm", gated_ffn=True, act="silu", rope_theta=10_000.0,
    supports_decode=True, subquadratic=True,
    source="arXiv:2401.16818; unverified")

PHI35_MOE_42B_A6_6B = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=6400, vocab=32064, n_experts=16,
    moe_top_k=2, norm="layernorm", gated_ffn=True, act="silu",
    rope_theta=10_000.0, supports_decode=True, subquadratic=False,
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf")

GRANITE_MOE_3B_A800M = ArchConfig(
    name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, d_ff=512, vocab=49155, n_experts=40,
    moe_top_k=8, norm="rmsnorm", gated_ffn=True, act="silu",
    tie_embeddings=True, rope_theta=10_000.0, supports_decode=True,
    subquadratic=False,
    source="hf:ibm-granite/granite-3.0-3b-a800m-base; hf")

# SSD (state-space duality), attention-free: d_inner 4096, 64 SSD heads
MAMBA2_1_3B = ArchConfig(
    name="mamba2-1.3b", family="ssm", n_layers=48, d_model=2048, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab=50280, ssm_state=128, ssm_head_dim=64,
    ssm_expand=2, conv_width=4, norm="rmsnorm", gated_ffn=False, act="silu",
    tie_embeddings=True, supports_decode=True, subquadratic=True,
    source="arXiv:2405.21060; unverified")

# Mamba2 trunk + one shared attention block (over concat(x, x0)) every 6
# trunk layers, each application with its own KV cache
ZAMBA2_2_7B = ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000, head_dim=80,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, hybrid_period=6,
    norm="rmsnorm", gated_ffn=True, act="silu", rope_theta=10_000.0,
    supports_decode=True, subquadratic=True,
    source="arXiv:2411.15242; hf")

# Cohere: GQA 96/8, LayerNorm, tied embeddings
COMMAND_R_PLUS_104B = ArchConfig(
    name="command-r-plus-104b", family="dense", n_layers=64, d_model=12288,
    n_heads=96, n_kv_heads=8, d_ff=33792, vocab=256000, norm="layernorm",
    gated_ffn=True, act="silu", tie_embeddings=True,
    rope_theta=75_000_000.0, supports_decode=True, subquadratic=False,
    source="hf:CohereForAI/c4ai-command-r-plus; unverified")

# M-RoPE over (temporal, height, width) position streams; the vision tower
# is a stub: prefill takes patch embeddings (B, S, d_model) and positions
# (3, B, S)
QWEN2_VL_2B = ArchConfig(
    name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, d_ff=8960, vocab=151936, qkv_bias=True,
    m_rope=True, mrope_sections=(16, 24, 24), norm="rmsnorm",
    gated_ffn=True, act="silu", tie_embeddings=True,
    rope_theta=1_000_000.0, frontend="vision_embeds", supports_decode=True,
    subquadratic=False, source="arXiv:2409.12191; hf")

# encoder-decoder with absolute sinusoidal positions (no RoPE); the audio
# frontend is a stub: the encoder takes frame embeddings (B, S_enc, d_model)
WHISPER_TINY = ArchConfig(
    name="whisper-tiny", family="audio", n_layers=4, n_encoder_layers=4,
    d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865,
    qkv_bias=True, o_bias=True, mlp_bias=True, norm="layernorm",
    gated_ffn=False, act="gelu", tie_embeddings=True,
    frontend="audio_frames", rope_theta=0.0, supports_decode=True,
    subquadratic=False, source="arXiv:2212.04356; unverified")

REGISTRY: Dict[str, ArchConfig] = {c.name: c for c in (
    QWEN3_32B, LLAMA31_70B, QWEN2_0_5B, INTERNLM2_1_8B, H2O_DANUBE3_4B,
    PHI35_MOE_42B_A6_6B, GRANITE_MOE_3B_A800M, MAMBA2_1_3B, ZAMBA2_2_7B,
    COMMAND_R_PLUS_104B, QWEN2_VL_2B, WHISPER_TINY)}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; repro_torch serves {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ArchConfig", "REGISTRY", "get_config"]
