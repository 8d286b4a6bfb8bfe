"""Registry of the configs the port serves, dense GQA, MoE, SSM and hybrid
(values copied from ``repro/configs/<id>.py``)."""

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

REGISTRY: Dict[str, ArchConfig] = {c.name: c for c in (
    QWEN3_32B, LLAMA31_70B, QWEN2_0_5B, INTERNLM2_1_8B, H2O_DANUBE3_4B,
    PHI35_MOE_42B_A6_6B, GRANITE_MOE_3B_A800M, MAMBA2_1_3B, ZAMBA2_2_7B)}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; repro_torch serves {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ArchConfig", "REGISTRY", "get_config"]
