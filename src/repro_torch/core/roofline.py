"""Operation-level roofline cost model — paper §4.1.1, Table 2.

For every operation the paper tabulates FLOPs and memory-scan cost for the
prefill and decode phases; latency is the roofline max of compute time and
memory time (Eq. 1):

    L_ops = max(FLOPs / FLOPS, MemScanCost * E / MemBW)

We reproduce Table 2 row-for-row for dense GQA transformer layers and extend
it (see DESIGN.md §5) with MoE FFN rows (active-expert FLOPs, routed tokens),
sliding-window attention (scan term capped at the window) and Mamba2 SSD
blocks (attention-free; linear-time scan) so the estimator covers every
assigned architecture.

Decode rows sum over output iterations t = 1..S_out in closed form:
    sum_{t} (S_in + t) = S_out*S_in + S_out*(S_out+1)/2
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.modelspec import LayerSpec, ModelSpec
from repro_torch.hw.profiles import DeviceProfile


@dataclasses.dataclass
class OpCost:
    name: str
    flops: float                # scalar, or ndarray over a batch axis
    scan_bytes: float           # MemScanCost * E  (already in bytes)

    def latency(self, dev: DeviceProfile) -> float:
        lc = self.flops / dev.flops_bf16
        lm = self.scan_bytes / dev.mem_bw
        return np.maximum(lc, lm)


def _decode_ctx_sum(s_in: int, s_out: int, window: Optional[int]) -> float:
    """sum_{t=1..S_out} ctx(t) where ctx = min(S_in + t, window or inf)."""
    if window is None or s_in + 1 <= window:
        if window is None or s_in + s_out <= window:
            return s_out * s_in + s_out * (s_out + 1) / 2.0
        # partially capped
        t_cap = max(0, window - s_in)          # steps before hitting window
        uncapped = t_cap * s_in + t_cap * (t_cap + 1) / 2.0
        capped = (s_out - t_cap) * window
        return uncapped + capped
    return float(s_out) * window


def layer_op_costs(l: LayerSpec, phase: str, batch: int, s_in: int,
                   s_out: int, d_tp: int, e: int = 2) -> List[OpCost]:
    """Paper Table 2 (+ extensions) for one layer, one phase.

    ``phase`` is "prefill" or "decode". Decode costs are totals over the
    whole S_out generation (matching Table 2's summed decode rows).
    """
    assert phase in ("prefill", "decode"), phase
    B, H = batch, l.hidden
    Hkv, Hq = l.kv_hidden, l.q_hidden
    ops: List[OpCost] = []

    if l.kind == "mamba2":
        return _mamba2_op_costs(l, phase, B, s_in, s_out, d_tp, e)

    if phase == "prefill":
        S = s_in
        # --- QKV projection -------------------------------------------------
        ops.append(OpCost(
            "qkv_proj",
            B * (2 * S * H * Hq + 4 * S * H * Hkv) / d_tp,
            (B * S * H + (H * Hq + 2 * H * Hkv) / d_tp) * e))
        # --- Attention (causal SDPA). SWA caps the key range. --------------
        ctx = S if l.window is None else min(S, l.window)
        ops.append(OpCost(
            "attention",
            4.0 * B * S * ctx * Hq / (2 * d_tp),   # causal => ~1/2 the pairs
            (B * S * Hq + 2 * B * min(S, ctx) * Hkv) / d_tp * e))
        # --- Output projection ---------------------------------------------
        ops.append(OpCost(
            "out_proj",
            2.0 * B * S * Hq * H / d_tp,
            (B * S * Hq + Hq * H / d_tp) * e))
        # --- FFN -------------------------------------------------------------
        ops.extend(_ffn_op_costs(l, B * S, d_tp, e, token_batch=B * S))
    else:
        So = s_out
        ops.append(OpCost(
            "qkv_proj",
            B * So * (2 * H * Hq + 4 * H * Hkv) / d_tp,
            So * (B * H + (H * Hq + 2 * H * Hkv) / d_tp) * e))
        ctx_sum = _decode_ctx_sum(s_in, So, l.window)
        ops.append(OpCost(
            "attention",
            4.0 * B * ctx_sum * Hq / d_tp,
            (So * B * Hq + 2 * B * ctx_sum * Hkv) / d_tp * e))
        ops.append(OpCost(
            "out_proj",
            2.0 * B * So * Hq * H / d_tp,
            So * (B * Hq + Hq * H / d_tp) * e))
        ops.extend(_ffn_op_costs(l, B * So, d_tp, e, token_batch=B,
                                 steps=So))
    return ops


def _ffn_op_costs(l: LayerSpec, total_tokens: float, d_tp: int, e: int,
                  token_batch: float, steps: int = 1) -> List[OpCost]:
    """FFN rows. For MoE: compute scales with top_k experts per token, while
    the weight *scan* term covers every expert that receives >=1 token —
    a decode batch of B tokens touches min(n_experts, B*top_k) experts."""
    H, F = l.hidden, l.ffn_dim
    up_mats = 2 if l.gated_ffn else 1
    if l.n_experts == 0:
        flops_up = 2.0 * up_mats * total_tokens * H * F / d_tp
        flops_dn = 2.0 * total_tokens * H * F / d_tp
        scan_up = (token_batch * H + up_mats * H * F / d_tp) * e * steps
        scan_dn = (token_batch * F / d_tp + H * F / d_tp) * e * steps
        return [OpCost("ffn_up_gate", flops_up, scan_up),
                OpCost("ffn_down", flops_dn, scan_dn)]
    # MoE
    k = l.top_k
    active_experts = np.minimum(l.n_experts, token_batch * k)
    flops_up = 2.0 * up_mats * total_tokens * k * H * F / d_tp
    flops_dn = 2.0 * total_tokens * k * H * F / d_tp
    router = 2.0 * total_tokens * H * l.n_experts
    scan_w = (up_mats + 1) * active_experts * H * F / d_tp * e * steps
    scan_act = (token_batch * (H + k * F / d_tp)) * e * steps
    return [OpCost("moe_router", router, token_batch * H * e * steps),
            OpCost("moe_ffn", flops_up + flops_dn, scan_w + scan_act)]


def _mamba2_op_costs(l: LayerSpec, phase: str, B: int, s_in: int,
                     s_out: int, d_tp: int, e: int) -> List[OpCost]:
    """Mamba2 SSD block — linear in sequence length.

    Per token: in_proj (H -> 2*d_inner + 2*N + heads), depthwise conv,
    SSD state update (heads * head_dim * N MACs), out_proj (d_inner -> H).
    """
    H = l.hidden
    d_inner = l.ssm_heads * l.ssm_head_dim
    N = l.ssm_state
    proj_in = H * (2 * d_inner + 2 * N + l.ssm_heads)
    proj_out = d_inner * H
    if phase == "prefill":
        T = B * s_in
        steps, token_batch = 1, B * s_in
    else:
        T = B * s_out
        steps, token_batch = s_out, B
    flops_proj = 2.0 * T * (proj_in + proj_out) / d_tp
    # SSD: dA state decay + B-outer-product update + C readout: ~6 MACs per
    # (head, head_dim, N) element per token.
    flops_ssd = 6.0 * T * l.ssm_heads * l.ssm_head_dim * N / d_tp
    flops_conv = 2.0 * T * l.conv_dim * (d_inner + 2 * N) / d_tp
    scan_w = (proj_in + proj_out) / d_tp * e * steps
    scan_state = token_batch * l.ssm_heads * l.ssm_head_dim * N / d_tp * e * steps
    scan_act = token_batch * (H + d_inner / d_tp) * e * steps
    return [OpCost("ssm_proj", flops_proj, scan_w + scan_act),
            OpCost("ssd_scan", flops_ssd + flops_conv,
                   scan_state + token_batch * d_inner / d_tp * e * steps)]


def logits_op_cost(spec: ModelSpec, phase: str, batch: int, s_in: int,
                   s_out: int, d_tp: int) -> OpCost:
    """Table 2 'Logits Calculation' row."""
    H, V, e = spec.hidden, spec.vocab, spec.dtype_bytes
    if phase == "prefill":
        # serving computes logits for the last position only in practice,
        # but the paper's table uses the full S_in; we follow the paper.
        flops = 2.0 * batch * s_in * H * V / d_tp
        scan = (batch * s_in * H + H * V / d_tp) * e
    else:
        flops = 2.0 * batch * s_out * H * V / d_tp
        scan = s_out * (batch * H + H * V / d_tp) * e
    return OpCost("logits", flops, scan)


@functools.lru_cache(maxsize=1 << 18)
def layer_latency(l: LayerSpec, dev: DeviceProfile, phase: str, batch: int,
                  s_in: int, s_out: int, d_tp: int, e: int = 2) -> float:
    """Memoized: uniform-layer models share one LayerSpec instance, so the
    DP's ~1e5 partial-placement evaluations hit this cache constantly."""
    return sum(op.latency(dev)
               for op in layer_op_costs(l, phase, batch, s_in, s_out, d_tp, e))


def layer_latency_array(l: LayerSpec, dev: DeviceProfile, phase: str,
                        batches: np.ndarray, s_in: int, s_out: int,
                        d_tp: int, e: int = 2) -> np.ndarray:
    """Vectorized :func:`layer_latency` over a batch-size axis.

    The Table 2 formulas are linear (or piecewise-linear, for MoE active
    experts) in the batch, so they broadcast directly over a numpy batch
    vector; one call evaluates the whole Eq. 6 batch grid that the
    placement-search prefix-sum tables (``repro_torch.core.eval_engine``) need.
    """
    out = np.zeros_like(batches, dtype=np.float64)
    for op in layer_op_costs(l, phase, batches, s_in, s_out, d_tp, e):
        out += op.latency(dev)
    return out


def layer_flops(l: LayerSpec, phase: str, batch: int, s_in: int, s_out: int,
                d_tp: int = 1, e: int = 2) -> float:
    return sum(op.flops
               for op in layer_op_costs(l, phase, batch, s_in, s_out, d_tp, e))
