"""Serving performance estimator — paper §4.1 (Eqs. 1, 4, 5).

Combines the op-level roofline costs (Table 2, ``repro_torch.core.roofline``) with
the alpha-beta communication model (``repro_torch.core.comm``) to predict per-stage
prefill/decode latency, end-to-end latency, and pipeline throughput for any
(placement x batch x sequence) point — no per-configuration profiling.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.core import comm, roofline
from repro_torch.core.modelspec import ModelSpec
from repro_torch.hw.profiles import DeviceProfile, InstanceProfile


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline stage: a layer range on (part of) one instance."""

    instance: InstanceProfile
    tp: int                       # devices used on this instance for TP
    n_layers: int                 # decoder layers assigned
    first: bool = False           # holds the input embedding
    last: bool = False            # holds the LM head (logits)
    n_encoder_layers: int = 0     # whisper-style encoder prefix

    @property
    def device(self) -> DeviceProfile:
        return self.instance.device

    @property
    def mem_bytes(self) -> float:
        return self.tp * self.device.mem_gb * 1e9

    def price_hr(self, spot: bool) -> float:
        frac = self.tp / self.instance.num_devices
        p = (self.instance.price_spot_hr if spot
             else self.instance.price_ondemand_hr)
        return p * frac

    def intra_link(self) -> comm.Link:
        return comm.Link(self.device.intra_alpha_s, self.device.intra_beta_bps)

    def inter_link(self) -> comm.Link:
        return comm.Link(self.instance.inter_alpha_s,
                         self.instance.inter_beta_bps)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A full pipeline placement: ordered stages covering all layers."""

    spec: ModelSpec
    stages: Tuple[Stage, ...]

    def __post_init__(self):
        assert sum(s.n_layers for s in self.stages) == self.spec.n_layers, \
            (sum(s.n_layers for s in self.stages), self.spec.n_layers)

    @property
    def d_pp(self) -> int:
        return len(self.stages)

    def layer_ranges(self) -> List[Tuple[int, int]]:
        out, lo = [], 0
        for s in self.stages:
            out.append((lo, lo + s.n_layers))
            lo += s.n_layers
        return out

    def price_hr(self, spot: bool = False) -> float:
        return sum(s.price_hr(spot) for s in self.stages)

    def describe(self) -> str:
        parts = [f"{s.instance.name}:tp{s.tp}:{s.n_layers}L"
                 for s in self.stages]
        return " | ".join(parts)


@dataclasses.dataclass
class PerfEstimate:
    batch: int
    prefill_stage_s: List[float]
    decode_stage_s: List[float]          # totals over S_out steps
    ttft_s: float
    tpot_s: float
    e2e_latency_s: float
    throughput_rps: float


# ---------------------------------------------------------------------------

# Eq. 6 defaults — the fast engine (repro_torch.core.eval_engine) imports these so
# the two implementations can never drift apart.
ACT_HEADROOM = 0.9
DEFAULT_BATCH_CAP = 512


def activation_bytes_per_seq(spec: ModelSpec, s_in: int, tp: int) -> float:
    """Activation working set one request pins on a stage: a few live
    (S, H) tensors for prefill; the 4x covers residual + ffn intermediates
    under remat-free inference."""
    return 4.0 * s_in * spec.hidden * spec.dtype_bytes / max(1, tp)


def stage_weight_bytes(spec: ModelSpec, stage: Stage, lo: int, hi: int) -> float:
    e = spec.dtype_bytes
    w = sum(spec.layers[i].weight_bytes(e) for i in range(lo, hi))
    if stage.first:
        w += spec.vocab * spec.hidden * e
        w += sum(l.weight_bytes(e) for l in spec.encoder_layers)
    if stage.last and not spec.tie_embeddings:
        w += spec.vocab * spec.hidden * e
    return w


def stage_kv_bytes_per_seq(spec: ModelSpec, lo: int, hi: int, s_in: int,
                           s_out: int) -> float:
    """KV + SSM-state bytes one request pins on this stage (Eq 6 denom).

    Full attention: (S_in+S_out) tokens per layer; SWA: capped at window;
    Mamba2: constant state. This is the SSM/SWA-aware refinement of Eq. 6
    described in DESIGN.md §5.
    """
    e = spec.dtype_bytes
    total = 0.0
    for i in range(lo, hi):
        l = spec.layers[i]
        tokens = s_in + s_out
        if l.window is not None:
            tokens = min(tokens, l.window)
        total += l.kv_bytes_per_token(e) * tokens + l.state_bytes_per_seq(e)
    return total


def max_batch_size(spec: ModelSpec, placement: Placement, s_in: int,
                   s_out: int, act_headroom: float = ACT_HEADROOM,
                   cap: int = DEFAULT_BATCH_CAP) -> int:
    """Paper Eq. 6: largest B satisfying every stage's memory constraint.

    Refinement (documented): the activation term scales with B, so we solve
        B = (M*headroom - W) / (kv_per_seq + act_per_seq)
    instead of subtracting a fixed M_activation.
    """
    best = cap
    for stage, (lo, hi) in zip(placement.stages, placement.layer_ranges()):
        w = stage_weight_bytes(spec, stage, lo, hi)
        kv = stage_kv_bytes_per_seq(spec, lo, hi, s_in, s_out)
        act = activation_bytes_per_seq(spec, s_in, stage.tp)
        avail = stage.mem_bytes * act_headroom - w
        if avail <= 0:
            return 0
        denom = kv + act
        if denom <= 0:
            continue
        best = min(best, int(avail // denom))
    return max(0, best)


def stage_latencies(spec: ModelSpec, placement: Placement, batch: int,
                    s_in: int, s_out: int
                    ) -> Tuple[List[float], List[float]]:
    """Per-stage prefill and decode (total over S_out) latency, including TP
    collectives (Eq. 3) and the PP hand-off (Eq. 2) out of each stage."""
    e = spec.dtype_bytes
    prefill, decode = [], []
    for stage, (lo, hi) in zip(placement.stages, placement.layer_ranges()):
        dev = stage.device
        lp = ld = 0.0
        for i in range(lo, hi):
            l = spec.layers[i]
            lp += roofline.layer_latency(l, dev, "prefill", batch, s_in,
                                         s_out, stage.tp, e)
            ld += roofline.layer_latency(l, dev, "decode", batch, s_in,
                                         s_out, stage.tp, e)
        if stage.first:
            for l in spec.encoder_layers:
                lp += roofline.layer_latency(l, dev, "prefill", batch, s_in,
                                             0, stage.tp, e)
        if stage.last:
            lp += roofline.logits_op_cost(spec, "prefill", batch, s_in,
                                          s_out, stage.tp).latency(dev)
            ld += roofline.logits_op_cost(spec, "decode", batch, s_in,
                                          s_out, stage.tp).latency(dev)
        # TP collectives (2 AllReduce / layer, Eq. 3)
        link = stage.intra_link()
        n_l = hi - lo
        lp += comm.tp_comm_latency(batch, s_in, spec.hidden, stage.tp, n_l,
                                   link, e)
        ld += comm.tp_comm_latency(batch, 1, spec.hidden, stage.tp, n_l,
                                   link, e) * s_out
        # PP hand-off to the next stage (Eq. 2)
        if not stage.last or placement.d_pp > 1:
            ilink = stage.inter_link()
            lp += comm.pp_comm_latency(batch, s_in, spec.hidden, ilink, e)
            ld += comm.pp_comm_latency(batch, 1, spec.hidden, ilink, e) * s_out
        prefill.append(lp)
        decode.append(ld)
    return prefill, decode


def estimate(spec: ModelSpec, placement: Placement, s_in: int, s_out: int,
             batch: Optional[int] = None) -> PerfEstimate:
    """Full paper pipeline: Eq. 6 batch -> Eq. 1 latencies -> Eq. 5 -> Eq. 4."""
    if batch is None:
        batch = max_batch_size(spec, placement, s_in, s_out)
    if batch <= 0:
        return PerfEstimate(0, [], [], math.inf, math.inf, math.inf, 0.0)
    pre, dec = stage_latencies(spec, placement, batch, s_in, s_out)
    # Eq. 5: bottleneck-stage latency per phase (pipelined steady state).
    l_b = max(pre) + max(dec)
    rps = batch / l_b if l_b > 0 else 0.0          # Eq. 4
    ttft = sum(pre)                                 # first token: full path
    tpot = sum(d / s_out for d in dec)              # per-token, full path
    e2e = sum(pre) + sum(dec)
    return PerfEstimate(batch, pre, dec, ttft, tpot, e2e, rps)
