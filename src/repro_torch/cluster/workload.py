"""Workload generation: Azure-Conversation-like request traces (paper §7).

The paper uses the Azure LLM inference conversation trace (1h, fluctuating
arrivals; after pruning >2048-token inputs: mean input 763, mean output 232,
mean rate 4.67 req/s). We generate a statistically matched trace: lognormal
input/output lengths clipped to [16, 2048] / [8, 1024] with the paper's
means, and a doubly-stochastic (bursty) arrival process.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    arrival_s: float
    s_in: int
    s_out: int


def _lognormal_with_mean(rng, mean: float, sigma: float, size: int):
    mu = math.log(mean) - sigma ** 2 / 2.0
    return rng.lognormal(mu, sigma, size)


def diurnal_rate(t_s: float, peak_factor: float = 2.0,
                 period_s: float = 86400.0, phase_s: float = 0.0) -> float:
    """Smooth day/night multiplier around 1.0: peaks at ``peak_factor``,
    troughs at ``2 - peak_factor`` (floored at 0.1). Multi-region sweeps
    phase-shift this per region so load follows the sun."""
    swing = peak_factor - 1.0
    x = 1.0 + swing * math.sin(2.0 * math.pi * (t_s - phase_s) / period_s)
    return max(0.1, x)


def azure_conversation_like(duration_s: float = 3600.0,
                            rate_rps: float = 4.67,
                            mean_in: float = 763.0,
                            mean_out: float = 232.0,
                            max_in: int = 2048,
                            max_out: int = 1024,
                            burstiness: float = 0.6,
                            seed: int = 0,
                            rate_profile=None) -> List[Request]:
    """Bursty arrivals: piecewise-constant rate modulated by a lognormal
    AR(1) process (15s segments), Poisson within a segment.

    rate_profile: optional ``f(t_s) -> multiplier`` composed on top of the
    AR(1) burstiness (e.g. ``diurnal_rate``) — deterministic macro trend
    over stochastic micro bursts. None keeps the trace bit-identical to
    the pre-profile generator."""
    rng = np.random.RandomState(seed)
    seg = 15.0
    n_seg = int(math.ceil(duration_s / seg))
    # AR(1) log-rate modulation
    log_mod = np.zeros(n_seg)
    for i in range(1, n_seg):
        log_mod[i] = 0.8 * log_mod[i - 1] + rng.normal(0, burstiness * 0.5)
    mod = np.exp(log_mod - np.mean(log_mod))
    mod = mod / np.mean(mod)
    reqs: List[Request] = []
    rid = 0
    for i in range(n_seg):
        lam = rate_rps * mod[i] * seg
        if rate_profile is not None:
            lam *= rate_profile((i + 0.5) * seg)
        n = rng.poisson(lam)
        times = np.sort(rng.uniform(i * seg, min((i + 1) * seg, duration_s),
                                    n))
        s_ins = np.clip(_lognormal_with_mean(rng, mean_in, 0.9, n), 16,
                        max_in).astype(int)
        s_outs = np.clip(_lognormal_with_mean(rng, mean_out, 0.9, n), 8,
                         max_out).astype(int)
        for t, si, so in zip(times, s_ins, s_outs):
            reqs.append(Request(rid, float(t), int(si), int(so)))
            rid += 1
    return reqs


def scale_rate(reqs: List[Request], factor: float) -> List[Request]:
    """Paper §7.2.2: scale arrival *intervals* by ``factor`` (keep pattern)."""
    return [dataclasses.replace(r, rid=i, arrival_s=r.arrival_s * factor)
            for i, r in enumerate(reqs)]


def length_histogram(reqs: List[Request], buckets=None) -> List[List[float]]:
    """Normalized (input-len, output-len) bucket weights of a trace — the
    traffic histogram the $/token placement objective
    (``core.buckets.HistogramCostObjective``) and bucket-aware dispatch
    are parameterized by."""
    from repro_torch.core.buckets import workload_histogram
    return workload_histogram([(r.s_in, r.s_out) for r in reqs], buckets)


def zipf_shared_prompts(n: int, n_prefixes: int = 4, prefix_len: int = 48,
                        suffix_len: int = 8, share_ratio: float = 0.5,
                        vocab: int = 32000, zipf_a: float = 1.2,
                        seed: int = 0) -> List[List[int]]:
    """Token-level prompts with production-like prefix reuse: a
    ``share_ratio`` fraction of prompts opens with one of ``n_prefixes``
    common system prompts (chosen Zipf-distributed, so a few prefixes are
    hot and the tail is cold — the regime where a prefix-sharing KV cache
    pays off), followed by a unique suffix; the rest are fully unique.
    Token ids start at 1 (0 is reserved as pad across the repo)."""
    rng = np.random.RandomState(seed)
    def draw(m):
        return (rng.randint(0, vocab - 1, size=m) + 1).tolist()
    prefixes = [draw(prefix_len) for _ in range(n_prefixes)]
    # Zipf over prefix ranks, truncated to the available set
    ranks = np.arange(1, n_prefixes + 1, dtype=float)
    pz = ranks ** -zipf_a
    pz /= pz.sum()
    prompts: List[List[int]] = []
    for _ in range(n):
        if rng.rand() < share_ratio:
            pick = int(rng.choice(n_prefixes, p=pz))
            prompts.append(prefixes[pick] + draw(suffix_len))
        else:
            prompts.append(draw(prefix_len + suffix_len))
    return prompts
