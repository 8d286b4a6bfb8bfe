"""Optimization objective — paper §4.2.3, Eq. 7.

    argmax_p  Throughput(p)/Cost(p) * (1 - gamma * max(0, latency/SLO - 1))

gamma=0 (paper default) optimizes pure throughput-per-cost; gamma=inf makes
the SLO a hard constraint.

``tokens_per_req`` converts the numerator from requests/s to output
tokens/s, making the score the reciprocal of $/token (up to the 1/3600
$/hr scale): at a fixed workload point the argmax is unchanged, but the
scores become comparable *across* workload points — which is what the
histogram-weighted $/token objective (``core.buckets``) composes over the
(input-len, output-len) bucket grid.  ``cost_per_token`` reports the
actual dollar figure.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.estimator import PerfEstimate, Placement


@dataclasses.dataclass(frozen=True)
class Objective:
    gamma: float = 0.0
    slo_s: float = math.inf
    spot_pricing: bool = True
    # throughput-only mode (used by some baselines / ablations)
    per_cost: bool = True
    # > 0: score in output tokens/s (per $ when per_cost) instead of req/s
    tokens_per_req: float = 0.0

    def score(self, placement: Placement, perf: PerfEstimate) -> float:
        if perf.throughput_rps <= 0:
            return 0.0
        cost = placement.price_hr(spot=self.spot_pricing)
        base = perf.throughput_rps / cost if self.per_cost else perf.throughput_rps
        if self.tokens_per_req > 0:
            base *= self.tokens_per_req
        if self.gamma == 0.0 or math.isinf(self.slo_s):
            return base
        violation = max(0.0, perf.e2e_latency_s / self.slo_s - 1.0)
        if math.isinf(self.gamma):
            return 0.0 if violation > 0 else base
        return base * max(0.0, 1.0 - self.gamma * violation)


def cost_per_token(placement: Placement, perf: PerfEstimate,
                   tokens_per_req: float, spot: bool = True) -> float:
    """$ per output token of one placement at one workload point:
    (price/hr) / (3600 * rps * tokens/req).  inf when infeasible."""
    if perf.throughput_rps <= 0 or tokens_per_req <= 0:
        return math.inf
    return (placement.price_hr(spot=spot) / 3600.0
            / (perf.throughput_rps * tokens_per_req))
