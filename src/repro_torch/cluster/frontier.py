"""Cost-vs-SLO frontier sweep over the discrete-event cluster simulator.

The paper evaluates fault tolerance at fixed settings (Fig 16); the
operational question is the *frontier*: for a given workload and spot
market, which (spot mix, grace period, recovery policy) settings are
Pareto-optimal in ($/Mtok, p99 latency) space?  This driver sweeps that
grid through ``ClusterSim`` — each cell one deterministic simulation over
the same request trace and interruption events — and reports the points
plus the Pareto front, validating ROADMAP items 2–3 (SLO tiers, kernel
speedups) against cluster economics before they touch real hardware.

Axes:
- spot_frac: fraction of pipelines on spot capacity (the rest run
  on-demand: immune to reclaims, billed at the OD rate).
- grace_s: reclaim notice window (clouds differ: 30s–600s).
- policy: recovery mechanism policy ('recompute' | 'transfer' | 'hybrid',
  see cluster/recovery.py).

Usage:
    pts = sweep_frontier(spec, placements, requests, duration_s, events)
    front = pareto_front(pts)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster.network import Topology
from repro_torch.cluster.simulator import ClusterSim, FTConfig, SimResult
from repro_torch.cluster.workload import Request
from repro_torch.core.estimator import Placement
from repro_torch.core.modelspec import ModelSpec


@dataclasses.dataclass(frozen=True)
class FrontierPoint:
    spot_frac: float
    grace_s: float
    policy: str
    cost_usd: float
    cost_per_mtok: float          # $ per million generated tokens
    p99_ttft_s: float
    p99_tpot_s: float
    rps: float
    downtime_s: float
    interruptions: int

    def dominates(self, other: "FrontierPoint") -> bool:
        """Pareto dominance on (cost_per_mtok, p99_ttft_s, p99_tpot_s):
        no worse on all, strictly better on one."""
        a = (self.cost_per_mtok, self.p99_ttft_s, self.p99_tpot_s)
        b = (other.cost_per_mtok, other.p99_ttft_s, other.p99_tpot_s)
        return all(x <= y for x, y in zip(a, b)) and a != b


def _point(res: SimResult, spot_frac: float, grace_s: float,
           policy: str) -> FrontierPoint:
    out_tokens = sum(r.generated for r in res.completed)
    mtok = max(out_tokens, 1) / 1e6
    return FrontierPoint(
        spot_frac=spot_frac, grace_s=grace_s, policy=policy,
        cost_usd=res.cost_usd, cost_per_mtok=res.cost_usd / mtok,
        p99_ttft_s=res.percentile("ttft", 0.99),
        p99_tpot_s=res.percentile("tpot", 0.99),
        rps=res.rps, downtime_s=res.total_downtime_s,
        interruptions=res.interruptions)


def sweep_frontier(spec: ModelSpec, pipelines: Sequence[Placement],
                   requests: Sequence[Request], duration_s: float,
                   events: Sequence[Tuple[float, str, int]] = (),
                   spot_fracs: Sequence[float] = (0.0, 0.5, 1.0),
                   graces: Sequence[float] = (30.0, 120.0),
                   policies: Sequence[str] = ("recompute", "hybrid"),
                   ft_base: Optional[FTConfig] = None,
                   network_factory: Optional[Callable[[], Topology]] = None,
                   regions: Optional[Sequence[str]] = None,
                   mean_s_in: int = 763, mean_s_out: int = 232,
                   efficiency: float = 1.0,
                   on_point: Optional[Callable[[FrontierPoint], None]] = None
                   ) -> List[FrontierPoint]:
    """One deterministic ``ClusterSim`` run per grid cell, all over the
    SAME trace/events, so differences are attributable to the knobs.
    The spot mix converts the first ``(1-frac)*N`` pipelines to
    on-demand (deterministic split — pipelines are interchangeable under
    the weighted-RR dispatcher). ``network_factory`` builds a FRESH
    topology per cell (links are stateful); None runs closed-form."""
    ft_base = ft_base or FTConfig()
    n = len(pipelines)
    points: List[FrontierPoint] = []
    for frac in spot_fracs:
        n_spot = int(round(frac * n))
        spot_mask = [i >= n - n_spot for i in range(n)]
        for grace in graces:
            for policy in policies:
                ft = dataclasses.replace(
                    ft_base, grace_period_s=grace, recovery_policy=policy,
                    kv_store_migration=(ft_base.kv_store_migration
                                        and policy != "recompute"))
                net = network_factory() if network_factory else None
                sim = ClusterSim(spec, pipelines, ft,
                                 mean_s_in=mean_s_in, mean_s_out=mean_s_out,
                                 efficiency=efficiency, network=net,
                                 regions=regions, spot=spot_mask)
                res = sim.run(requests, duration_s, events=events)
                pt = _point(res, frac, grace, policy)
                points.append(pt)
                if on_point is not None:
                    on_point(pt)
    return points


def pareto_front(points: Sequence[FrontierPoint]) -> List[FrontierPoint]:
    """Non-dominated subset, sorted by cost."""
    front = [p for p in points
             if not any(q.dominates(p) for q in points if q is not p)]
    return sorted(front, key=lambda p: (p.cost_per_mtok, p.p99_ttft_s))
