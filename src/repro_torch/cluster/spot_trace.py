"""Spot availability traces + scenario selection (paper §2.2 / §7.2).

Availability per instance pool is a Markov on/off birth-death process whose
stationary availability and volatility are calibrated to the paper's
observations: high-end pools (p5/p6-class) rarely available (H100 28.64% of
the time, B200 never), mid-tier pools (g5/g6/g6e) more stable with
complementary patterns.

Scenario extraction follows §7.2: every candidate window gets a composite
score = (number of availability-change events) x (magnitude of affected
instances); the highest-scoring window is the worst-case evaluation
scenario. ~40% of windows score zero (no changes) in the paper — the
calibrated generator reproduces that regime.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PoolModel:
    """Markov model of one spot pool's available capacity."""
    name: str
    capacity: int                # instances the pool can offer when healthy
    p_loss_per_min: float        # chance an available instance is reclaimed
    p_gain_per_min: float        # chance an unavailable slot comes back
    correlated: float = 0.3      # prob. a loss event takes out many at once


PAPER_POOLS: Dict[str, PoolModel] = {
    # mid-tier: relatively stable, complementary. Loss rates calibrated so
    # ~40% of candidate 50-min windows see zero availability changes
    # (paper §7.2: 40.4% of 1701 windows scored zero).
    "g6.12xlarge": PoolModel("g6.12xlarge", 8, 0.0015, 0.04, 0.55),
    "g5.12xlarge": PoolModel("g5.12xlarge", 6, 0.0018, 0.04, 0.55),
    "g6e.xlarge": PoolModel("g6e.xlarge", 10, 0.0020, 0.04, 0.55),
    # high-end: scarce (paper: H100 28.64% availability, B200 never)
    "p5.48xlarge": PoolModel("p5.48xlarge", 2, 0.05, 0.02, 0.6),
    "p6.48xlarge": PoolModel("p6.48xlarge", 1, 1.0, 0.0, 1.0),
    # TPU analogs
    "v5e-8": PoolModel("v5e-8", 16, 0.004, 0.05, 0.25),
    "v4-8": PoolModel("v4-8", 10, 0.005, 0.05, 0.25),
    "v5p-8": PoolModel("v5p-8", 3, 0.03, 0.02, 0.5),
}


@dataclasses.dataclass
class AvailabilityTrace:
    """Per-minute available counts per pool."""
    minutes: int
    counts: Dict[str, np.ndarray]

    def events(self) -> List[Tuple[float, str, int]]:
        """(time_s, pool, delta) for every change."""
        out = []
        for pool, series in self.counts.items():
            for t in range(1, len(series)):
                d = int(series[t]) - int(series[t - 1])
                if d != 0:
                    out.append((t * 60.0, pool, d))
        return sorted(out)


def generate_trace(pools: Dict[str, PoolModel], minutes: int = 8640,
                   seed: int = 0) -> AvailabilityTrace:
    rng = np.random.RandomState(seed)
    counts = {}
    for name, pm in pools.items():
        avail = pm.capacity
        series = np.zeros(minutes, np.int32)
        for t in range(minutes):
            # reclaim events
            if avail > 0 and rng.rand() < pm.p_loss_per_min * avail:
                if rng.rand() < pm.correlated:
                    lost = rng.randint(1, avail + 1)   # correlated shortage
                else:
                    lost = 1
                avail -= lost
            # capacity returns
            missing = pm.capacity - avail
            if missing > 0 and rng.rand() < pm.p_gain_per_min * missing:
                avail += rng.randint(1, missing + 1)
            series[t] = max(0, min(pm.capacity, avail))
        counts[name] = series
    return AvailabilityTrace(minutes, counts)


@dataclasses.dataclass(frozen=True)
class RegionSpec:
    """One region's (or cloud's) spot market: its pool set plus a
    region-level *capacity crunch* process. A crunch minute reclaims a
    fraction of EVERY pool in the region simultaneously — the SkyServe
    observation that preemptions correlate within a region/zone (demand
    surges hit the whole market, not one instance type), which is the
    regime where single-region clusters lose all replicas at once and
    multi-region placement pays off."""
    name: str
    pools: Dict[str, PoolModel]
    crunch_per_min: float = 0.0   # chance a region-wide crunch hits
    crunch_frac: float = 0.5      # fraction of each pool's avail reclaimed


def scaled_pools(scale: int, pools: Optional[Dict[str, PoolModel]] = None
                 ) -> Dict[str, PoolModel]:
    """PAPER_POOLS with capacities multiplied by ``scale`` — the knob that
    takes the paper's 24-GPU market to the 100–1000-node regime."""
    src = PAPER_POOLS if pools is None else pools
    return {n: dataclasses.replace(pm, capacity=pm.capacity * scale)
            for n, pm in src.items()}


def generate_multi_region_trace(regions: Sequence[RegionSpec],
                                minutes: int = 8640,
                                seed: int = 0) -> AvailabilityTrace:
    """Joint availability trace over several regions. Pool keys are
    namespaced ``region/pool`` (the simulator scopes these to pipelines
    placed in that region). Per-pool dynamics are the same Markov on/off
    process as ``generate_trace``; on top, each region's crunch process
    reclaims ``crunch_frac`` of every pool's available capacity in the
    same minute — correlated interruptions by construction. Regions draw
    from independent streams, so adding one never perturbs another."""
    counts: Dict[str, np.ndarray] = {}
    for ri, reg in enumerate(regions):
        rng = np.random.RandomState(seed * 7919 + ri)
        avail = {n: pm.capacity for n, pm in reg.pools.items()}
        series = {n: np.zeros(minutes, np.int32) for n in reg.pools}
        for t in range(minutes):
            crunch = (reg.crunch_per_min > 0
                      and rng.rand() < reg.crunch_per_min)
            for name, pm in reg.pools.items():
                a = avail[name]
                if crunch and a > 0:
                    a -= max(1, int(math.ceil(reg.crunch_frac * a)))
                if a > 0 and rng.rand() < pm.p_loss_per_min * a:
                    if rng.rand() < pm.correlated:
                        lost = rng.randint(1, a + 1)
                    else:
                        lost = 1
                    a -= lost
                missing = pm.capacity - a
                if missing > 0 and rng.rand() < pm.p_gain_per_min * missing:
                    a += rng.randint(1, missing + 1)
                avail[name] = max(0, min(pm.capacity, a))
                series[name][t] = avail[name]
        for name in reg.pools:
            counts[f"{reg.name}/{name}"] = series[name]
    return AvailabilityTrace(minutes, counts)


def correlated_interruption_count(events: Sequence[Tuple[float, str, int]]
                                  ) -> int:
    """Instances reclaimed by CORRELATED events: drops where ≥ 2 pools of
    the same region lose capacity in the same minute (the signature a
    region crunch leaves in the event stream). Bare (un-namespaced) pool
    names are skipped — correlation is a region-level notion."""
    drops: Dict[Tuple[float, str], int] = {}
    pools_hit: Dict[Tuple[float, str], set] = {}
    for (t, pool, d) in events:
        if d >= 0 or "/" not in pool:
            continue
        region = pool.rsplit("/", 1)[0]
        key = (t, region)
        drops[key] = drops.get(key, 0) - d
        pools_hit.setdefault(key, set()).add(pool)
    return sum(c for k, c in drops.items() if len(pools_hit[k]) >= 2)


def window_score(trace: AvailabilityTrace, start_min: int, dur_min: int,
                 pools: Optional[Sequence[str]] = None) -> float:
    """Paper §7.2 composite score: event frequency x affected magnitude.
    ``pools`` restricts scoring to the pools the evaluation cluster uses."""
    score = 0.0
    for pool, series in trace.counts.items():
        if pools is not None and pool not in pools:
            continue
        w = series[start_min:start_min + dur_min]
        diffs = np.diff(w)
        drops = diffs[diffs < 0]
        score += len(diffs[diffs != 0]) * float(np.sum(-drops))
    return score


def select_scenario(trace: AvailabilityTrace, dur_min: int = 50,
                    stride_min: int = 5,
                    pools: Optional[Sequence[str]] = None
                    ) -> Tuple[int, float, float]:
    """Worst-case window: (start_min, score, zero_score_fraction)."""
    scores = []
    for s in range(0, trace.minutes - dur_min, stride_min):
        scores.append((window_score(trace, s, dur_min, pools=pools), s))
    zero_frac = sum(1 for sc, _ in scores if sc == 0) / max(1, len(scores))
    best_score, best_start = max(scores)
    return best_start, best_score, zero_frac


def interruption_events_for_window(trace: AvailabilityTrace, start_min: int,
                                   dur_min: int) -> List[Tuple[float, str, int]]:
    """(t_rel_s, pool, delta) events inside the selected window."""
    out = []
    for pool, series in trace.counts.items():
        w = series[start_min:start_min + dur_min + 1]
        for t in range(1, len(w)):
            d = int(w[t]) - int(w[t - 1])
            if d != 0:
                out.append((t * 60.0, pool, d))
    return sorted(out)
