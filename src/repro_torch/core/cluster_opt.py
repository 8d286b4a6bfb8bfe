"""Cluster-level pipeline extraction — paper §4.2.1 (last paragraph).

"ShuntServe employs this efficient optimization process iteratively, allowing
it to greedily extract the desired number of pipeline configurations to
populate the serving system."

Each extracted pipeline consumes its instances from the inventory (whole
instances — the fault-isolation rule), then the optimizer re-runs on the
remainder until no feasible pipeline is left or ``max_pipelines`` is hit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.estimator import Placement
from repro_torch.core.eval_engine import FastEstimator
from repro_torch.core.modelspec import ModelSpec
from repro_torch.core.objective import Objective
from repro_torch.core.placement import PlacementOptimizer, SearchResult
from repro_torch.hw.profiles import InstanceProfile


@dataclasses.dataclass
class ClusterPlan:
    pipelines: List[Placement]
    throughputs_rps: List[float]
    leftover_inventory: Dict[str, int]
    wall_time_s: float

    @property
    def total_rps(self) -> float:
        return sum(self.throughputs_rps)

    def price_hr(self, spot: bool = True) -> float:
        return sum(p.price_hr(spot) for p in self.pipelines)

    def weights(self) -> List[float]:
        """Weighted round-robin dispatch weights (paper §3)."""
        tot = self.total_rps
        if tot <= 0:
            return [1.0 / max(1, len(self.pipelines))] * len(self.pipelines)
        return [t / tot for t in self.throughputs_rps]


def populate_cluster(spec: ModelSpec, inventory: Dict[str, int],
                     instances: Dict[str, InstanceProfile], s_in: int,
                     s_out: int, objective: Optional[Objective] = None,
                     beam_k: int = 3, max_pipelines: int = 64,
                     min_score_frac: float = 0.0,
                     max_tp: Optional[int] = None) -> ClusterPlan:
    import time
    t0 = time.perf_counter()
    inv = dict(inventory)
    pipelines: List[Placement] = []
    rps: List[float] = []
    first_score: Optional[float] = None
    # one table engine shared by every extraction iteration: the prefix-sum
    # tables depend only on (spec, s_in, s_out), not on the shrinking
    # inventory, so re-plans after spot interruptions pay no rebuild cost.
    engine = FastEstimator(spec, s_in, s_out)
    while len(pipelines) < max_pipelines:
        avail = {n: c for n, c in inv.items() if c > 0}
        if not avail:
            break
        opt = PlacementOptimizer(spec, avail, instances, s_in, s_out,
                                 objective=objective, beam_k=beam_k,
                                 max_tp=max_tp, engine=engine)
        res = opt.search()
        if res.placement is None or res.throughput_rps <= 0:
            break
        if first_score is None:
            first_score = res.score
        elif res.score < min_score_frac * first_score:
            break
        pipelines.append(res.placement)
        rps.append(res.throughput_rps)
        # consume whole instances (fault isolation: no instance sharing
        # across pipelines)
        dev_used: Dict[str, int] = {}
        for s in res.placement.stages:
            dev_used[s.instance.name] = dev_used.get(s.instance.name, 0) + s.tp
        for name, devs in dev_used.items():
            per = instances[name].num_devices
            inv[name] = inv.get(name, 0) - math.ceil(devs / per)
    return ClusterPlan(pipelines, rps, inv, time.perf_counter() - t0)
