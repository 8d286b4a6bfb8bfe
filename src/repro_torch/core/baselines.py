"""Baseline placement algorithms the paper compares against (§7.1.2).

All baselines are *evaluated through the same estimator* as ShuntServe so the
comparison isolates the placement algorithm (exactly how the paper's offline
evaluation treats them — each system's algorithm decides the placement, the
same engine serves it).  Scoring goes through the prefix-sum table engine
(``repro_torch.core.eval_engine``), which is pinned to the reference estimator by
tests — so the Fig 9/10 planners all speed up together.

  * ``vllm_even``       — vLLM: homogeneous groups, even layer partition,
                          intra-node TP (one pipeline per instance group).
  * ``alpaserve_dp``    — AlpaServe-style: homogeneous groups; two-phase
                          optimization (cluster grouping + DP that equalizes
                          stage latencies); prefers replication for SLO.
  * ``hexgen_genetic``  — HexGen-style: genetic algorithm over heterogeneous
                          assignments with memory-proportional layer
                          allocation and local-perturbation mutations.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cluster_opt import ClusterPlan
from repro_torch.core.estimator import Placement, Stage
from repro_torch.core.eval_engine import FastEstimator
from repro_torch.core.modelspec import ModelSpec
from repro_torch.core.objective import Objective
from repro_torch.hw.profiles import InstanceProfile


def _even_split(n_layers: int, k: int) -> List[int]:
    base, rem = divmod(n_layers, k)
    return [base + (1 if i < rem else 0) for i in range(k)]


def _mark_ends(stages: List[Stage]) -> Tuple[Stage, ...]:
    return tuple(
        dataclasses.replace(s, first=(i == 0), last=(i == len(stages) - 1))
        for i, s in enumerate(stages))


# ---------------------------------------------------------------------------
# vLLM: per homogeneous instance-type group, TP = intra-node, PP = enough
# nodes to fit the model, even layer split. One or more identical pipelines
# per group.
# ---------------------------------------------------------------------------
def vllm_even(spec: ModelSpec, inventory: Dict[str, int],
              instances: Dict[str, InstanceProfile], s_in: int,
              s_out: int) -> ClusterPlan:
    import time
    t0 = time.perf_counter()
    engine = FastEstimator(spec, s_in, s_out)
    pipelines, rps = [], []
    for name, count in inventory.items():
        if count <= 0:
            continue
        inst = instances[name]
        # smallest PP depth whose pipeline fits
        for d_pp in range(1, count + 1):
            split = _even_split(spec.n_layers, d_pp)
            if any(s <= 0 for s in split):
                break
            stages = _mark_ends([
                Stage(inst, inst.num_devices, nl) for nl in split])
            placement = Placement(spec, stages)
            perf = engine.estimate(placement)
            if perf.batch > 0:
                n_pipes = count // d_pp
                pipelines.extend([placement] * n_pipes)
                rps.extend([perf.throughput_rps] * n_pipes)
                break
    return ClusterPlan(pipelines, rps, {}, time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# AlpaServe-style: homogeneous groups; for each group enumerate (replicas,
# d_pp) splits; DP equalizes stage *latency* (not layer count); pick the
# grouping that maximizes aggregate goodput with a replication preference.
# ---------------------------------------------------------------------------
def _latency_balanced_split(spec: ModelSpec, inst: InstanceProfile,
                            d_pp: int, engine: FastEstimator) -> List[int]:
    """DP that minimizes the max per-stage latency over contiguous splits.

    Per-layer prefill+decode latency at batch 1 comes from the prefix-sum
    tables — one row read instead of 2n roofline evaluations."""
    n = spec.n_layers
    lat = engine.table(inst, inst.num_devices).per_layer_latency(0)
    prefix = [0.0]
    for v in lat:
        prefix.append(prefix[-1] + v)
    INF = math.inf
    # dp[s][i] = min over splits of first i layers into s stages of max stage
    dp = [[INF] * (n + 1) for _ in range(d_pp + 1)]
    cut = [[0] * (n + 1) for _ in range(d_pp + 1)]
    dp[0][0] = 0.0
    for s in range(1, d_pp + 1):
        for i in range(s, n + 1):
            for j in range(s - 1, i):
                v = max(dp[s - 1][j], prefix[i] - prefix[j])
                if v < dp[s][i]:
                    dp[s][i], cut[s][i] = v, j
    # recover split
    splits, i = [], n
    for s in range(d_pp, 0, -1):
        j = cut[s][i]
        splits.append(i - j)
        i = j
    return list(reversed(splits))


def alpaserve_dp(spec: ModelSpec, inventory: Dict[str, int],
                 instances: Dict[str, InstanceProfile], s_in: int,
                 s_out: int, prefer_replication: bool = True) -> ClusterPlan:
    import time
    t0 = time.perf_counter()
    engine = FastEstimator(spec, s_in, s_out)
    pipelines, rps = [], []
    for name, count in inventory.items():
        if count <= 0:
            continue
        inst = instances[name]
        best: Optional[Tuple[float, List[Placement], List[float]]] = None
        for d_pp in range(1, count + 1):
            n_rep = count // d_pp
            if n_rep <= 0:
                continue
            split = _latency_balanced_split(spec, inst, d_pp, engine)
            if any(s <= 0 for s in split):
                continue
            stages = _mark_ends([
                Stage(inst, inst.num_devices, nl) for nl in split])
            placement = Placement(spec, stages)
            perf = engine.estimate(placement)
            if perf.batch <= 0:
                continue
            total = perf.throughput_rps * n_rep
            # replication preference: break near-ties toward more replicas
            # (AlpaServe's statistical-multiplexing bias).
            bias = 1.0 + (0.05 * n_rep if prefer_replication else 0.0)
            key = total * bias
            if best is None or key > best[0]:
                best = (key, [placement] * n_rep,
                        [perf.throughput_rps] * n_rep)
        if best:
            pipelines.extend(best[1])
            rps.extend(best[2])
    return ClusterPlan(pipelines, rps, {}, time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# HexGen-style genetic search.
# ---------------------------------------------------------------------------
def _memory_proportional_split(spec: ModelSpec, stages: List[Stage]
                               ) -> List[int]:
    """HexGen distributes layers proportional to stage memory capacity."""
    mems = [s.mem_bytes for s in stages]
    tot = sum(mems)
    n = spec.n_layers
    raw = [m / tot * n for m in mems]
    split = [max(1, int(r)) for r in raw]
    # fix rounding to sum exactly n
    while sum(split) > n:
        split[split.index(max(split))] -= 1
    while sum(split) < n:
        split[split.index(min(split))] += 1
    return split


def hexgen_genetic(spec: ModelSpec, inventory: Dict[str, int],
                   instances: Dict[str, InstanceProfile], s_in: int,
                   s_out: int, pop_size: int = 24, generations: int = 30,
                   seed: int = 0, objective: Optional[Objective] = None
                   ) -> ClusterPlan:
    """Genetic algorithm: a genome is a partition of the device inventory
    into pipelines of (instance, tp) stages; layers are allocated
    memory-proportionally, then refined by local perturbation (HexGen §5)."""
    import time
    t0 = time.perf_counter()
    rng = random.Random(seed)
    objective = objective or Objective()
    engine = FastEstimator(spec, s_in, s_out)
    dev_inv = {n: c * instances[n].num_devices for n, c in inventory.items()}

    def random_genome() -> List[List[Tuple[str, int]]]:
        # HexGen initializes groups from communication topology => stages
        # drawn per-instance; pipelines greedily filled until memory fits.
        inv = dict(dev_inv)
        pipes: List[List[Tuple[str, int]]] = []
        names = [n for n in inv if inv[n] > 0]
        while names:
            pipe: List[Tuple[str, int]] = []
            target_mem = spec.weight_bytes_total() * 1.3
            got = 0.0
            guard = 0
            while got < target_mem and guard < 64:
                guard += 1
                names = [n for n in inv if inv[n] > 0]
                if not names:
                    break
                n = rng.choice(names)
                inst = instances[n]
                tp = rng.choice([d for d in (1, 2, 4, 8)
                                 if d <= min(inst.num_devices, inv[n])])
                inv[n] -= tp
                pipe.append((n, tp))
                got += tp * inst.device.mem_gb * 1e9
            if pipe and got >= spec.weight_bytes_total():
                pipes.append(pipe)
            elif not pipe:
                break
            names = [n for n in inv if inv[n] > 0]
        return pipes

    def genome_to_plan(genome) -> ClusterPlan:
        pipelines, rps = [], []
        for pipe in genome:
            stages = [Stage(instances[n], tp, 1) for n, tp in pipe]
            split = _memory_proportional_split(spec, stages)
            if len(split) != len(stages) or any(x <= 0 for x in split):
                continue
            stages = _mark_ends([
                dataclasses.replace(s, n_layers=nl)
                for s, nl in zip(stages, split)])
            try:
                placement = Placement(spec, stages)
            except AssertionError:
                continue
            perf = engine.estimate(placement)
            if perf.batch <= 0:
                continue
            pipelines.append(placement)
            rps.append(perf.throughput_rps)
        return ClusterPlan(pipelines, rps, {}, 0.0)

    def fitness(genome) -> float:
        plan = genome_to_plan(genome)
        if not plan.pipelines:
            return 0.0
        cost = plan.price_hr(spot=True)
        return plan.total_rps / cost if cost > 0 else 0.0

    def mutate(genome):
        g = [list(p) for p in genome]
        if not g:
            return g
        # local perturbation: move a stage between pipelines or re-roll tp
        op = rng.random()
        pi = rng.randrange(len(g))
        if op < 0.5 and len(g[pi]) > 1:
            si = rng.randrange(len(g[pi]))
            stage = g[pi].pop(si)
            g[rng.randrange(len(g))].append(stage)
        else:
            si = rng.randrange(len(g[pi]))
            n, tp = g[pi][si]
            choices = [d for d in (1, 2, 4, 8)
                       if d <= instances[n].num_devices]
            g[pi][si] = (n, rng.choice(choices))
        return [p for p in g if p]

    pop = [random_genome() for _ in range(pop_size)]
    scored = sorted(((fitness(g), i, g) for i, g in enumerate(pop)),
                    key=lambda x: -x[0])
    for gen in range(generations):
        elite = [g for _, _, g in scored[:max(2, pop_size // 4)]]
        children = [mutate(rng.choice(elite))
                    for _ in range(pop_size - len(elite))]
        pop = elite + children
        scored = sorted(((fitness(g), i, g) for i, g in enumerate(pop)),
                        key=lambda x: -x[0])
    best = scored[0][2]
    plan = genome_to_plan(best)
    plan.wall_time_s = time.perf_counter() - t0
    return plan
