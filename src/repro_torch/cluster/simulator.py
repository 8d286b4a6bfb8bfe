"""Discrete-event cluster serving simulator (iteration-level).

Reproduces the paper's evaluation methodology at any scale (24 GPUs to
1000+ nodes): pipelines run continuous batching whose per-iteration timing
comes from the SAME roofline estimator the placement optimizer uses; spot
interruptions, grace periods, output-preserving request migration and
concurrent initialization follow §5 / §7.2; cost accounting follows §7.2.3.

Architecture: a typed Event/handler core (``cluster/events.py``) over a
priority queue, with network links (``cluster/network.py``) as first-class
contended resources.  Two timing modes:

- ``network=None`` (default): the legacy closed-form timeline — every
  transfer priced as a constant, links assumed idle.  Kept as the
  uncontended-limit baseline.
- ``network=Topology(...)``: replacement-node warm-up is an actual
  transfer on the region's store link, overlapped with serving and
  contended with concurrent KV-publish / restore / prefix-warm traffic;
  ``recovery.decide`` pricing is re-derived from link state at decision
  time.  On an idle link the DES reproduces the closed form to float
  precision (parity gate in tests/test_cluster_des.py).

Fault-tolerance timeline per interruption (defaults = paper Fig 16):

  t_int                      notice; grace until t_int + grace (serving OK)
  CI:    warm-up transfer submitted at t_int + provision on the store
         link; ready = max(warmup_end, t_int + provision + engine_init)
         (idle link: = t_int + provision + max(store_load, engine_init))
         downtime = [grace_end, max(ready, grace_end)]
  no CI: old pipeline must die first (duplicate-memory OOM), and the fresh
         engine loads weights itself: warm-up submitted at
         max(grace_end, t_int + provision); ready = warmup_end + engine_init
  migration on: in-flight requests re-queued with generated tokens preserved
         (recompute = prefill over s_in + generated);
  off:   restart from scratch (all progress lost).

Link-contention model: store links serialize transmissions FIFO by
submission time (see network.py), so two simultaneous warm-ups in one
region queue behind each other and the second pipeline revives later —
the effect the closed form cannot express.  Pool-preemption round trips
(``kv_pool_tokens``) stay node-local (host-memory store, no network) per
``recovery.preemption_seconds``.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster import events as ev
from repro_torch.cluster.network import Topology, Transfer
from repro_torch.cluster.workload import Request
from repro_torch.core.estimator import (Placement, estimate,
                                  max_batch_size, stage_latencies)
from repro_torch.core.modelspec import ModelSpec


@dataclasses.dataclass
class FTConfig:
    use_spot: bool = True
    request_migration: bool = True
    concurrent_init: bool = True
    grace_period_s: float = 120.0
    node_provision_s: float = 41.55      # paper Fig 16 means
    store_load_s: float = 61.85
    engine_init_s: float = 64.51
    # 'recompute' (paper §5.1 default) | 'transfer' | 'hybrid' (§8.1 future
    # work, implemented in cluster/recovery.py)
    recovery_policy: str = "recompute"
    # engine chunked-prefill size for migration recompute (0 = single-shot);
    # prices re-admission via recovery.recompute_seconds(chunk=...)
    prefill_chunk: int = 0
    # paged engines publishing KV blocks to the shared tensor store during
    # the grace window (serving/server.py use_kv_migration): opens
    # recovery.decide's kv_restore branch — re-admission attaches blocks
    # instead of recomputing the context
    kv_store_migration: bool = False
    # per-pipeline KV block-pool capacity in TOKENS (0 = unbounded). Models
    # the demand-paged engine's overcommitted pool: when the live contexts
    # outgrow it mid-decode, the fewest-generated request is preempted to
    # the node-local store and re-admission is priced like a SELF-INFLICTED
    # kv_restore (recovery.preemption_seconds) instead of a re-prefill
    kv_pool_tokens: int = 0
    # networked mode: bytes of hot-prefix cache a revived replacement node
    # warms from the store (serving/server.py warm-up path). Rides the
    # store link at revival — pure background traffic, charged to no
    # request, but contending with concurrent warm-ups.
    prefix_warm_bytes: float = 0.0


@dataclasses.dataclass
class ReqState:
    req: Request
    generated: int = 0
    admit_s: float = -1.0
    first_token_s: float = -1.0
    finish_s: float = -1.0
    migrations: int = 0
    # KV arrived via transfer or store restore: no re-prefill on re-admit
    transfer_recovered: bool = False
    # evicted by pool pressure: re-admit pays the preemption round trip
    kv_preempted: bool = False
    # region whose store holds this request's KV (networked restores that
    # land on a pipeline elsewhere ride the cross-region link)
    src_region: str = ""


class SimPipeline:
    def __init__(self, pid: int, spec: ModelSpec, placement: Placement,
                 mean_s_in: int, mean_s_out: int,
                 proto: Optional["SimPipeline"] = None,
                 region: str = "local"):
        """``proto``: an already-built pipeline over the SAME placement
        object — estimator results and timing caches are shared with it,
        so replicating one placement across hundreds of nodes costs one
        estimator evaluation, not hundreds."""
        self.pid = pid
        self.spec = spec
        self.placement = placement
        self.region = region
        self.spot = True      # False = on-demand node: never reclaimed
        if proto is not None and proto.placement is placement \
                and proto.mean_s_in == mean_s_in:
            self.b_max = proto.b_max
            self.weight = proto.weight
            self._iter_cache = proto._iter_cache          # shared dicts
            self._prefill_cache = proto._prefill_cache
        else:
            self.b_max = max(1, max_batch_size(spec, placement, mean_s_in,
                                               mean_s_out))
            perf = estimate(spec, placement, mean_s_in, mean_s_out)
            self.weight = max(perf.throughput_rps, 1e-6)
            self._iter_cache: Dict[int, float] = {}
            self._prefill_cache: Dict[Tuple[int, int, bool], float] = {}
        self.mean_s_in = mean_s_in
        self.eff = 1.0
        self.queue: List[ReqState] = []
        self.active: List[ReqState] = []
        self.alive = True
        self.next_free = 0.0          # busy-until (one iteration at a time)
        self.wake_pending = False
        # pools whose member was already replaced by the ON-DEMAND fallback
        # (paper §8.2: auxiliary on-demand fallback) — immune to further
        # spot events from that pool
        self.replaced_pools: set = set()
        self.down_until = 0.0

    def t_iter(self, batch: int) -> float:
        if batch not in self._iter_cache:
            pre, dec = stage_latencies(self.spec, self.placement, batch,
                                       self.mean_s_in, 1)
            self._iter_cache[batch] = max(dec)
        return self._iter_cache[batch] / self.eff

    def t_prefill(self, batch: int, s_in: int, pipelined: bool = True
                  ) -> float:
        """Admission prefill cost. ``pipelined`` charges the bottleneck
        stage (stages overlap in steady state — consistent with Eq. 5);
        sum-of-stages is the TTFT view, not the throughput view."""
        s_b = max(64, (s_in // 128) * 128)
        key = (batch, s_b, pipelined)
        if key not in self._prefill_cache:
            pre, _ = stage_latencies(self.spec, self.placement, batch, s_b, 1)
            self._prefill_cache[key] = max(pre) if pipelined else sum(pre)
        return self._prefill_cache[key] / self.eff

    def instances(self) -> List[str]:
        return [s.instance.name for s in self.placement.stages]

    def price_hr(self, spot: bool) -> float:
        return self.placement.price_hr(spot)


@dataclasses.dataclass
class SimResult:
    completed: List[ReqState]
    unfinished: List[ReqState]
    duration_s: float
    cost_usd: float
    downtime_s: Dict[int, float]
    interruptions: int
    kv_preemptions: int = 0
    # networked mode: per-link {"n", "bytes", "busy_s", "wait_s"}
    link_stats: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    transfers: int = 0

    @property
    def rps(self) -> float:
        return len(self.completed) / self.duration_s

    @property
    def makespan_rps(self) -> float:
        """Offline throughput: completed / time-of-last-completion (the
        window-based ratio saturates at the workload arrival rate once the
        cluster outruns the trace)."""
        if not self.completed:
            return 0.0
        makespan = max(r.finish_s for r in self.completed)
        return len(self.completed) / max(makespan, 1e-9)

    @property
    def total_downtime_s(self) -> float:
        return sum(self.downtime_s.values())

    def latencies(self, kind: str = "e2e") -> List[float]:
        out = []
        for r in self.completed:
            if kind == "e2e":
                out.append(r.finish_s - r.req.arrival_s)
            elif kind == "ttft":
                out.append(r.first_token_s - r.req.arrival_s)
            elif kind == "tpot":
                if r.req.s_out > 1 and r.first_token_s >= 0:
                    out.append((r.finish_s - r.first_token_s)
                               / max(1, r.req.s_out - 1))
        return out

    def percentile(self, kind: str, q: float) -> float:
        xs = sorted(self.latencies(kind))
        if not xs:
            return float("nan")
        i = min(len(xs) - 1, int(q * len(xs)))
        return xs[i]

    def mean(self, kind: str) -> float:
        xs = self.latencies(kind)
        return sum(xs) / len(xs) if xs else float("nan")


class ClusterSim:
    """Iteration-level continuous-batching simulation (discrete-event)."""

    def __init__(self, spec: ModelSpec, pipelines: Sequence[Placement],
                 ft: FTConfig, mean_s_in: int = 763, mean_s_out: int = 232,
                 seed: int = 0, efficiency: float = 1.0,
                 network: Optional[Topology] = None,
                 regions: Optional[Sequence[str]] = None,
                 spot: Optional[Sequence[bool]] = None):
        """efficiency: achieved/roofline serving efficiency. The estimator
        gives roofline-optimal iteration times; real engines (vLLM on L4s in
        the paper) land well below. Benchmarks calibrate this once against
        the paper's measured ShuntServe throughput (§7.1.2) so absolute
        scales match while all RELATIVE comparisons come from our model.

        network: a ``Topology`` switches transfer timing from closed-form
        constants to contended link transmissions (see module docstring).
        regions: per-pipeline region name (parallel to ``pipelines``;
        default all "local") — selects each pipeline's store link and
        scopes region-qualified pool events ("region/pool").
        spot: per-pipeline spot flag (default all True with
        ``ft.use_spot``). False = an on-demand node: billed at the OD
        rate and immune to pool reclaims — the frontier sweep's spot-mix
        axis."""
        self.spec = spec
        self.ft = ft
        self.efficiency = max(1e-3, efficiency)
        self.network = network
        if regions is not None and len(regions) != len(pipelines):
            raise ValueError("regions must parallel pipelines")
        if spot is not None and len(spot) != len(pipelines):
            raise ValueError("spot must parallel pipelines")
        shared: Dict[int, SimPipeline] = {}
        self.pipes: List[SimPipeline] = []
        for i, p in enumerate(pipelines):
            reg = regions[i] if regions is not None else "local"
            sp = SimPipeline(i, spec, p, mean_s_in, mean_s_out,
                             proto=shared.get(id(p)), region=reg)
            if spot is not None:
                sp.spot = bool(spot[i])
            shared.setdefault(id(p), sp)
            self.pipes.append(sp)
        for p in self.pipes:
            p.eff = self.efficiency
        self._rr = 0.0
        self._rr_credit = [0.0] * len(self.pipes)
        self.interruptions = 0
        self.kv_preemptions = 0
        self.downtime: Dict[int, float] = defaultdict(float)
        self.extra_cost = 0.0
        self._od_fallbacks: List[Tuple[float, float]] = []  # (t, delta_$/hr)
        self._orphans: List[ReqState] = []   # buffered while no pipeline up
        self.seed = seed
        self.transfer_log: List[Transfer] = []
        self._q: Optional[ev.EventQueue] = None
        self._completed: List[ReqState] = []

    # -- dispatch ------------------------------------------------------------
    def _dispatch(self, r: ReqState) -> Optional[SimPipeline]:
        """Throughput-weighted round robin over alive pipelines (paper §3)."""
        alive = [p for p in self.pipes if p.alive]
        if not alive:
            return None
        for p in self.pipes:
            if p.alive:
                self._rr_credit[p.pid] += p.weight
        best = max(alive, key=lambda p: self._rr_credit[p.pid])
        self._rr_credit[best.pid] -= sum(p.weight for p in alive)
        best.queue.append(r)
        return best

    # -- pools / regions -----------------------------------------------------
    @staticmethod
    def _pool_base(pool: str) -> str:
        return pool.rsplit("/", 1)[-1]

    def _pool_matches(self, pool: str, p: SimPipeline) -> bool:
        """Legacy bare pool names ("g6.12xlarge") match any region;
        region-qualified names ("us-east/g6.12xlarge") match only
        pipelines placed in that region. On-demand pipelines never match
        (reclaims only take spot capacity)."""
        if not p.spot:
            return False
        if "/" in pool and pool.rsplit("/", 1)[0] != p.region:
            return False
        return self._pool_base(pool) in p.instances()

    def _submit(self, link, t: float, kind: str, nbytes: float) -> Transfer:
        tr = link.submit(t, kind, nbytes)
        self.transfer_log.append(tr)
        if self._q is not None:
            self._q.push(tr.end_s, ev.TransferDone(tr))
        return tr

    # -- interruption handling -----------------------------------------------
    def _interrupt_pipeline(self, pipe: SimPipeline, t: float,
                            requeue: List[ReqState], pool: str = ""):
        ft = self.ft
        net = self.network
        self.interruptions += 1
        grace_end = t + ft.grace_period_s
        link = net.store_link(pipe.region) if net is not None else None
        # KV publishes ride the store link during the grace window: the
        # dying engine pushes every migrating request's blocks to the
        # region store (serving/server.py use_kv_migration). Overlapped
        # with serving — charged to nobody — but they occupy the link any
        # concurrent warm-up must queue behind.
        if net is not None and ft.kv_store_migration \
                and ft.request_migration:
            from repro_torch.cluster.recovery import kv_bytes_for_ctx
            for r in list(pipe.active) + list(pipe.queue):
                if r.generated > 0:
                    self._submit(link, t, "kv_publish",
                                 kv_bytes_for_ctx(self.spec,
                                                  r.req.s_in + r.generated))
        if ft.concurrent_init:
            if net is None:
                ready = t + ft.node_provision_s + max(ft.store_load_s,
                                                      ft.engine_init_s)
            else:
                # replacement provisions for node_provision_s, then fetches
                # weights from the region store as a real transfer; engine
                # init overlaps the fetch (CI = both proceed concurrently)
                wu = self._submit(link, t + ft.node_provision_s, "warmup",
                                  link.bytes_for_duration(ft.store_load_s))
                ready = max(wu.end_s,
                            t + ft.node_provision_s + ft.engine_init_s)
            down_start = grace_end
            down_end = max(ready, grace_end)
            # replacement billed from t; old billed to grace_end: the overlap
            # (grace_end - t) double-bills one node (paper: ~$1.10)
            overlap_h = (grace_end - t) / 3600.0
            inst = pipe.placement.stages[0]
            self.extra_cost += inst.price_hr(ft.use_spot) * overlap_h
        else:
            if net is None:
                ready = (max(grace_end, t + ft.node_provision_s)
                         + ft.store_load_s + ft.engine_init_s)
            else:
                wu = self._submit(link,
                                  max(grace_end, t + ft.node_provision_s),
                                  "warmup",
                                  link.bytes_for_duration(ft.store_load_s))
                ready = wu.end_s + ft.engine_init_s
            down_start, down_end = grace_end, ready
        pipe.down_until = down_end
        self.downtime[pipe.pid] += down_end - down_start
        # restores happen after revival: the wait they inherit is whatever
        # link backlog outlives the downtime window (0 on an idle link —
        # the closed-form equivalence), re-derived here at decision time
        store_wait = 0.0
        if net is not None:
            store_wait = max(0.0, link.busy_until - down_end)
        # at grace end the old engine dies: migrate or restart in-flight work
        for r in list(pipe.active) + list(pipe.queue):
            # a pool-preempted payload lived in the dying node's local
            # store: it does not survive the interruption, so re-admission
            # must be priced by the recovery policy, not as a restore
            r.kv_preempted = False
            if not self.ft.request_migration:
                r.generated = 0
                r.first_token_s = -1.0
            elif (self.ft.recovery_policy != "recompute"
                  and r.generated > 0):
                from repro_torch.cluster.recovery import decide
                d = decide(self.spec, pipe.placement,
                           r.req.s_in + r.generated, ft.grace_period_s,
                           policy=self.ft.recovery_policy,
                           efficiency=self.efficiency,
                           chunk=self.ft.prefill_chunk,
                           store_has_kv=self.ft.kv_store_migration,
                           store_wait_s=store_wait)
                # KV arrived by wire (transfer) or from the store
                # (kv_restore): either way re-admission skips re-prefill
                r.transfer_recovered = d.mechanism in ("transfer",
                                                       "kv_restore")
                r.src_region = pipe.region
            r.admit_s = -1.0
            r.migrations += 1
            requeue.append(r)
        pipe.active.clear()
        pipe.queue.clear()
        pipe.alive = False
        pipe.replaced_pools.add(pool)
        # the replacement runs on-demand until the window ends: bill the
        # price delta from now (accounted in _total_cost). The delta comes
        # from the interrupted pipeline's own matching stage instance, so
        # synthetic (non-catalog) instances price correctly too.
        base = self._pool_base(pool)
        delta_hr = 0.0
        for s in pipe.placement.stages:
            if s.instance.name == base:
                delta_hr = (s.instance.price_ondemand_hr
                            - s.instance.price_spot_hr)
                break
        else:
            from repro_torch.hw.profiles import ALL_INSTANCES
            inst = ALL_INSTANCES.get(base)
            if inst is not None:
                delta_hr = inst.price_ondemand_hr - inst.price_spot_hr
        self._od_fallbacks.append((t, delta_hr))

    # -- event handlers ------------------------------------------------------
    def _push_wake(self, t_w: float, pipe: SimPipeline):
        if pipe.wake_pending:
            return
        pipe.wake_pending = True
        self._q.push(t_w, ev.Wake(pipe.pid))

    def _on_arrive(self, t: float, e: ev.Arrive):
        r = e.req
        p = self._dispatch(r)
        if p is None:
            self._orphans.append(r)   # total outage: buffer
        elif p.alive:
            self._push_wake(max(t, p.next_free), p)

    def _on_interrupt(self, t: float, e: ev.Interrupt):
        requeue: List[ReqState] = []
        hit = 0
        for p in self.pipes:
            if hit >= e.count:
                break
            if (p.alive and self._pool_matches(e.pool, p)
                    and e.pool not in p.replaced_pools):
                self._interrupt_pipeline(p, t, requeue, e.pool)
                hit += 1
                self._q.push(p.down_until, ev.Revive(p.pid))
        for r in requeue:
            p = self._dispatch(r)
            if p is None:
                self._orphans.append(r)
            elif p.alive:
                self._push_wake(max(t, p.next_free), p)

    def _on_revive(self, t: float, e: ev.Revive):
        p = self.pipes[e.pid]
        p.alive = True
        p.next_free = t
        # replacement node warms the hot-prefix cache from the store —
        # background traffic on the region link (server.py warm-up path)
        if self.network is not None and self.ft.prefix_warm_bytes > 0:
            self._submit(self.network.store_link(p.region), t,
                         "prefix_warm", self.ft.prefix_warm_bytes)
        if self._orphans:        # flush buffered requests
            orphans, self._orphans = self._orphans, []
            for r in orphans:
                q = self._dispatch(r)
                if q is None:
                    self._orphans.append(r)
        self._push_wake(t, p)

    def _on_wake(self, t: float, e: ev.Wake):
        p = self.pipes[e.pid]
        p.wake_pending = False
        if not p.alive:
            return
        if t < p.next_free - 1e-12:      # still mid-iteration
            self._push_wake(p.next_free, p)
            return
        dt = self._pipeline_iteration(p, t, self._completed)
        if dt > 0:
            p.next_free = t + dt
            self._push_wake(t + dt, p)

    def _on_transfer_done(self, t: float, e: ev.TransferDone):
        # completion bookkeeping only: serialized links fix end times at
        # submit, so nothing re-plans here — but the event keeps transfer
        # lifecycles on the queue in time order for tracing/extension
        pass

    # -- main loop -----------------------------------------------------------
    def run(self, requests: Sequence[Request], duration_s: float,
            events: Sequence[Tuple[float, str, int]] = (),
            offline: bool = False) -> SimResult:
        """events: (t_s, pool_name, delta) availability changes (delta<0
        interrupts pipelines containing instances of that pool; pool may
        be region-qualified as "region/pool")."""
        arrivals = sorted(requests, key=lambda r: r.arrival_s)
        if offline:
            arrivals = [dataclasses.replace(r, arrival_s=0.0)
                        for r in arrivals]
        self._q = ev.EventQueue()
        self._completed = []
        for r in arrivals:
            self._q.push(r.arrival_s, ev.Arrive(ReqState(r)))
        for (te, pool, delta) in events:
            if self.ft.use_spot and delta < 0:
                self._q.push(te, ev.Interrupt(pool, -delta))
        for p in self.pipes:
            self._push_wake(0.0, p)
        handlers = {
            ev.Arrive: self._on_arrive,
            ev.Interrupt: self._on_interrupt,
            ev.Revive: self._on_revive,
            ev.Wake: self._on_wake,
            ev.TransferDone: self._on_transfer_done,
        }
        ev.dispatch(self._q, handlers, until=duration_s)
        completed = self._completed
        unfinished = []
        for p in self.pipes:
            unfinished.extend(p.active)
            unfinished.extend(p.queue)
        cost = self._total_cost(duration_s)
        stats = self.network.stats() if self.network is not None else {}
        return SimResult(completed, unfinished, duration_s, cost,
                         dict(self.downtime), self.interruptions,
                         self.kv_preemptions, stats,
                         len(self.transfer_log))

    def _kv_preempt(self, p: SimPipeline, live_tok: int) -> int:
        """Demand-paged pool pressure: this iteration writes one token per
        active request, so the pool must cover live_tok + batch. Preempt
        fewest-generated victims (the engine's policy) to the queue front
        until the batch fits; returns the updated live token count."""
        pool = self.ft.kv_pool_tokens
        while p.active and live_tok + len(p.active) > pool:
            victim = min(p.active,
                         key=lambda r: (r.generated, r.req.arrival_s))
            p.active.remove(victim)
            live_tok -= victim.req.s_in + victim.generated
            victim.kv_preempted = True
            victim.admit_s = -1.0
            p.queue.insert(0, victim)
            self.kv_preemptions += 1
        return live_tok

    def _pipeline_iteration(self, p: SimPipeline, t: float,
                            completed: List[ReqState]) -> float:
        """Admit + one decode iteration; returns elapsed time (0 = idle)."""
        dt = 0.0
        pool = self.ft.kv_pool_tokens
        live_tok = sum(r.req.s_in + r.generated for r in p.active) \
            if pool else 0
        if pool:
            live_tok = self._kv_preempt(p, live_tok)
        # admit newcomers up to b_max (and, pool-bounded, up to capacity —
        # an empty pipeline always admits one so a request larger than the
        # pool still makes progress via the preempt/grow cycle)
        new = []
        while p.queue and len(p.active) + len(new) < p.b_max:
            need = p.queue[0].req.s_in + p.queue[0].generated + 1
            if pool and (p.active or new) and live_tok + need > pool:
                break
            new.append(p.queue.pop(0))
            live_tok += need
        if new:
            # transfer-recovered requests carry their KV with them (moved
            # during the downtime window); pool-preempted ones re-attach
            # from the node-local store at the preemption round-trip price
            # — only the rest pay recompute
            recompute = [r for r in new
                         if not r.transfer_recovered and not r.kv_preempted]
            if recompute:
                ctx = int(sum(r.req.s_in + r.generated for r in recompute)
                          / len(recompute))
                dt += p.t_prefill(len(recompute), ctx)
            restored = [r for r in new if r.kv_preempted]
            if restored:
                from repro_torch.cluster.recovery import preemption_seconds
                dt += sum(preemption_seconds(self.spec,
                                             r.req.s_in + r.generated)
                          for r in restored)
            if self.network is not None:
                # store restores ride the admitting region's link (or the
                # cross-region link when the KV was published elsewhere):
                # overlapped with the downtime window in the closed form,
                # so charged to nobody — but real bytes on a real link
                from repro_torch.cluster.recovery import kv_bytes_for_ctx
                for r in new:
                    if not r.transfer_recovered:
                        continue
                    if r.src_region and r.src_region != p.region:
                        link = self.network.cross_link(r.src_region,
                                                       p.region)
                    else:
                        link = self.network.store_link(p.region)
                    self._submit(link, t, "kv_restore",
                                 kv_bytes_for_ctx(self.spec,
                                                  r.req.s_in + r.generated))
            for r in new:
                r.admit_s = t
                r.transfer_recovered = False
                r.src_region = ""
                if r.kv_preempted:
                    # re-attach resumes decode exactly where the preempt
                    # parked it: no token is emitted at admission
                    r.kv_preempted = False
                    p.active.append(r)
                    continue
                if r.first_token_s < 0:
                    r.first_token_s = t + dt      # first new token emitted
                r.generated += 1                   # prefill emits one token
                p.active.append(r)
        if not p.active:
            return dt
        dt += p.t_iter(len(p.active))
        done = []
        for r in p.active:
            r.generated += 1
            if r.generated >= r.req.s_out:
                r.finish_s = t + dt
                done.append(r)
        for r in done:
            p.active.remove(r)
            completed.append(r)
        return dt

    def _total_cost(self, duration_s: float) -> float:
        hours = duration_s / 3600.0
        base = sum(p.price_hr(self.ft.use_spot and p.spot)
                   for p in self.pipes) * hours
        # on-demand fallback premium for each replaced instance
        od_premium = 0.0
        if self.ft.use_spot:
            for (t, delta_hr) in self._od_fallbacks:
                od_premium += delta_hr * max(0.0, duration_s - t) / 3600.0
        return base + self.extra_cost + od_premium
