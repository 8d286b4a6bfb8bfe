"""Global server: pipelines + instance manager + fault tolerance (paper §3,
§5) over the REAL engine (execution plane). Port of
``repro/serving/server.py``: the same dispatch, clock, interruption,
migration and store logic, over the port's ``Engine`` on one device.

A ``ServingPipeline`` binds an ``Engine`` to a set of instance ids (from a
placement). The ``GlobalServer``:

  * dispatches requests weighted-round-robin by pipeline throughput (§3),
    with weights derived from ``core.estimator`` stage latencies when the
    pipeline's ``Placement`` is known (instead of a hardcoded 1.0);
  * with ``dispatch="throughput"`` or ``"cost"`` (Mélange-style,
    ``core.buckets``): classifies each request into an
    (input-len, output-len) bucket and shunts it to the pipeline with the
    best estimated output tokens/s (throughput policy) or tokens/s per
    $/hr — i.e. lowest $/token — (cost policy) *for that bucket*, so
    long-context requests land on high-HBM pipelines instead of
    collapsing a low-HBM pipeline's Eq. 6 batch bound. The round-robin
    credit scheme is kept per bucket, so every pipeline with nonzero
    bucket weight still receives its proportional share (no starvation);
    a request's bucket is assigned once and preserved across
    interrupt/requeue (migrated requests carry grown contexts, which must
    not reclassify them). With prefix sharing on, near-ties break toward
    a pipeline already holding the request's published prefix;
  * with ``use_prefix_share``: every engine indexes shared prompt prefixes
    (``Engine(prefix_share=True)``), the server publishes each pipeline's
    hot prefix payloads to the store under content-hash keys after its
    step, and a new or rebuilt pipeline warms its pool from them instead
    of recomputing (the recompute path stays the fallback);
  * advances the virtual clock by the estimator's bottleneck decode-step
    latency per scheduling round (``tick``), so reported throughput is
    consistent with the simulator instead of a hardcoded 0.01 s/round;
  * on a spot interruption: collects in-flight requests WITH their generated
    outputs (output-preserving request migration, §5.1) and re-queues them —
    onto surviving pipelines, or back onto the interrupted pipeline's own
    queue when none survive (it revives at ``down_until``; requests must
    never be silently dropped);
  * with ``use_kv_migration`` (and paged-KV engines + a store): additionally
    publishes each interrupted request's live KV blocks to the tensor store
    (``Engine.export_kv``), so re-admission ATTACHES the blocks
    (``Engine.import_kv``) and skips context recomputation entirely —
    SpotServe-style KV migration carried by the §5.2 store instead of a
    point-to-point transfer racing the grace period. Any incompatibility
    (contig engine, different block size, stale payload) falls back to the
    §5.1 recompute path;
  * pool preemptions ride the SAME path: when a demand-paged engine's
    decode-time grow finds the block pool dry (overcommitted ledger), the
    victim's exported KV payload is published to the store — capped first
    by the store's byte budget (``TensorStore(budget_bytes=...)``) — and
    the request requeued at the queue front for KV-attach re-admission;
  * rebuilds the pipeline with a replacement instance: with the shared
    tensor store the new engine ATTACHES to resident weights (concurrent
    initialization, §5.2) — the rebuild overlaps serving on the other
    pipelines and costs zero weight-reload; without the store it must
    re-load weights (slow path, modeled on the virtual clock).

Wall time is virtual (``clock``): control-plane latencies (provision/load/
init/grace) advance the clock; token generation is real PyTorch compute on
the server's ``device``, the card unless the caller passes ``device="cpu"``.
On the card every engine's attention runs the Hopper kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.core import estimator
from repro_torch.core.buckets import (BucketEstimator, LengthBuckets,
                                      bucket_table)
from repro_torch.device import DeviceLike, device_of, resolve_device
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import ServeRequest
from repro_torch.serving.tensor_store import TensorStore

DEFAULT_ROUND_S = 0.01           # fallback when no placement is known


@dataclasses.dataclass
class FTTimes:
    grace_period_s: float = 120.0
    node_provision_s: float = 41.55
    store_load_s: float = 61.85
    engine_init_s: float = 64.51


@dataclasses.dataclass
class ServingPipeline:
    pid: int
    engine: Engine
    instance_ids: List[str]
    weight: float = 1.0
    alive: bool = True
    down_until: float = 0.0
    queue: List[ServeRequest] = dataclasses.field(default_factory=list)
    placement: Optional[Any] = None       # core.estimator.Placement
    round_s: float = DEFAULT_ROUND_S      # est. decode-step wall time
    bucket_tbl: Optional[Any] = None      # core.buckets.BucketTable
    pricing: str = "spot"                 # "spot" | "ondemand" billing rate


class GlobalServer:
    def __init__(self, cfg: ArchConfig, store: Optional[TensorStore],
                 ft: Optional[FTTimes] = None, use_migration: bool = True,
                 use_concurrent_init: bool = True, max_batch: int = 4,
                 max_len: int = 128, device: DeviceLike = None,
                 prefill_chunk: int = 0,
                 est_workload: Tuple[int, int] = (763, 232),
                 engine_kw: Optional[Dict] = None,
                 use_kv_migration: bool = False,
                 use_prefix_share: bool = False,
                 prefix_hot_hits: int = 2,
                 dispatch: str = "weighted",
                 buckets: Optional[Any] = None,
                 prefix_affinity_frac: float = 0.9):
        assert dispatch in ("weighted", "uniform", "throughput", "cost"), \
            dispatch
        # every engine of the server runs here; add_pipeline refuses params
        # that live elsewhere
        self.device = resolve_device(device)
        self.cfg = cfg
        self.store = store
        self.ft = ft or FTTimes()
        self.use_migration = use_migration
        # KV-block migration is opt-in: it trades store bytes for skipped
        # recompute, and the recompute path must stay the tested default
        # (the paper's §5.1 baseline; recovery.decide weighs the two)
        self.use_kv_migration = use_kv_migration
        # prefix sharing is likewise opt-in: engines index shared prompt
        # prefixes, the server publishes HOT prefix payloads to the store
        # under content-hash keys, and re-placed/new pipelines warm their
        # caches from the store instead of recomputing (recompute fallback
        # when the store lacks the prefix)
        self.use_prefix_share = use_prefix_share
        self.prefix_hot_hits = prefix_hot_hits
        # dispatch policy: "weighted" — scalar weighted RR (legacy);
        # "uniform" — every alive pipeline weighted 1.0 (A/B baseline);
        # "throughput"/"cost" — per-length-bucket weights from the
        # pipeline's BucketTable (tokens/s, or tokens/s per $/hr)
        self.dispatch = dispatch
        if buckets is None:
            buckets = LengthBuckets()
        self.buckets = buckets
        # a holder within this fraction of the best bucket weight takes
        # the request (prefix-affinity tie-breaking)
        self.prefix_affinity_frac = prefix_affinity_frac
        self.use_concurrent_init = use_concurrent_init
        self.max_batch = max_batch
        self.max_len = max_len
        self.est_workload = est_workload      # (s_in, s_out) for estimates
        self.engine_kw = dict(engine_kw or {})
        self.engine_kw.setdefault("prefill_chunk", prefill_chunk)
        if use_prefix_share:
            self.engine_kw.setdefault("prefix_share", True)
        self.pipelines: List[ServingPipeline] = []
        self.clock = 0.0
        # scalar dispatch keys on pid; bucket dispatch on (pid, bucket)
        self._rr_credit: Dict[Any, float] = {}
        self._bucket_by_rid: Dict[int, Tuple[int, int]] = {}
        self._bucket_est: Dict[Any, Any] = {}     # spec -> BucketEstimator
        self._pipe_engine_kw: Dict[int, Dict] = {}   # pid -> engine_kw
        # published/warmed shared-prefix token runs -> pids holding them
        # (the server knows which pipeline published which content-hash
        # key — prefix-aware dispatch routes a request to a pipeline that
        # already holds its prefix)
        self._prefix_home: Dict[Tuple[int, ...], set] = {}
        self.completed: List[ServeRequest] = []
        self.events: List[Tuple[float, str, str]] = []   # (t, kind, detail)

    # -- pipeline lifecycle ---------------------------------------------------
    def _build_engine(self, params: Any,
                      extra_kw: Optional[Dict] = None) -> Engine:
        kw = dict(self.engine_kw)
        kw.update(extra_kw or {})
        mb = kw.pop("max_batch", self.max_batch)
        ml = kw.pop("max_len", self.max_len)
        return Engine(self.cfg, params, max_batch=mb, max_len=ml,
                      device=self.device, **kw)

    def _estimate_pipeline(self, placement) -> Tuple[float, float]:
        """(dispatch weight, per-round seconds) from the §4.1 estimator's
        stage latencies for this placement at the reference workload."""
        s_in, s_out = self.est_workload
        est = estimator.estimate(placement.spec, placement, s_in, s_out)
        if est.batch <= 0 or not est.decode_stage_s:
            return 1.0, DEFAULT_ROUND_S
        # one scheduling round == one decode step on every live slot; the
        # bottleneck stage paces the pipeline (Eq. 5)
        round_s = max(est.decode_stage_s) / s_out
        return max(est.throughput_rps, 1e-9), max(round_s, 1e-6)

    def _bucket_table(self, placement) -> Any:
        """Per-bucket tokens/s / $-per-token table for a placement, with
        the bucket estimators shared across every pipeline of the same
        spec (the prefix-sum tables are the expensive part)."""
        est = self._bucket_est.get(placement.spec)
        if est is None:
            est = BucketEstimator(placement.spec, self.buckets)
            self._bucket_est[placement.spec] = est
        return bucket_table(placement, est=est)

    def add_pipeline(self, params: Any, instance_ids: Sequence[str],
                     weight: Optional[float] = None, partition: str = "full",
                     placement=None,
                     engine_kw: Optional[Dict] = None,
                     pricing: str = "spot") -> ServingPipeline:
        """pricing: which rate this pipeline is billed at — a cluster
        mixing spot and on-demand capacity prices the SAME placement
        differently, so cost-policy dispatch must re-rank per pipeline
        (``BucketTable.weight(spot=...)``), not per spec."""
        assert pricing in ("spot", "ondemand"), pricing
        pdev = device_of(params)
        if pdev is None or pdev.type != self.device.type:
            raise ValueError(f"params live on {pdev}, server on "
                             f"{self.device}")
        if self.store is not None:
            key = f"{partition}/p{len(self.pipelines)}"
            params, cold = self.store.put_or_attach(self.cfg.name, key,
                                                    params)
            if cold:
                self.events.append((self.clock, "store_load",
                                    f"{self.cfg.name}/{key}"))
        round_s = DEFAULT_ROUND_S
        bucket_tbl = None
        if placement is not None:
            est_w, round_s = self._estimate_pipeline(placement)
            if weight is None:
                weight = est_w
            if self.dispatch in ("throughput", "cost"):
                bucket_tbl = self._bucket_table(placement)
        pid = len(self.pipelines)
        self._pipe_engine_kw[pid] = dict(engine_kw or {})
        # the engine's cost-aware preemption-victim policy prices the
        # recompute branch off the pipeline's placement when known
        if placement is not None:
            self._pipe_engine_kw[pid].setdefault("placement", placement)
        p = ServingPipeline(pid,
                            self._build_engine(params,
                                               self._pipe_engine_kw[pid]),
                            list(instance_ids),
                            1.0 if weight is None else weight,
                            placement=placement, round_s=round_s,
                            bucket_tbl=bucket_tbl, pricing=pricing)
        self.pipelines.append(p)
        self._rr_credit[p.pid] = 0.0
        # a newly-placed pipeline warms its cache from published hot
        # prefixes instead of recomputing them on first contact
        self._warm_prefixes(p)
        return p

    # -- dispatch ---------------------------------------------------------------
    def bucket_for(self, req: ServeRequest) -> Tuple[int, int]:
        """The request's length bucket, assigned ONCE on first contact
        from (prompt len, max output) and preserved across interrupt /
        preemption requeues — a migrated request's recompute context has
        grown by its generated tokens, which must not reclassify it."""
        b = self._bucket_by_rid.get(req.rid)
        if b is None:
            b = self.buckets.bucket_of(len(req.prompt), req.max_new_tokens)
            self._bucket_by_rid[req.rid] = b
        return b

    def _dispatch_weight(self, p: ServingPipeline,
                         b: Optional[Tuple[int, int]]) -> float:
        if self.dispatch == "uniform":
            return 1.0
        if b is None or p.bucket_tbl is None:
            return p.weight
        # cost-policy weights divide by the pipeline's OWN billing rate:
        # an on-demand pipeline serving the same bucket at the same
        # tokens/s is strictly more $/token, so spot capacity out-ranks it
        return p.bucket_tbl.weight(b[0], b[1], policy=self.dispatch,
                                   spot=(p.pricing == "spot"))

    def _prefix_holders(self, prompt: Sequence[int]) -> set:
        """Pids of pipelines holding a published/warmed shared-prefix run
        that this prompt extends."""
        if not self._prefix_home:
            return set()
        toks = list(prompt)
        out: set = set()
        for run, pids in self._prefix_home.items():
            if len(run) <= len(toks) and toks[:len(run)] == list(run):
                out |= pids
        return out

    def submit(self, req: ServeRequest) -> Optional[ServingPipeline]:
        alive = [p for p in self.pipelines if p.alive]
        if not alive:
            return None
        b = self.bucket_for(req) \
            if self.dispatch in ("throughput", "cost") else None
        w = {p.pid: self._dispatch_weight(p, b) for p in alive}
        if all(v <= 0 for v in w.values()):
            # the estimator says no alive pipeline can serve this bucket
            # (or every weight degenerated): fall back to scalar weights —
            # the request must still be placed somewhere
            w = {p.pid: max(p.weight, 1e-9) for p in alive}
        key = (lambda pid: (pid, b)) if b is not None else (lambda pid: pid)
        for p in alive:
            self._rr_credit[key(p.pid)] = \
                self._rr_credit.get(key(p.pid), 0.0) + w[p.pid]
        best = max(alive, key=lambda p: self._rr_credit[key(p.pid)])
        if self.use_prefix_share:
            # tie-break toward a pipeline already holding this prompt's
            # prefix: a holder within prefix_affinity_frac of the chosen
            # pipeline's weight skips the prefix recompute entirely, which
            # is worth a marginal estimated-throughput gap. Credits are
            # still settled below, so long-run shares stay proportional.
            holders = self._prefix_holders(req.prompt)
            if holders and best.pid not in holders:
                cand = [p for p in alive if p.pid in holders
                        and w[p.pid] >= self.prefix_affinity_frac
                        * w[best.pid]]
                if cand:
                    best = max(cand,
                               key=lambda p: self._rr_credit[key(p.pid)])
        self._rr_credit[key(best.pid)] -= sum(w.values())
        best.queue.append(req)
        return best

    # -- serving loop -------------------------------------------------------------
    _KV_MODEL = "__kv__"
    _PREFIX_MODEL = "__prefix__"

    def _kv_key(self, req: ServeRequest) -> str:
        return f"r{req.rid}"

    def _prefix_key(self, arch: str, block_size: int, tokens) -> str:
        """Content-hash key for a shared-prefix run: the token run (plus
        arch and block geometry) IS the identity, so every pipeline that
        computes the same hot prefix publishes to the same key exactly
        once."""
        import hashlib
        import numpy as np
        h = hashlib.sha1(
            np.asarray(list(tokens), np.int64).tobytes()).hexdigest()
        return f"{arch}/b{block_size}/{h[:16]}"

    def _publish_hot_prefixes(self, p: ServingPipeline) -> None:
        """Publish this pipeline's hottest shared-prefix block payloads
        (budget-capped via the store's LRU insert path, like KV
        migration payloads; unreferenced, so evictable). Runs are
        content-addressed BEFORE export, so an already-published prefix
        costs no KV gather."""
        if not self.use_prefix_share or self.store is None:
            return
        eng = p.engine
        for run in eng.hot_runs(self.prefix_hot_hits):
            # the run lives in this engine's own index — record the
            # pipeline as a holder for prefix-affinity dispatch
            self._prefix_home.setdefault(tuple(run), set()).add(p.pid)
            key = self._prefix_key(self.cfg.name, eng.bm.block_size, run)
            # peek (not contains): an already-published hot prefix counts
            # as a store HIT, feeding the store's top-k hot-key pinning
            if self.store.peek(self._PREFIX_MODEL, key) is not None:
                continue
            payload = eng.export_prefix(run)
            if payload is not None:
                self.store.put(self._PREFIX_MODEL, key, payload)
                self.events.append((self.clock, "prefix_publish", key))

    def _warm_prefixes(self, p: ServingPipeline) -> None:
        """Warm a (new or rebuilt) pipeline's cache with every published
        shared-prefix payload its engine can attach. ``peek`` is
        non-consuming — warm-up is multi-consumer, unlike migrated-KV
        ``take``. Absent or incompatible payloads simply leave the engine
        on the recompute path (fallback preserved)."""
        if not self.use_prefix_share or self.store is None:
            return
        for model, part in self.store.keys(self._PREFIX_MODEL):
            payload = self.store.peek(model, part)
            if payload is not None and p.engine.warm_prefix(payload):
                self.events.append((self.clock, "prefix_warm", part))
                run = tuple(int(t) for t in payload["tokens"])
                self._prefix_home.setdefault(run, set()).add(p.pid)

    def _publish_kv(self, key: str, payload: Dict) -> None:
        """Publish one request's KV payload. Interruption grace-window and
        pool-preemption publishes share this path; ``put`` LRU-evicts
        unreferenced keys down to the store's ``budget_bytes`` on insert,
        so published-KV residency stays capped (older unpinned payloads
        go first — the fresh payload is most-recently used)."""
        self.store.put(self._KV_MODEL, key, payload)
        self.events.append((self.clock, "kv_publish", key))

    def _admit_kv_attached(self, p: ServingPipeline) -> None:
        """Admit queued requests whose KV blocks are resident in the store
        by attaching them (no recompute). Successful imports consume the
        payload; failures leave the request queued for the normal path."""
        rest: List[ServeRequest] = []
        for r in p.queue:
            key = self._kv_key(r)
            payload = self.store.take(self._KV_MODEL, key)  # single consumer
            if payload is None:
                rest.append(r)
            elif p.engine.import_kv(r, payload):
                self.events.append((self.clock, "kv_attach", key))
            else:
                # incompatible here; republish for a later/other pipeline
                self.store.put(self._KV_MODEL, key, payload)
                rest.append(r)
        p.queue[:] = rest

    def _drain_preempted(self, p: ServingPipeline) -> None:
        """Collect requests the engine preempted when a decode-time grow
        found the pool dry: publish their KV payloads (so re-admission
        attaches instead of recomputing — same store path the grace window
        uses) and requeue them at the FRONT of the pipeline's queue."""
        for req, payload in reversed(p.engine.take_preempted()):
            self.events.append((self.clock, "preempt", f"r{req.rid}"))
            # a victim preempted in its admission round has left the
            # engine's live set before step()'s first-token scan runs:
            # record TTFT here, at the round its token was emitted
            if req.first_token_s < 0 and req.generated:
                req.first_token_s = self.clock
            if self.use_kv_migration and self.store is not None:
                self._publish_kv(self._kv_key(req), payload)
            # without a store the payload is dropped; generated tokens are
            # preserved, so re-admission recomputes (§5.1 semantics)
            p.queue.insert(0, req)

    def step(self) -> int:
        """One scheduling round: batched admission of queued requests (KV
        attach first, prefill for the rest), one decode step per alive
        pipeline, then publish + requeue any pool-preempted requests.
        Returns tokens emitted."""
        emitted = 0
        for p in self.pipelines:
            if not p.alive:
                if self.clock >= p.down_until:
                    p.alive = True
                    self.events.append((self.clock, "revive", f"p{p.pid}"))
                else:
                    continue
            toks_before = p.engine.stats.tokens_out
            if self.use_kv_migration and self.store is not None and p.queue:
                self._admit_kv_attached(p)
            admitted = p.engine.admit_many(p.queue)
            if admitted:
                # skip-ahead admission: admitted is not necessarily a
                # queue prefix — remove by identity
                taken = {id(r) for r in admitted}
                p.queue[:] = [r for r in p.queue if id(r) not in taken]
            fin = p.engine.step()
            self._drain_preempted(p)
            self._publish_hot_prefixes(p)
            for r in list(p.engine.active()) + fin:
                if r.first_token_s < 0 and r.generated:
                    r.first_token_s = self.clock
            emitted += p.engine.stats.tokens_out - toks_before
            for r in fin:
                r.finish_s = self.clock
                self.completed.append(r)
        return emitted

    def round_s(self) -> float:
        """Virtual seconds one scheduling round represents: the slowest
        alive pipeline's estimated decode-step latency."""
        alive = [p.round_s for p in self.pipelines if p.alive]
        return max(alive) if alive else DEFAULT_ROUND_S

    def tick(self) -> None:
        if any(p.alive for p in self.pipelines):
            self.clock += self.round_s()
            return
        # nothing is serving: fast-forward the virtual clock to the next
        # revival so queued work (e.g. requests requeued on a sole
        # interrupted pipeline) is never starved by a round budget that
        # cannot span the grace period
        waking = [p.down_until for p in self.pipelines
                  if p.down_until > self.clock]
        if waking:
            self.clock = min(waking)
        else:
            self.clock += DEFAULT_ROUND_S

    def pending(self) -> bool:
        return any(p.queue or p.engine.active() for p in self.pipelines)

    def run_until_drained(self, max_rounds: int = 10_000) -> None:
        rounds = 0
        while rounds < max_rounds:
            if not self.pending():
                break
            self.step()
            self.tick()
            rounds += 1

    # -- fault tolerance ------------------------------------------------------------
    def interrupt_instance(self, instance_id: str) -> List[ServeRequest]:
        """Spot interruption notice for one instance: the owning pipeline is
        torn down after the grace period; in-flight requests migrate
        (output-preserving) or restart. Returns the affected requests."""
        ft = self.ft
        affected: List[Tuple[ServeRequest, ServingPipeline]] = []
        for p in self.pipelines:
            if not p.alive or instance_id not in p.instance_ids:
                continue
            self.events.append((self.clock, "interrupt",
                                f"p{p.pid}:{instance_id}"))
            # pool-preempted requests parked on the engine carry their own
            # payloads; the dying pipeline must not drop them
            parked = p.engine.take_preempted()
            # publish live KV blocks DURING the grace period (the engine is
            # still up): replacement/surviving pipelines attach instead of
            # recomputing (§5.1 x §5.2)
            if (self.use_kv_migration and self.use_migration
                    and self.store is not None):
                for req, payload in parked:
                    self._publish_kv(self._kv_key(req), payload)
                for rid, payload in p.engine.export_live_kv().items():
                    self._publish_kv(f"r{rid}", payload)
            # old pipeline serves through the grace period
            grace_end = self.clock + ft.grace_period_s
            if self.use_concurrent_init and self.store is not None:
                # replacement prepared in background; store makes the engine
                # init on unaffected nodes free of weight reloads
                ready = (self.clock + ft.node_provision_s
                         + max(ft.store_load_s, ft.engine_init_s))
                p.down_until = max(grace_end, ready)
            else:
                # must terminate old engine first; fresh engine reloads
                ready = (max(grace_end, self.clock + ft.node_provision_s)
                         + ft.store_load_s + ft.engine_init_s)
                p.down_until = ready
            reqs = (p.engine.evict_all() + [r for r, _ in parked]
                    + p.queue)
            p.queue = []
            for r in reqs:
                if not self.use_migration:
                    r.generated = []          # progress lost
                r.migrations += 1
                affected.append((r, p))
            p.alive = False
            p.instance_ids = [i for i in p.instance_ids if i != instance_id]
            p.instance_ids.append(f"{instance_id}/replacement")
            # rebuild engine NOW (attach-only when store present) so tokens
            # keep flowing the moment down_until passes
            p.engine = self._build_engine(
                p.engine.params, self._pipe_engine_kw.get(p.pid))
            # the rebuilt engine's cache is cold: it no longer holds any
            # published prefix (affinity map), and re-warming republishes
            # what the store still has
            for pids in self._prefix_home.values():
                pids.discard(p.pid)
            self._warm_prefixes(p)
        # re-dispatch affected requests to surviving pipelines; if none is
        # alive, requeue on the owner — it revives at down_until, and a
        # request must never be dropped because submit() had no target
        for r, owner in affected:
            if self.submit(r) is None:
                owner.queue.append(r)
        return [r for r, _ in affected]

    def downtime_of(self, pid: int) -> float:
        p = self.pipelines[pid]
        return max(0.0, p.down_until - self.clock)
