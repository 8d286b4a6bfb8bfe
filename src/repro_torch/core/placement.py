"""Partitioned model placement optimizer — paper §4.2, Algorithm 1.

DP over (layers placed, stages used) with beam search: ``DP[l][s]`` holds the
top-k partial pipelines that place the first ``l`` layers on ``s`` stages.
Each extension assigns the next ``l - l'`` layers to a fresh stage drawn from
the available instance inventory (instance type x TP degree), computes the
max batch (Eq. 6) and estimated throughput (Eq. 4/5) of the *partial*
placement — the op-level estimator makes partial pipelines comparable, which
is what gives the problem (approximate) optimal substructure — and keeps the
beam's best k.

Two scoring paths:

  * **fast** (default): the prefix-sum table engine
    (``repro_torch.core.eval_engine``).  A ``_FastPartial`` carries incremental
    state — the running min of per-stage Eq. 6 batch bounds, the running
    max/sum of per-stage prefill/decode latency at the current batch —
    so extending a candidate by one stage composes scalars (O(1) table
    lookups) instead of re-walking every layer of every stage.  When the
    pipeline batch changes (a tighter stage appeared), the per-stage
    terms are rebuilt in O(stages) table lookups.  Beams additionally
    apply dominance pruning: a candidate whose score is no better and
    whose inventory use is no smaller (component-wise) than another's is
    dropped, which both dedups equivalent inventory states and frees
    beam slots for genuinely different candidates.

    ``HistogramCostObjective`` also runs on this path: the same
    incremental composition (``_extend_state``) is replayed once per
    populated traffic bucket against that bucket's own prefix-sum
    tables, and the per-bucket requests/s compose harmonically into the
    histogram $/token score.  Dominance pruning is disabled there — the
    single-point dominance quantities don't bound per-bucket score
    evolution, and the reference beam is score-only top-k.

  * **reference** (``use_fast=False``): the original per-layer
    ``estimator.estimate`` scoring, kept as the pinned source of truth
    (see ``tests/test_fast_engine.py``).

Inventory handling (beyond the paper's pseudocode, required for real
clusters): each candidate tracks devices consumed per instance type so a
stage can only be added while inventory remains; one *instance* may host
multiple stages (intra-node TP slices, cf. HexGen's 4xL4 = 4 stages) but an
instance never spans pipelines (paper §4.2.1 fault-isolation rule).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.buckets import HistogramCostObjective
from repro_torch.core.estimator import (Placement, Stage, estimate,
                                  max_batch_size)
from repro_torch.core.eval_engine import FastEstimator, StageTable
from repro_torch.core.modelspec import ModelSpec
from repro_torch.core.objective import Objective
from repro_torch.hw.profiles import InstanceProfile


@dataclasses.dataclass(frozen=True)
class StageOption:
    """A way to build one stage: ``tp`` devices of one instance type."""

    instance: InstanceProfile
    tp: int

    @property
    def key(self) -> Tuple[str, int]:
        return (self.instance.name, self.tp)


def stage_options_for(instances: Sequence[InstanceProfile],
                      max_tp: Optional[int] = None) -> List[StageOption]:
    opts = []
    for inst in instances:
        d = 1
        while d <= inst.num_devices:
            if inst.num_devices % d == 0 and (max_tp is None or d <= max_tp):
                opts.append(StageOption(inst, d))
            d *= 2
    return opts


@dataclasses.dataclass(frozen=True)
class _Partial:
    """A partial pipeline in the reference-path DP table."""

    stages: Tuple[Stage, ...]
    used_devices: Tuple[Tuple[str, int], ...]   # (instance_name, devices)
    score: float

    def used(self) -> Dict[str, int]:
        return dict(self.used_devices)


class _FastPartial:
    """A partial pipeline carrying incremental fast-path state.

    The latency aggregates (``sum_pre``/``sum_dec``/``max_pre``/
    ``max_dec``) are per-stage *base* values at batch ``batch``: they
    include the stage's layer-segment roofline latency, TP collectives,
    the first-stage extras on stage 0, and the PP hand-off for every
    stage (the d_pp>1 convention of Eq. 2) — but exclude the LM-head
    (logits) extras, which belong to whichever stage is currently last
    and migrate on every extension (each extension folds them onto the
    freshly appended stage's locally computed base).  ``m_nonlast`` is
    the running min over stages of the Eq. 6 bound with *no* stage
    holding the head, from which the true pipeline batch is
    min(m_nonlast, last-stage-as-last bound): the head only ever
    tightens the last stage's own bound.
    """

    __slots__ = ("segs", "used_d", "score", "batch", "m_nonlast",
                 "sum_pre", "sum_dec", "max_pre", "max_dec", "cost",
                 "bstate")

    def __init__(self, segs, used_d, score, batch, m_nonlast, sum_pre,
                 sum_dec, max_pre, max_dec, cost, bstate=None):
        self.segs = segs            # tuple of (StageTable, lo, hi)
        self.used_d = used_d        # {instance_name: devices} — never mutated
        self.score = score
        self.batch = batch
        self.m_nonlast = m_nonlast
        self.sum_pre = sum_pre
        self.sum_dec = sum_dec
        self.max_pre = max_pre
        self.max_dec = max_dec
        self.cost = cost
        # histogram mode only: one (segs_b, batch, m_nonlast, sum_pre,
        # sum_dec, max_pre, max_dec) per populated traffic bucket, composed
        # against that bucket's own tables
        self.bstate = bstate


@dataclasses.dataclass
class SearchResult:
    placement: Optional[Placement]
    score: float
    batch: int
    throughput_rps: float
    wall_time_s: float
    evaluated: int


class PlacementOptimizer:
    """Paper Algorithm 1."""

    def __init__(self, spec: ModelSpec, inventory: Dict[str, int],
                 instances: Dict[str, InstanceProfile], s_in: int,
                 s_out: int, objective: Optional[Objective] = None,
                 beam_k: int = 3, max_stages: Optional[int] = None,
                 max_tp: Optional[int] = None, batch_cap: int = 512,
                 use_fast: bool = True, prune_dominated: bool = True,
                 engine: Optional[FastEstimator] = None):
        self.spec = spec
        # inventory in *device* units per instance type
        self.inventory = {
            name: count * instances[name].num_devices
            for name, count in inventory.items()}
        self.instances = instances
        self.s_in, self.s_out = s_in, s_out
        self.objective = objective or Objective()
        self.beam_k = beam_k
        self.max_stages = max_stages or min(spec.n_layers, 16)
        self.options = stage_options_for(
            [instances[n] for n in inventory], max_tp=max_tp)
        self.batch_cap = batch_cap
        # the fast path inlines the stock Eq. 7 objective and the histogram
        # $/token objective (per-bucket table composition); any other
        # subclassed objective falls back to the reference scorer.
        self.use_fast = use_fast and type(self.objective) in (
            Objective, HistogramCostObjective)
        self.prune_dominated = prune_dominated
        self.engine = engine
        self.evaluated = 0

    # -- scoring (reference path) ------------------------------------------
    def _evaluate(self, stages: Tuple[Stage, ...], n_layers_placed: int
                  ) -> Tuple[float, int, float]:
        """Score a (possibly partial) pipeline with the reference
        estimator.

        Partial pipelines are scored on the layers placed so far with the
        last stage temporarily holding the LM head, mirroring the paper's
        'evaluating partial model placements within DP subproblems'.
        """
        spec = self.spec
        if n_layers_placed == spec.n_layers:
            pspec = spec
        else:
            pspec = dataclasses.replace(
                spec, layers=spec.layers[:n_layers_placed])
        stages = tuple(
            dataclasses.replace(s, first=(i == 0),
                                last=(i == len(stages) - 1))
            for i, s in enumerate(stages))
        placement = Placement(pspec, stages)
        batch = max_batch_size(pspec, placement, self.s_in, self.s_out,
                               cap=self.batch_cap)
        perf = estimate(pspec, placement, self.s_in, self.s_out, batch=batch)
        self.evaluated += 1
        score = self.objective.score(placement, perf)
        return score, perf.batch, perf.throughput_rps

    # -- Algorithm 1 ---------------------------------------------------------
    def search(self) -> SearchResult:
        if self.use_fast:
            return self._search_fast()
        return self._search_reference()

    def _search_reference(self) -> SearchResult:
        t0 = time.perf_counter()
        n_l = self.spec.n_layers
        # DP[l][s] -> beam (list of _Partial, best first)
        dp: Dict[Tuple[int, int], List[_Partial]] = {(0, 0): [
            _Partial((), (), 0.0)]}
        for l in range(1, n_l + 1):
            for lprime in range(0, l):
                l_new = l - lprime
                for s in range(0, min(lprime + 1, self.max_stages)):
                    beam = dp.get((lprime, s))
                    if not beam:
                        continue
                    s_new = s + 1
                    for cand, opt in itertools.product(beam[:self.beam_k],
                                                       self.options):
                        used = cand.used()
                        if (used.get(opt.instance.name, 0) + opt.tp
                                > self.inventory.get(opt.instance.name, 0)):
                            continue
                        stage = Stage(opt.instance, opt.tp, l_new)
                        stages = cand.stages + (stage,)
                        score, batch, _ = self._evaluate(stages, l)
                        if batch <= 0 and l == n_l:
                            continue
                        used[opt.instance.name] = (
                            used.get(opt.instance.name, 0) + opt.tp)
                        new = _Partial(stages, tuple(sorted(used.items())),
                                       score)
                        self._update(dp, (l, s_new), new)
        return self._extract_reference(dp, t0)

    def _update(self, dp, key, cand: _Partial) -> None:
        beam = dp.setdefault(key, [])
        beam.append(cand)
        beam.sort(key=lambda c: -c.score)
        del beam[self.beam_k:]

    def _extract_reference(self, dp, t0) -> SearchResult:
        n_l = self.spec.n_layers
        best: Optional[_Partial] = None
        for s in range(1, self.max_stages + 1):
            for cand in dp.get((n_l, s), []):
                if best is None or cand.score > best.score:
                    best = cand
        wall = time.perf_counter() - t0
        if best is None:
            return SearchResult(None, 0.0, 0, 0.0, wall, self.evaluated)
        return self._finish(best.stages, best.score, wall)

    def _finish(self, stages: Tuple[Stage, ...], score: float,
                wall: float) -> SearchResult:
        stages = tuple(
            dataclasses.replace(st, first=(i == 0),
                                last=(i == len(stages) - 1))
            for i, st in enumerate(stages))
        placement = Placement(self.spec, stages)
        batch = max_batch_size(self.spec, placement, self.s_in, self.s_out,
                               cap=self.batch_cap)
        perf = estimate(self.spec, placement, self.s_in, self.s_out,
                        batch=batch)
        return SearchResult(placement, score, perf.batch,
                            perf.throughput_rps, wall, self.evaluated)

    # -- fast path ---------------------------------------------------------
    def _search_fast(self) -> SearchResult:
        t0 = time.perf_counter()
        if (self.engine is None
                or self.engine.spec is not self.spec
                or (self.engine.s_in, self.engine.s_out)
                != (self.s_in, self.s_out)
                or self.engine.batch_cap != self.batch_cap):
            self.engine = FastEstimator(self.spec, self.s_in, self.s_out,
                                        self.batch_cap)
        obj = self.objective
        spot = obj.spot_pricing
        tables = [self.engine.table(o.instance, o.tp) for o in self.options]
        opt_meta = [(t, o.instance.name, o.tp,
                     t.price_spot if spot else t.price_od)
                    for t, o in zip(tables, self.options)]
        # histogram mode: per populated bucket, that bucket's own tables
        # (one per option) from the SAME BucketEstimator the reference
        # scorer uses, so both paths hit one shared table cache
        hmeta = None
        if type(obj) is HistogramCostObjective:
            best = obj._estimator(self.spec)
            bk = best.buckets
            hmeta = []
            for bi in range(bk.n_in):
                for bo in range(bk.n_out):
                    w = obj.hist[bi][bo]
                    if w <= 0:
                        continue
                    fe = best.estimator(bi, bo)
                    hmeta.append((w, float(bk.rep(bi, bo)[1]), fe.batch_cap,
                                  tuple(fe.table(o.instance, o.tp)
                                        for o in self.options)))
        n_l = self.spec.n_layers
        cap = self.batch_cap
        root_b = (tuple(((), 0, cap_b, 0.0, 0.0, 0.0, 0.0)
                        for _, _, cap_b, _ in hmeta)
                  if hmeta is not None else None)
        root = _FastPartial((), {}, 0.0, 0, cap, 0.0, 0.0, 0.0, 0.0, 0.0,
                            root_b)
        dp: Dict[Tuple[int, int], List[_FastPartial]] = {(0, 0): [root]}
        inventory = self.inventory
        for l in range(1, n_l + 1):
            for lprime in range(0, l):
                for s in range(0, min(lprime + 1, self.max_stages)):
                    beam = dp.get((lprime, s))
                    if not beam:
                        continue
                    first = s == 0
                    key_new = (l, s + 1)
                    for oi, (table, name, tp, price) in enumerate(opt_meta):
                        inv_t = inventory.get(name, 0)
                        if tp > inv_t:
                            continue
                        nb_nl = table.bound(lprime, l, first, False)
                        nb_l = table.bound(lprime, l, first, True)
                        hb = None
                        if hmeta is not None:
                            hb = [(w, out_b, bt[oi],
                                   bt[oi].bound(lprime, l, first, False),
                                   bt[oi].bound(lprime, l, first, True))
                                  for w, out_b, _, bt in hmeta]
                        for cand in beam:
                            if cand.used_d.get(name, 0) + tp > inv_t:
                                continue
                            new = self._extend_fast(cand, table, lprime, l,
                                                    nb_nl, nb_l, price,
                                                    name, tp, hb)
                            self.evaluated += 1
                            if new.batch <= 0 and l == n_l:
                                continue
                            self._update_fast(dp, key_new, new)
        return self._extract_fast(dp, t0)

    def _extend_fast(self, cand: _FastPartial, table: StageTable, lo: int,
                     hi: int, nb_nl: int, nb_l: int, price: float,
                     name: str, tp: int, hb=None) -> _FastPartial:
        segs = cand.segs + ((table, lo, hi),)
        used_d = dict(cand.used_d)
        used_d[name] = used_d.get(name, 0) + tp
        cost = cand.cost + price
        state, terms = _extend_state(
            (cand.batch, cand.m_nonlast, cand.sum_pre, cand.sum_dec,
             cand.max_pre, cand.max_dec), segs, table, lo, hi, nb_nl, nb_l)
        batch, m_nonlast, sum_pre, sum_dec, max_pre, max_dec = state
        if hb is None:
            if terms is None:
                return _FastPartial(segs, used_d, 0.0, 0, m_nonlast, 0.0,
                                    0.0, 0.0, 0.0, cost)
            bn_pre, bn_dec, tot_pre, tot_dec = terms
            l_b = bn_pre + bn_dec
            rps = batch / l_b if l_b > 0 else 0.0
            score = self._score_fast(rps, tot_pre + tot_dec, cost)
            return _FastPartial(segs, used_d, score, batch, m_nonlast,
                                sum_pre, sum_dec, max_pre, max_dec, cost)
        # histogram mode: replay the composition per populated bucket with
        # that bucket's own tables, then compose harmonically
        # (histogram_tokens_per_s) — any infeasible bucket zeroes the score
        sec_per_req = 0.0
        tok_per_req = 0.0
        feasible = True
        bstate = []
        for (w, out_b, t_b, nbnl_b, nbl_b), prev_b in zip(hb, cand.bstate):
            segs_b = prev_b[0] + ((t_b, lo, hi),)
            st_b, terms_b = _extend_state(prev_b[1:], segs_b, t_b, lo, hi,
                                          nbnl_b, nbl_b)
            bstate.append((segs_b,) + st_b)
            if terms_b is None:
                feasible = False
                continue
            l_bb = terms_b[0] + terms_b[1]
            rps_b = st_b[0] / l_bb if l_bb > 0 else 0.0
            if rps_b <= 0:
                feasible = False
                continue
            sec_per_req += w / rps_b
            tok_per_req += w * out_b
        score = 0.0
        if feasible and sec_per_req > 0:
            tps = tok_per_req / sec_per_req
            if tps > 0:
                score = tps / cost
        return _FastPartial(segs, used_d, score, batch, m_nonlast, sum_pre,
                            sum_dec, max_pre, max_dec, cost, tuple(bstate))

    def _score_fast(self, rps: float, e2e: float, cost: float) -> float:
        """Inline of Objective.score (Eq. 7) on engine scalars."""
        obj = self.objective
        if rps <= 0:
            return 0.0
        base = rps / cost if obj.per_cost else rps
        if obj.tokens_per_req > 0:
            base *= obj.tokens_per_req
        if obj.gamma == 0.0 or math.isinf(obj.slo_s):
            return base
        violation = max(0.0, e2e / obj.slo_s - 1.0)
        if math.isinf(obj.gamma):
            return 0.0 if violation > 0 else base
        return base * max(0.0, 1.0 - obj.gamma * violation)

    def _update_fast(self, dp, key, cand: _FastPartial) -> None:
        beam = dp.setdefault(key, [])
        # histogram mode (bstate set) never prunes: the dominance
        # quantities are single-point and don't bound how the per-bucket
        # harmonic score evolves — a primary-point-dominated candidate can
        # still win on a long-context bucket. The reference beam for a
        # subclassed objective is score-only top-k; match it.
        if self.prune_dominated and cand.bstate is None:
            # b dominates cand iff b is weakly better on every quantity an
            # extension's score can depend on: current score, Eq. 6 batch
            # headroom (m_nonlast — without it a zero-score-but-recoverable
            # partial would be pruned by a zero-score permanently-infeasible
            # one), realized batch and base bottleneck latencies (the score
            # alone can be temporarily depressed by the migrating LM-head
            # extras), and per-type inventory use.
            for b in beam:
                if _dominates(b, cand):
                    return                      # cand is dominated
            beam[:] = [b for b in beam if not _dominates(cand, b)]
        beam.append(cand)
        beam.sort(key=_neg_score)
        del beam[self.beam_k:]

    def _extract_fast(self, dp, t0) -> SearchResult:
        n_l = self.spec.n_layers
        best: Optional[_FastPartial] = None
        for s in range(1, self.max_stages + 1):
            for cand in dp.get((n_l, s), []):
                if best is None or cand.score > best.score:
                    best = cand
        wall = time.perf_counter() - t0
        if best is None:
            return SearchResult(None, 0.0, 0, 0.0, wall, self.evaluated)
        stages = tuple(Stage(t.instance, t.tp, hi - lo)
                       for t, lo, hi in best.segs)
        return self._finish(stages, best.score, wall)


def _extend_state(prev, segs, table, lo, hi, nb_nl, nb_l):
    """Compose one appended stage onto cached per-stage aggregates.

    ``prev`` is (batch, m_nonlast, sum_pre, sum_dec, max_pre, max_dec)
    before the new stage; ``segs`` already includes the new
    ``(table, lo, hi)`` segment (needed for the batch-changed rebuild).
    Returns ``(state, terms)``: the updated 6-tuple plus
    ``(bn_pre, bn_dec, tot_pre, tot_dec)`` of the pipeline with the new
    stage holding the LM head, or ``terms=None`` when the Eq. 6 batch
    hits zero.  This is float-for-float the composition pinned against
    the reference estimator by tests/test_fast_engine.py; the histogram
    objective replays it per traffic bucket with that bucket's tables.
    """
    p_batch, p_m_nonlast, p_sum_pre, p_sum_dec, p_max_pre, p_max_dec = prev
    k = len(segs) - 1
    m_nonlast = nb_nl if nb_nl < p_m_nonlast else p_m_nonlast
    batch = nb_l if nb_l < p_m_nonlast else p_m_nonlast
    if batch <= 0:
        return (0, m_nonlast, 0.0, 0.0, 0.0, 0.0), None
    bidx = batch - 1
    if k == 0:
        base_pre = (table.seg_pre(lo, hi, bidx) + table.pp_pre[bidx]
                    + table.first_pre[bidx])
        base_dec = table.seg_dec(lo, hi, bidx) + table.pp_dec[bidx]
        sum_pre, sum_dec = base_pre, base_dec
        max_pre, max_dec = base_pre, base_dec
    elif batch == p_batch:
        # O(1) composition: every cached aggregate is valid at `batch`
        base_pre = table.seg_pre(lo, hi, bidx) + table.pp_pre[bidx]
        base_dec = table.seg_dec(lo, hi, bidx) + table.pp_dec[bidx]
        sum_pre = p_sum_pre + base_pre
        sum_dec = p_sum_dec + base_dec
        max_pre = base_pre if base_pre > p_max_pre else p_max_pre
        max_dec = base_dec if base_dec > p_max_dec else p_max_dec
    else:
        # the new stage changed the Eq. 6 batch: rebuild the per-stage
        # terms at the new batch (O(stages) table lookups, no layer loop)
        sum_pre = sum_dec = max_pre = max_dec = 0.0
        base_pre = base_dec = 0.0
        for j, (t, l0, l1) in enumerate(segs):
            bp = t.seg_pre(l0, l1, bidx) + t.pp_pre[bidx]
            bd = t.seg_dec(l0, l1, bidx) + t.pp_dec[bidx]
            if j == 0:
                bp += t.first_pre[bidx]
            sum_pre += bp
            sum_dec += bd
            if bp > max_pre:
                max_pre = bp
            if bd > max_dec:
                max_dec = bd
            base_pre, base_dec = bp, bd
    # score terms with the new stage holding the LM head
    lpre_x = table.last_pre[bidx]
    ldec_x = table.last_dec[bidx]
    if k == 0:
        # single-stage pipeline: no PP hand-off at all (Eq. 2)
        p0 = base_pre - table.pp_pre[bidx] + lpre_x
        d0 = base_dec - table.pp_dec[bidx] + ldec_x
        tot_pre, tot_dec = p0, d0
        bn_pre, bn_dec = p0, d0
    else:
        tot_pre = sum_pre + lpre_x
        tot_dec = sum_dec + ldec_x
        lp = base_pre + lpre_x
        ld = base_dec + ldec_x
        bn_pre = lp if lp > max_pre else max_pre
        bn_dec = ld if ld > max_dec else max_dec
    return ((batch, m_nonlast, sum_pre, sum_dec, max_pre, max_dec),
            (bn_pre, bn_dec, tot_pre, tot_dec))


def _neg_score(c) -> float:
    return -c.score


def _dominates(a: "_FastPartial", b: "_FastPartial") -> bool:
    """a dominates b: weakly better score, batch headroom, realized batch,
    base bottleneck latencies (comparable since a.batch >= b.batch and
    latency is monotone in batch) and inventory use."""
    return (a.score >= b.score and a.m_nonlast >= b.m_nonlast
            and a.batch >= b.batch
            and a.max_pre <= b.max_pre and a.max_dec <= b.max_dec
            and _used_leq(a.used_d, b.used_d))


def _used_leq(a: Dict[str, int], b: Dict[str, int]) -> bool:
    """True iff a uses no more devices than b of every instance type."""
    for name, d in a.items():
        if d > b.get(name, 0):
            return False
    return True


def exhaustive_search(spec: ModelSpec, inventory: Dict[str, int],
                      instances: Dict[str, InstanceProfile], s_in: int,
                      s_out: int, objective: Optional[Objective] = None,
                      max_stages: int = 4,
                      engine: Optional[FastEstimator] = None) -> SearchResult:
    """Brute-force reference used by tests on tiny problems (the paper's
    'intractable exhaustive search' — only viable for a handful of layers).

    Scoring goes through the prefix-sum engine, which makes the paper's
    Fig 11 'exhaustive' yardstick reach a few more layers before blowing up.
    """
    objective = objective or Objective()
    opts = stage_options_for([instances[n] for n in inventory])
    inv = {n: c * instances[n].num_devices for n, c in inventory.items()}
    engine = engine or FastEstimator(spec, s_in, s_out)
    n_l = spec.n_layers
    best, best_score = None, -1.0
    evaluated = 0
    t0 = time.perf_counter()

    def partitions(n, k):
        if k == 1:
            yield (n,)
            return
        for first in range(1, n - k + 2):
            for rest in partitions(n - first, k - 1):
                yield (first,) + rest

    for k in range(1, max_stages + 1):
        for part in partitions(n_l, k):
            for combo in itertools.product(opts, repeat=k):
                used: Dict[str, int] = {}
                ok = True
                for o in combo:
                    used[o.instance.name] = used.get(o.instance.name, 0) + o.tp
                    if used[o.instance.name] > inv.get(o.instance.name, 0):
                        ok = False
                        break
                if not ok:
                    continue
                stages = tuple(
                    Stage(o.instance, o.tp, nl, first=(i == 0),
                          last=(i == k - 1))
                    for i, (o, nl) in enumerate(zip(combo, part)))
                placement = Placement(spec, stages)
                perf = engine.estimate(placement)
                evaluated += 1
                sc = objective.score(placement, perf)
                if sc > best_score:
                    best, best_score = placement, sc
    wall = time.perf_counter() - t0
    if best is None:
        return SearchResult(None, 0.0, 0, 0.0, wall, evaluated)
    perf = estimate(spec, best, s_in, s_out)
    return SearchResult(best, best_score, perf.batch, perf.throughput_rps,
                        wall, evaluated)
