"""Length-bucketed throughput/cost tables and the $/token placement
objective (Mélange-style, "Demystifying Cost-Efficiency in LLM Serving
over Heterogeneous GPUs" — PAPERS.md).

The §4.1 estimator scores a placement at ONE (s_in, s_out) workload
point, so dispatch weights and placement scores treat every request
alike.  But cost-efficiency on a heterogeneous cluster is decided by
*where each length class runs*: a low-HBM L4 pipeline is fine for short
chats and collapses (Eq. 6 batch bound) on long contexts that an L40S
absorbs.  This module generalizes the same prefix-sum engine
(``eval_engine.FastEstimator`` — one per bucket representative point,
tables shared per (instance, tp)) across a small grid of
(input-len, output-len) buckets:

  * :class:`LengthBuckets` — the bucket grid.  A request classifies by
    (prompt len, max_new_tokens); each bucket's *representative* point is
    its upper edge, so a placement is only credited throughput it can
    sustain for every request in the bucket (memory-conservative).
  * :func:`bucket_table` — per-bucket output tokens/s and $/token for one
    placement: the routing weight table ``GlobalServer`` dispatches on.
  * :func:`workload_histogram` — normalized bucket weights of a traffic
    mix.
  * :class:`HistogramCostObjective` — Eq. 7 generalized to a traffic
    histogram: maximize output tokens/s per $/hr over the mix (its
    reciprocal is $/token), with a bucket the placement cannot serve at
    all zeroing the score.  Plugs into ``PlacementOptimizer`` /
    ``exhaustive_search`` / ``populate_cluster`` unchanged, so the
    optimizer answers "which spot mix serves this traffic histogram
    cheapest".
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.estimator import DEFAULT_BATCH_CAP, Placement
from repro_torch.core.eval_engine import FastEstimator
from repro_torch.core.modelspec import ModelSpec
from repro_torch.core.objective import Objective

# Azure-conversation-like traffic (workload.py): inputs clip to [16, 2048],
# outputs to [8, 1024] — three bands each cover short chat, the lognormal
# body, and the long-context tail.
DEFAULT_IN_EDGES = (128, 512, 2048)
DEFAULT_OUT_EDGES = (64, 256, 1024)


@dataclasses.dataclass(frozen=True)
class LengthBuckets:
    """A grid of (input-len, output-len) buckets.

    ``in_edges``/``out_edges`` are ascending *upper* bounds; lengths above
    the last edge clamp into the last bucket (the estimator is evaluated
    at the edge, so oversize requests are scored at the grid boundary
    rather than extrapolated)."""

    in_edges: Tuple[int, ...] = DEFAULT_IN_EDGES
    out_edges: Tuple[int, ...] = DEFAULT_OUT_EDGES

    @property
    def n_in(self) -> int:
        return len(self.in_edges)

    @property
    def n_out(self) -> int:
        return len(self.out_edges)

    def bucket_of(self, s_in: int, s_out: int) -> Tuple[int, int]:
        bi = bisect.bisect_left(self.in_edges, s_in)
        bo = bisect.bisect_left(self.out_edges, s_out)
        return (min(bi, self.n_in - 1), min(bo, self.n_out - 1))

    def rep(self, bi: int, bo: int) -> Tuple[int, int]:
        """The bucket's representative (s_in, s_out): its upper edge."""
        return (self.in_edges[bi], self.out_edges[bo])

    def pairs(self) -> Iterable[Tuple[int, int]]:
        for bi in range(self.n_in):
            for bo in range(self.n_out):
                yield (bi, bo)


class BucketEstimator:
    """One ``FastEstimator`` per bucket representative point, built lazily
    and shared across every placement scored through this instance (the
    underlying prefix-sum tables are additionally shared per
    (instance, tp) inside each FastEstimator)."""

    def __init__(self, spec: ModelSpec,
                 buckets: Optional[LengthBuckets] = None,
                 batch_cap: int = DEFAULT_BATCH_CAP):
        self.spec = spec
        self.buckets = buckets or LengthBuckets()
        self.batch_cap = batch_cap
        self._est: Dict[Tuple[int, int], FastEstimator] = {}

    def estimator(self, bi: int, bo: int) -> FastEstimator:
        key = (bi, bo)
        e = self._est.get(key)
        if e is None:
            s_in, s_out = self.buckets.rep(bi, bo)
            e = FastEstimator(self.spec, s_in, s_out, self.batch_cap)
            self._est[key] = e
        return e

    def perf(self, placement: Placement, bi: int, bo: int):
        return self.estimator(bi, bo).estimate(placement)

    def tok_s(self, placement: Placement, bi: int, bo: int) -> float:
        """Output tokens/s the placement sustains on bucket (bi, bo)
        traffic: Eq. 4/5 requests/s at the representative point times the
        representative output length. 0.0 when the bucket is infeasible
        (Eq. 6 batch bound hits zero)."""
        perf = self.perf(placement, bi, bo)
        if perf.batch <= 0 or perf.throughput_rps <= 0:
            return 0.0
        return perf.throughput_rps * self.buckets.rep(bi, bo)[1]


@dataclasses.dataclass
class BucketTable:
    """Per-bucket routing weights for ONE placement: output tokens/s and
    its price-normalized form (the dispatch-weight table)."""

    buckets: LengthBuckets
    tok_s: List[List[float]]            # [bi][bo] output tokens/s
    price_spot_hr: float
    price_ondemand_hr: float

    def cost_per_token(self, bi: int, bo: int, spot: bool = True) -> float:
        """$ per output token on bucket (bi, bo) traffic (inf when the
        placement cannot serve the bucket)."""
        t = self.tok_s[bi][bo]
        if t <= 0:
            return math.inf
        price = self.price_spot_hr if spot else self.price_ondemand_hr
        return price / 3600.0 / t

    def weight(self, bi: int, bo: int, policy: str = "cost",
               spot: bool = True) -> float:
        """Dispatch weight, higher is better.  ``"throughput"`` — output
        tokens/s; ``"cost"`` — tokens/s per $/hr (the reciprocal of
        $/token up to a constant)."""
        t = self.tok_s[bi][bo]
        if policy == "throughput":
            return t
        assert policy == "cost", policy
        price = self.price_spot_hr if spot else self.price_ondemand_hr
        return t / price if price > 0 else t


def bucket_table(placement: Placement,
                 buckets: Optional[LengthBuckets] = None,
                 est: Optional[BucketEstimator] = None) -> BucketTable:
    """Build the per-bucket throughput/cost table for one placement.
    Pass a shared ``BucketEstimator`` when tabling many placements of the
    same spec (e.g. every pipeline of a cluster plan)."""
    if est is None:
        est = BucketEstimator(placement.spec, buckets)
    bk = est.buckets
    tok = [[est.tok_s(placement, bi, bo) for bo in range(bk.n_out)]
           for bi in range(bk.n_in)]
    return BucketTable(bk, tok, placement.price_hr(spot=True),
                       placement.price_hr(spot=False))


def workload_histogram(pairs: Sequence[Tuple[int, int]],
                       buckets: Optional[LengthBuckets] = None
                       ) -> List[List[float]]:
    """Normalized bucket weights of a traffic mix given as
    (s_in, s_out) pairs."""
    bk = buckets or LengthBuckets()
    hist = [[0.0] * bk.n_out for _ in range(bk.n_in)]
    for s_in, s_out in pairs:
        bi, bo = bk.bucket_of(s_in, s_out)
        hist[bi][bo] += 1.0
    n = float(len(pairs))
    if n > 0:
        hist = [[w / n for w in row] for row in hist]
    return hist


def histogram_tokens_per_s(placement: Placement,
                           hist: Sequence[Sequence[float]],
                           est: BucketEstimator) -> float:
    """Output tokens/s one placement sustains serving the histogram mix,
    under time-sharing: a fraction ``w_b`` of requests draws from bucket
    ``b``, so mean seconds/request is ``sum_b w_b / rps_b`` (harmonic
    composition) and mean output tokens/request is ``sum_b w_b * out_b``.
    0.0 when any populated bucket is infeasible — a mix that cannot be
    served is not cheap, it is impossible."""
    bk = est.buckets
    sec_per_req = 0.0
    tok_per_req = 0.0
    for bi in range(bk.n_in):
        for bo in range(bk.n_out):
            w = hist[bi][bo]
            if w <= 0:
                continue
            perf = est.perf(placement, bi, bo)
            if perf.batch <= 0 or perf.throughput_rps <= 0:
                return 0.0
            sec_per_req += w / perf.throughput_rps
            tok_per_req += w * bk.rep(bi, bo)[1]
    if sec_per_req <= 0:
        return 0.0
    return tok_per_req / sec_per_req


def histogram_cost_per_token(placement: Placement,
                             hist: Sequence[Sequence[float]],
                             est: BucketEstimator,
                             spot: bool = True) -> float:
    """$ per output token serving the histogram mix on this placement."""
    tps = histogram_tokens_per_s(placement, hist, est)
    if tps <= 0:
        return math.inf
    return placement.price_hr(spot=spot) / 3600.0 / tps


class HistogramCostObjective(Objective):
    """Eq. 7 generalized to a traffic histogram: score is output tokens/s
    per $/hr over the (input-len, output-len) bucket mix — the reciprocal
    of $/token, so argmax score == argmin $/token.

    ``PlacementOptimizer`` recognizes this objective on its fast path:
    the incremental stage composition is replayed per populated bucket
    against that bucket's own prefix-sum tables (drawn from the same
    cached ``BucketEstimator`` the reference scorer uses), so histogram
    searches run at table-lookup speed rather than falling back to the
    per-candidate reference scorer.  Any *other* ``Objective`` subclass
    still routes to the reference path, where ``score`` is consulted per
    candidate; ``exhaustive_search`` and ``populate_cluster`` consume it
    unchanged."""

    def __init__(self, hist: Sequence[Sequence[float]],
                 buckets: Optional[LengthBuckets] = None,
                 spot_pricing: bool = True,
                 batch_cap: int = DEFAULT_BATCH_CAP):
        super().__init__(spot_pricing=spot_pricing)
        # Objective is a frozen dataclass; extra state goes around it
        object.__setattr__(self, "hist", [list(r) for r in hist])
        object.__setattr__(self, "buckets", buckets or LengthBuckets())
        object.__setattr__(self, "batch_cap", batch_cap)
        object.__setattr__(self, "_est", {})

    def _estimator(self, spec: ModelSpec) -> BucketEstimator:
        est = self._est.get(spec)
        if est is None:
            est = BucketEstimator(spec, self.buckets, self.batch_cap)
            self._est[spec] = est
        return est

    def tokens_per_s(self, placement: Placement) -> float:
        return histogram_tokens_per_s(placement, self.hist,
                                      self._estimator(placement.spec))

    def cost_per_token(self, placement: Placement) -> float:
        return histogram_cost_per_token(placement, self.hist,
                                        self._estimator(placement.spec),
                                        spot=self.spot_pricing)

    def score(self, placement: Placement, perf) -> float:
        # ``perf`` is the optimizer's single-point estimate; infeasible
        # there (batch 0) means infeasible everywhere deeper, and the
        # histogram scorer re-checks per-bucket feasibility itself.
        tps = self.tokens_per_s(placement)
        if tps <= 0:
            return 0.0
        return tps / placement.price_hr(self.spot_pricing)
