"""ShuntServe core: the paper's primary contribution (copies of
``repro/core/*.py``, imports aside, so every estimate and search result
equals the reference's number for number).

  * roofline.py   — op-level FLOPs/bytes cost tables (paper Table 2)
  * comm.py       — alpha-beta communication model (Eqs. 2-3)
  * estimator.py  — static latency + throughput estimation (Eqs. 1, 4, 5)
  * eval_engine.py— prefix-sum cost tables: O(1) stage scoring for search
  * objective.py  — throughput-per-cost objective with SLO penalty (Eq. 7)
  * buckets.py    — length-bucket throughput tables + $/token objective
  * placement.py  — DP + beam-search placement optimizer (Algorithm 1)
  * cluster_opt.py— iterative pipeline extraction to populate a cluster
  * baselines.py  — vLLM / AlpaServe / HexGen-style placement baselines
  * modelspec.py  — analytical architecture description
"""

from repro_torch.core.buckets import (BucketEstimator, BucketTable,
                                HistogramCostObjective, LengthBuckets,
                                bucket_table, histogram_cost_per_token,
                                workload_histogram)
from repro_torch.core.cluster_opt import ClusterPlan, populate_cluster
from repro_torch.core.estimator import PerfEstimate, Placement, Stage, estimate
from repro_torch.core.eval_engine import FastEstimator, StageTable
from repro_torch.core.modelspec import LayerSpec, ModelSpec, uniform_decoder
from repro_torch.core.objective import Objective, cost_per_token
from repro_torch.core.placement import PlacementOptimizer, SearchResult

__all__ = [
    "Placement", "PerfEstimate", "Stage", "estimate", "FastEstimator",
    "StageTable", "LayerSpec", "ModelSpec", "uniform_decoder", "Objective",
    "cost_per_token", "LengthBuckets", "BucketEstimator", "BucketTable",
    "bucket_table", "workload_histogram", "histogram_cost_per_token",
    "HistogramCostObjective", "PlacementOptimizer", "SearchResult",
    "ClusterPlan", "populate_cluster",
]
