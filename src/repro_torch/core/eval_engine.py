"""Vectorized incremental placement-evaluation engine.

The DP+beam optimizer (paper §4.2, Alg. 1) scores ~1e5-1e6 partial
pipelines per search, and the reference scorer (``repro_torch.core.estimator``)
walks every layer of every stage on every call — O(stages x layers) Python
work per beam extension.  This module collapses that to table lookups:

  * :class:`StageTable` — per (instance, tp) **prefix-sum cost tables**:
    numpy cumulative sums over the layer axis of per-layer roofline
    prefill/decode latency (for every Eq. 6 batch size 1..cap at once,
    via ``roofline.layer_latency_array``), weight bytes and per-sequence
    KV/state bytes.  Any contiguous layer segment's latency, weight
    footprint and Eq. 6 batch bound is then an O(1) difference of two
    table entries.  First/last-stage extras (embedding + encoder prefix,
    LM head weights, logits op) and the per-layer TP-collective / PP
    hand-off terms (Eqs. 2-3) are separate per-batch vectors.

  * :class:`FastEstimator` — drop-in replacement for
    ``estimator.estimate``: evaluates a full :class:`Placement` in
    O(stages) table lookups.  Used by the DP optimizer, the exhaustive
    reference search and every §7.1.2 baseline planner so all of them
    speed up together.

The reference implementation in ``repro_torch.core.estimator`` is unchanged and
remains the source of truth; ``tests/test_fast_engine.py`` pins this
engine to it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import comm, roofline
from repro_torch.core.estimator import (ACT_HEADROOM, DEFAULT_BATCH_CAP,
                                  PerfEstimate, Placement,
                                  activation_bytes_per_seq,
                                  estimate as reference_estimate)
from repro_torch.core.modelspec import ModelSpec
from repro_torch.hw.profiles import InstanceProfile


class StageTable:
    """Prefix-sum cost tables for stages built from ``tp`` devices of one
    instance type, for a fixed (spec, s_in, s_out) workload point.

    Hot lookups are stored as plain Python lists — scalar indexing into
    lists is ~3x faster than into numpy arrays, and the beam search does
    millions of scalar reads.
    """

    __slots__ = (
        "instance", "tp", "batch_cap", "pre_cum", "dec_cum", "w_cum",
        "kv_cum", "tp_pre", "tp_dec", "pp_pre", "pp_dec", "first_pre",
        "last_pre", "last_dec", "first_w", "last_w", "act", "mem_cap",
        "price_spot", "price_od",
    )

    def __init__(self, spec: ModelSpec, instance: InstanceProfile, tp: int,
                 s_in: int, s_out: int,
                 batch_cap: int = DEFAULT_BATCH_CAP):
        self.instance = instance
        self.tp = tp
        self.batch_cap = batch_cap
        dev = instance.device
        e = spec.dtype_bytes
        n = spec.n_layers
        B = np.arange(1, batch_cap + 1, dtype=np.float64)

        # --- per-layer roofline latency, all batch sizes at once ---------
        # uniform-layer models share one LayerSpec: evaluate each distinct
        # layer once and fan the row out over the layer axis.
        uniq: Dict[object, Tuple[np.ndarray, np.ndarray]] = {}
        pre_rows = np.empty((n, batch_cap))
        dec_rows = np.empty((n, batch_cap))
        for i, l in enumerate(spec.layers):
            if l not in uniq:
                uniq[l] = (
                    roofline.layer_latency_array(l, dev, "prefill", B, s_in,
                                                 s_out, tp, e),
                    roofline.layer_latency_array(l, dev, "decode", B, s_in,
                                                 s_out, tp, e))
            pre_rows[i], dec_rows[i] = uniq[l]
        zero = np.zeros((1, batch_cap))
        self.pre_cum = np.concatenate(
            [zero, np.cumsum(pre_rows, axis=0)]).tolist()
        self.dec_cum = np.concatenate(
            [zero, np.cumsum(dec_rows, axis=0)]).tolist()

        # --- weight / KV prefix sums (batch-independent) -----------------
        w = [l.weight_bytes(e) for l in spec.layers]
        kv = []
        for l in spec.layers:
            tokens = s_in + s_out
            if l.window is not None:
                tokens = min(tokens, l.window)
            kv.append(l.kv_bytes_per_token(e) * tokens
                      + l.state_bytes_per_seq(e))
        self.w_cum = np.concatenate([[0.0], np.cumsum(w)]).tolist()
        self.kv_cum = np.concatenate([[0.0], np.cumsum(kv)]).tolist()

        # --- per-layer TP collectives and per-stage PP hand-off ----------
        link = comm.Link(dev.intra_alpha_s, dev.intra_beta_bps)
        ilink = comm.Link(instance.inter_alpha_s, instance.inter_beta_bps)
        H = spec.hidden
        self.tp_pre = [comm.tp_comm_latency(b, s_in, H, tp, 1, link, e)
                       for b in range(1, batch_cap + 1)]
        self.tp_dec = [comm.tp_comm_latency(b, 1, H, tp, 1, link, e) * s_out
                       for b in range(1, batch_cap + 1)]
        self.pp_pre = [comm.pp_comm_latency(b, s_in, H, ilink, e)
                       for b in range(1, batch_cap + 1)]
        self.pp_dec = [comm.pp_comm_latency(b, 1, H, ilink, e) * s_out
                       for b in range(1, batch_cap + 1)]

        # --- first/last stage extras -------------------------------------
        first_pre = np.zeros(batch_cap)
        for l in spec.encoder_layers:
            first_pre += roofline.layer_latency_array(l, dev, "prefill", B,
                                                      s_in, 0, tp, e)
        self.first_pre = first_pre.tolist()
        self.last_pre = roofline.logits_op_cost(
            spec, "prefill", B, s_in, s_out, tp).latency(dev).tolist()
        self.last_dec = roofline.logits_op_cost(
            spec, "decode", B, s_in, s_out, tp).latency(dev).tolist()
        self.first_w = (spec.vocab * spec.hidden * e
                        + sum(l.weight_bytes(e)
                              for l in spec.encoder_layers))
        self.last_w = (0.0 if spec.tie_embeddings
                       else spec.vocab * spec.hidden * e)

        # --- Eq. 6 ingredients + pricing ----------------------------------
        self.act = activation_bytes_per_seq(spec, s_in, tp)
        self.mem_cap = tp * dev.mem_gb * 1e9 * ACT_HEADROOM
        frac = tp / instance.num_devices
        self.price_spot = instance.price_spot_hr * frac
        self.price_od = instance.price_ondemand_hr * frac

    # -- O(1) segment queries (bidx = batch - 1) ---------------------------
    def seg_pre(self, lo: int, hi: int, bidx: int) -> float:
        """Prefill latency of layers [lo, hi) incl. TP collectives."""
        return (self.pre_cum[hi][bidx] - self.pre_cum[lo][bidx]
                + (hi - lo) * self.tp_pre[bidx])

    def seg_dec(self, lo: int, hi: int, bidx: int) -> float:
        return (self.dec_cum[hi][bidx] - self.dec_cum[lo][bidx]
                + (hi - lo) * self.tp_dec[bidx])

    def bound(self, lo: int, hi: int, first: bool, last: bool) -> int:
        """Eq. 6 per-stage batch bound for layers [lo, hi)."""
        w = self.w_cum[hi] - self.w_cum[lo]
        if first:
            w += self.first_w
        if last:
            w += self.last_w
        avail = self.mem_cap - w
        if avail <= 0:
            return 0
        denom = self.kv_cum[hi] - self.kv_cum[lo] + self.act
        if denom <= 0:
            return self.batch_cap
        b = int(avail // denom)
        return b if b < self.batch_cap else self.batch_cap

    def per_layer_latency(self, bidx: int) -> List[float]:
        """Per-layer prefill+decode roofline latency at one batch size
        (no comm terms) — used by the AlpaServe latency-balancing DP."""
        pre, dec = self.pre_cum, self.dec_cum
        return [pre[i + 1][bidx] - pre[i][bidx]
                + dec[i + 1][bidx] - dec[i][bidx]
                for i in range(len(pre) - 1)]


class FastEstimator:
    """Table-backed equivalent of ``estimator.estimate`` for a fixed
    (spec, s_in, s_out).  Tables are built lazily per (instance, tp) and
    shared across every placement evaluated through this instance — e.g.
    all ``populate_cluster`` iterations and all baseline planners."""

    def __init__(self, spec: ModelSpec, s_in: int, s_out: int,
                 batch_cap: int = DEFAULT_BATCH_CAP):
        self.spec = spec
        self.s_in, self.s_out = s_in, s_out
        self.batch_cap = batch_cap
        self._tables: Dict[Tuple[InstanceProfile, int], StageTable] = {}

    def table(self, instance: InstanceProfile, tp: int) -> StageTable:
        key = (instance, tp)
        t = self._tables.get(key)
        if t is None:
            t = StageTable(self.spec, instance, tp, self.s_in, self.s_out,
                           self.batch_cap)
            self._tables[key] = t
        return t

    def estimate(self, placement: Placement,
                 batch: Optional[int] = None) -> PerfEstimate:
        """Mirror of ``estimator.estimate`` via table lookups."""
        stages = placement.stages
        ranges = placement.layer_ranges()
        tables = [self.table(s.instance, s.tp) for s in stages]
        if batch is None:
            batch = self.batch_cap
            for s, t, (lo, hi) in zip(stages, tables, ranges):
                batch = min(batch, t.bound(lo, hi, s.first, s.last))
        elif batch > self.batch_cap:
            # off the table grid; fall back to the reference path
            return reference_estimate(placement.spec, placement, self.s_in,
                                      self.s_out, batch=batch)
        if batch <= 0:
            return PerfEstimate(0, [], [], math.inf, math.inf, math.inf, 0.0)
        bidx = batch - 1
        d_pp = len(stages)
        pre, dec = [], []
        for s, t, (lo, hi) in zip(stages, tables, ranges):
            lp = t.seg_pre(lo, hi, bidx)
            ld = t.seg_dec(lo, hi, bidx)
            if s.first:
                lp += t.first_pre[bidx]
            if s.last:
                lp += t.last_pre[bidx]
                ld += t.last_dec[bidx]
            if not s.last or d_pp > 1:
                lp += t.pp_pre[bidx]
                ld += t.pp_dec[bidx]
            pre.append(lp)
            dec.append(ld)
        l_b = max(pre) + max(dec)
        rps = batch / l_b if l_b > 0 else 0.0
        ttft = sum(pre)
        tpot = sum(d / self.s_out for d in dec)
        e2e = sum(pre) + sum(dec)
        return PerfEstimate(batch, pre, dec, ttft, tpot, e2e, rps)
