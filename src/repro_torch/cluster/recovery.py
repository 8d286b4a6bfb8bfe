"""Hybrid request-recovery policy — the paper's §8.1 future work,
implemented.

The paper adopts recomputation-only migration because KV transfer must
complete inside the grace period and fails catastrophically mid-transfer.
It then notes (Discussion §8.1) that recomputation loses at very long
contexts (~9.6% slower at 64k on L40S) and sketches a hybrid: "track the
progress of in-flight requests and the remaining grace period, and select
an appropriate request recovery mechanism for each request individually."

This module is that policy. Per interrupted request:

    recompute_cost  = bottleneck-stage prefill over (s_in + generated)
    transfer_cost   = setup + kv_bytes(ctx) / effective_bw    [paper Fig 5]
    kv_restore_cost = setup + kv_bytes(ctx) / store_bw        [§5.2 store]
    pick transfer iff  transfer_cost < recompute_cost
                   and transfer fits in the REMAINING grace budget
                   (the paper's §5.1 safety constraint — otherwise a
                   mid-transfer reclaim forces paying both costs)
    pick kv_restore iff the store already HOLDS the request's blocks
                   (``store_has_kv`` — the paged engine published them
                   during the grace window, see serving/server.py) and it
                   beats the other eligible mechanisms. Restoring from the
                   store happens after revival, so it carries no grace-
                   period constraint — publication already completed.

The cluster simulator (``repro_torch/cluster/simulator.py``) charges the
chosen mechanism's cost on re-admission. In the serving engine, the
cost-aware preemption-victim policy prices a slot's re-admission with
``preemption_seconds`` and ``recompute_seconds``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.estimator import Placement, stage_latencies
from repro_torch.core.modelspec import ModelSpec

# Fig-5-calibrated transfer path constants (see bench_migration_tradeoff)
TRANSFER_SETUP_S = 1.0
TRANSFER_EFF = 0.25
# tensor-store restore path: node-local host memory -> device, no network
# race — a pinned-host-to-HBM copy (order PCIe/DMA bandwidth) plus the
# attach round trip
KV_RESTORE_SETUP_S = 0.05
KV_RESTORE_BW_BPS = 8e9


@dataclasses.dataclass(frozen=True)
class RecoveryDecision:
    mechanism: str            # "recompute" | "transfer" | "kv_restore"
    recompute_s: float
    transfer_s: float
    fits_grace: bool
    kv_restore_s: float = float("inf")


def kv_bytes_for_ctx(spec: ModelSpec, ctx: int) -> float:
    total = 0.0
    for l in spec.layers:
        tokens = ctx if l.window is None else min(ctx, l.window)
        total += l.kv_bytes_per_token(spec.dtype_bytes) * tokens
        total += l.state_bytes_per_seq(spec.dtype_bytes)
    return total


def recompute_seconds(spec: ModelSpec, placement: Placement, ctx: int,
                      efficiency: float = 1.0, chunk: int = 0,
                      max_len: int = 0) -> float:
    """Bottleneck-stage prefill over the full context (pipelined view).

    chunk > 0 models the engine's chunked recompute: the same prefill FLOPs
    split into chunks interleaved with live decode, so the migrated
    request's re-admission completes one bottleneck decode step later per
    extra chunk (live slots, in exchange, never stall for the whole
    context — the §5.1 interruption-storm head-of-line fix). Mirrors the
    engine's actual admission rules: only ctx-1 tokens re-prefill (the
    last generated token is fed to decode, ``Engine._prefill_tokens``),
    and when max_len > 0 and the padded span ceil(toks/chunk)*chunk would
    exceed it the engine single-shots (``Engine._use_chunked``)."""
    pre, dec = stage_latencies(spec, placement, 1, max(16, ctx), 1)
    total = max(pre)
    toks = max(ctx - 1, 1)
    if chunk and 0 < chunk < toks:
        n_chunks = -(-toks // chunk)
        if max_len <= 0 or n_chunks * chunk <= max_len:
            total += (n_chunks - 1) * max(dec)
    return total / max(efficiency, 1e-3)


def transfer_seconds(spec: ModelSpec, placement: Placement, ctx: int
                     ) -> float:
    nbytes = kv_bytes_for_ctx(spec, ctx)
    link = placement.stages[0].inter_link()
    return (TRANSFER_SETUP_S + link.alpha_s
            + nbytes / (TRANSFER_EFF * link.beta_bps))


def kv_restore_seconds(spec: ModelSpec, ctx: int,
                       store_bw_bps: float = KV_RESTORE_BW_BPS) -> float:
    """Cost of re-attaching a request's KV blocks from the shared tensor
    store (paged engines publish them during the grace window)."""
    return KV_RESTORE_SETUP_S + kv_bytes_for_ctx(spec, ctx) / store_bw_bps


def preemption_seconds(spec: ModelSpec, ctx: int,
                       store_bw_bps: float = KV_RESTORE_BW_BPS) -> float:
    """Cost of a KV-pool preemption round trip: a demand-paged engine that
    overcommitted its block pool evicts a victim mid-decode, publishing its
    blocks to the node-local store and re-attaching them on re-admission —
    a SELF-INFLICTED kv_restore that also pays the export write (same
    store bandwidth both ways, no grace constraint, no network). Spot
    interruptions hide the publish inside the grace window; a preemption
    has no such window, so both copies land on the serving timeline."""
    return (KV_RESTORE_SETUP_S
            + 2.0 * kv_bytes_for_ctx(spec, ctx) / store_bw_bps)


def decide(spec: ModelSpec, placement: Placement, ctx: int,
           remaining_grace_s: float, policy: str = "hybrid",
           efficiency: float = 1.0, chunk: int = 0,
           max_len: int = 0, store_has_kv: bool = False,
           store_bw_bps: float = KV_RESTORE_BW_BPS,
           store_wait_s: float = 0.0,
           transfer_wait_s: float = 0.0) -> RecoveryDecision:
    """policy: 'recompute' (paper default), 'transfer', or 'hybrid'
    (paper §8.1 future work). chunk > 0 prices recompute under the
    engine's chunked-prefill admission (max_len bounds it as the engine
    does). store_has_kv opens the kv_restore branch for the non-recompute
    policies: the tensor store already holds the request's blocks, so
    restore competes on cost without a grace constraint.

    store_wait_s / transfer_wait_s: queueing delay the respective link
    would impose right now (``NetworkLink.queue_wait_s`` — the discrete-
    event simulator re-derives pricing from link state at decision time).
    0.0 keeps the closed-form uncontended-limit costs. A contended wire
    eats into the grace budget too, so ``fits_grace`` is evaluated on the
    waited transfer time."""
    rc = recompute_seconds(spec, placement, ctx, efficiency, chunk=chunk,
                           max_len=max_len)
    tr = transfer_seconds(spec, placement, ctx) + max(0.0, transfer_wait_s)
    kv = (kv_restore_seconds(spec, ctx, store_bw_bps)
          + max(0.0, store_wait_s)) if store_has_kv else float("inf")
    fits = tr <= remaining_grace_s
    if policy == "recompute":
        mech = "recompute"
    elif policy == "transfer":
        if kv < tr or (kv < float("inf") and not fits):
            mech = "kv_restore"            # resident blocks beat the wire
        else:
            mech = "transfer" if fits else "recompute"   # safety fallback
    else:
        mech, best = "recompute", rc
        if fits and tr < best:
            mech, best = "transfer", tr
        if kv < best:
            mech, best = "kv_restore", kv
    return RecoveryDecision(mech, rc, tr, fits, kv)
