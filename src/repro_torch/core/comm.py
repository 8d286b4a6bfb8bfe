"""Communication cost model — paper §4.1.2 (alpha-beta / Hockney model).

Ring-based collectives: one AllReduce = ReduceScatter + AllGather, each
moving N/P bytes for P-1 rounds:   t = (alpha + (N/P)/beta) * (P-1)  [x2]

TP incurs 2 AllReduces per transformer layer => Eq. 3's factor 4.
PP transfers one activation tensor per stage boundary (Eq. 2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Link:
    alpha_s: float
    beta_bps: float


def ring_allreduce(nbytes: float, p: int, link: Link) -> float:
    """One ring AllReduce of ``nbytes`` over ``p`` participants."""
    if p <= 1 or nbytes <= 0:
        return 0.0
    per_round = link.alpha_s + (nbytes / p) / link.beta_bps
    return 2.0 * per_round * (p - 1)          # RS + AG


def ring_allgather(nbytes: float, p: int, link: Link) -> float:
    if p <= 1 or nbytes <= 0:
        return 0.0
    return (link.alpha_s + (nbytes / p) / link.beta_bps) * (p - 1)


def p2p(nbytes: float, link: Link) -> float:
    return link.alpha_s + nbytes / link.beta_bps


def tp_comm_latency(batch: int, seq: int, hidden: int, d_tp: int,
                    n_layers: int, link: Link, e: int = 2,
                    allreduces_per_layer: int = 2) -> float:
    """Paper Eq. 3: AllReduce of the (B,S,H) activation, twice per layer.

    Written via :func:`ring_allreduce` so the 4(alpha + BSHE/(D*beta))(D-1)l
    closed form of the paper falls out exactly for allreduces_per_layer=2.
    """
    if d_tp <= 1:
        return 0.0
    nbytes = batch * seq * hidden * e
    return allreduces_per_layer * ring_allreduce(nbytes, d_tp, link) * n_layers


def pp_comm_latency(batch: int, seq: int, hidden: int, link: Link,
                    e: int = 2) -> float:
    """Paper Eq. 2: one activation handoff at a stage boundary."""
    return p2p(batch * seq * hidden * e, link)
