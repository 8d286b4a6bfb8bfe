"""Typed event core for the discrete-event cluster simulator.

The round-lockstep ``ClusterSim`` grew a priority queue organically —
``(t, seq, kind_str, payload)`` tuples dispatched through an if/elif
ladder.  That shape cannot express what the §5 fault-tolerance claims
actually depend on: *overlapping* control-plane work (a replacement-node
weight fetch racing a KV publish on the same store link) and resources
whose state at event time changes the cost of the next decision.

This module is the Helix-style core (SNIPPETS.md §3): a frozen ``Event``
hierarchy, a stable-ordered ``EventQueue``, and a ``dispatch`` loop that
routes each popped event to the handler registered for its type.  The
simulator owns the handlers; this module owns ordering and dispatch, so
event semantics live in exactly one place and new event kinds (transfers,
region-correlated preemptions) are a dataclass + a handler, not another
elif arm.

Ordering contract: events pop by (time, insertion sequence) — ties break
FIFO, which the parity gate in tests/test_cluster_des.py relies on (the
closed-form and networked paths must interleave identically in the
uncontended limit).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Dict, List, Optional, Tuple, Type


@dataclasses.dataclass(frozen=True)
class Event:
    """Base class; concrete events below carry their payloads."""


@dataclasses.dataclass(frozen=True)
class Arrive(Event):
    """A request enters the cluster (payload: simulator ReqState)."""
    req: object


@dataclasses.dataclass(frozen=True)
class Interrupt(Event):
    """A spot pool reclaims ``count`` instances (availability delta < 0)."""
    pool: str
    count: int = 1


@dataclasses.dataclass(frozen=True)
class Revive(Event):
    """A replaced pipeline comes back up (its warm-up completed)."""
    pid: int


@dataclasses.dataclass(frozen=True)
class Wake(Event):
    """A pipeline should run its next scheduling iteration."""
    pid: int


@dataclasses.dataclass(frozen=True)
class TransferDone(Event):
    """A network transfer finished occupying its link (payload:
    ``network.Transfer``).  Completion times are known at submit for
    serialized links; this event closes the transfer's lifecycle on the
    queue so handlers can account per-kind completions in time order."""
    transfer: object


Handler = Callable[[float, Event], None]


class EventQueue:
    """Priority queue of (time, event) with FIFO tie-breaking."""

    def __init__(self) -> None:
        self._heap: List[Tuple[float, int, Event]] = []
        self._seq = itertools.count()

    def push(self, t: float, ev: Event) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), ev))

    def pop(self) -> Tuple[float, Event]:
        t, _, ev = heapq.heappop(self._heap)
        return t, ev

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


def dispatch(queue: EventQueue, handlers: Dict[Type[Event], Handler],
             until: float = float("inf")) -> float:
    """Drain ``queue`` through ``handlers`` until it empties or the next
    event lies beyond ``until``.  Returns the time of the last handled
    event (0.0 if none ran).  Unregistered event types raise — a missing
    handler is a simulator bug, not an ignorable event."""
    t_last = 0.0
    while queue:
        t, ev = queue.pop()
        if t > until:
            break
        handlers[type(ev)](t, ev)
        t_last = t
    return t_last
