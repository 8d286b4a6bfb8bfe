"""Network links as first-class contended resources (Helix-style).

The closed-form simulator priced every transfer — replacement-node weight
fetch, KV publish, prefix warm-up — as a constant, which silently assumes
every link is idle.  The §5 fault-tolerance argument is about exactly the
opposite regime: control-plane transfers *overlap* with serving and with
each other, and two warm-ups racing on one store link finish later than
either alone.

``NetworkLink`` models a serialized (FIFO) full-duplex-agnostic pipe:
transmissions queue behind ``busy_until`` and occupy the link back to
back.  Because service order is submission order and rates are constant,
the completion time of a transfer is known at submit time:

    start = max(t_submit, busy_until)
    end   = start + latency_s + nbytes / bw_bps

This keeps the discrete-event simulator deterministic (no re-sorting of
in-flight transfers) while still producing real contention: the *wait*
component (start - submit) is exactly the queueing delay other traffic
imposed.  ``Topology`` wires per-region store links (store ↔ every node
in the region) and pairwise cross-region links.

Uncontended-limit calibration: ``bytes_for_duration`` inverts the service
curve so a transfer submitted on an idle link takes exactly the closed
form's constant (e.g. ``FTConfig.store_load_s``) — the DES then reproduces
the legacy timeline to float precision when nothing contends, which is the
parity gate in tests/test_cluster_des.py.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Transfer:
    """One serialized transmission on a link (all times absolute seconds)."""
    kind: str                 # "warmup" | "kv_publish" | "prefix_warm" | ...
    nbytes: float
    submit_s: float
    start_s: float
    end_s: float
    link: "NetworkLink"

    @property
    def wait_s(self) -> float:
        """Queueing delay imposed by traffic ahead of us on the link."""
        return self.start_s - self.submit_s


class NetworkLink:
    """A bandwidth-limited pipe that serializes its transmissions."""

    def __init__(self, name: str, bw_bps: float, latency_s: float = 0.0):
        self.name = name
        self.bw_bps = float(bw_bps)
        self.latency_s = float(latency_s)
        self.busy_until = 0.0
        # accounting
        self.n_transfers = 0
        self.total_bytes = 0.0
        self.busy_s = 0.0
        self.wait_s = 0.0
        self.by_kind: Dict[str, int] = defaultdict(int)

    def duration_s(self, nbytes: float) -> float:
        return self.latency_s + nbytes / self.bw_bps

    def bytes_for_duration(self, duration_s: float) -> float:
        """Payload size whose uncontended transfer takes ``duration_s``."""
        return max(0.0, duration_s - self.latency_s) * self.bw_bps

    def queue_wait_s(self, t: float) -> float:
        """Wait a transfer submitted now (at ``t``) would incur — the link
        state recovery pricing reads at decision time."""
        return max(0.0, self.busy_until - t)

    def submit(self, t: float, kind: str, nbytes: float) -> Transfer:
        start = max(t, self.busy_until)
        dur = self.duration_s(nbytes)
        end = start + dur
        self.busy_until = end
        self.n_transfers += 1
        self.total_bytes += nbytes
        self.busy_s += dur
        self.wait_s += start - t
        self.by_kind[kind] += 1
        return Transfer(kind, nbytes, t, start, end, self)


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Bandwidth/latency of one link class in a region's topology."""
    bw_bps: float
    latency_s: float = 0.0


# Defaults sized like the paper's store path: ~25 Gbit/s effective to the
# shared tensor store inside a region, ~5 Gbit/s across regions.
STORE_LINK = LinkSpec(bw_bps=25e9 / 8, latency_s=0.05)
CROSS_REGION_LINK = LinkSpec(bw_bps=5e9 / 8, latency_s=0.15)


class Topology:
    """Per-region store links + pairwise cross-region links.

    One store link per region models the shared tensor store's ingress/
    egress NIC — the §5.2 bottleneck every warm-up, KV publish, and prefix
    warm in that region rides.  Cross-region links are created lazily per
    unordered region pair.
    """

    def __init__(self, regions: Optional[Dict[str, LinkSpec]] = None,
                 cross: LinkSpec = CROSS_REGION_LINK):
        self._store_spec: Dict[str, LinkSpec] = dict(regions or {})
        self._cross_spec = cross
        self._store: Dict[str, NetworkLink] = {}
        self._cross: Dict[Tuple[str, str], NetworkLink] = {}

    def store_link(self, region: str = "local") -> NetworkLink:
        if region not in self._store:
            spec = self._store_spec.get(region, STORE_LINK)
            self._store[region] = NetworkLink(f"store:{region}", spec.bw_bps,
                                              spec.latency_s)
        return self._store[region]

    def cross_link(self, a: str, b: str) -> NetworkLink:
        key = (a, b) if a <= b else (b, a)
        if key not in self._cross:
            s = self._cross_spec
            self._cross[key] = NetworkLink(f"xr:{key[0]}<->{key[1]}",
                                           s.bw_bps, s.latency_s)
        return self._cross[key]

    def links(self) -> List[NetworkLink]:
        return list(self._store.values()) + list(self._cross.values())

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {ln.name: {"n": ln.n_transfers, "bytes": ln.total_bytes,
                          "busy_s": ln.busy_s, "wait_s": ln.wait_s}
                for ln in self.links()}
