"""What a ``--trace 1`` run reads from the device and the host: the
profiler's kernel intervals over a traced span (their union is the busy
time), the longest idle gaps labelled with what the host was doing, and
the census of host syncs under PyTorch's sync debug mode.

Spans of the benchmark's own (``span``) wrap its calls into the program's
layers (``admit_many``, ``engine.step``); they
are ``torch.profiler.record_function`` ranges, so they land in the same
trace as the kernels.
"""

from __future__ import annotations

import contextlib
import sys
import warnings
from typing import Dict, List, Tuple

import torch

SPANS = ("admit_many", "engine.step")
WINDOW = "perfbench.traced"


@contextlib.contextmanager
def span(name: str):
    with torch.profiler.record_function(name):
        yield


def _events(prof) -> Tuple[List, List]:
    """(device intervals [(name, start_us, end_us)], host intervals) from a
    finished profiler; the device list holds kernels, copies and sets (the
    mirrors of the benchmark's own spans on the device timeline are
    dropped: they are no work)."""
    dev, host = [], []
    ours = set(SPANS) | {WINDOW}
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() / 1e3
        t = s + e.duration_ns() / 1e3
        on_dev = e.device_type() == cuda
        if not (on_dev and e.name() in ours):
            (dev if on_dev else host).append((e.name(), s, t))
    return dev, host


def union(intervals: List[Tuple[float, float]], lo: float, hi: float
          ) -> Tuple[float, List[Tuple[float, float]]]:
    """(covered length, the gaps) of intervals clipped to [lo, hi]."""
    busy, gaps, cur = 0.0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
            cur = s
        if e > cur:
            busy += e - cur
            cur = e
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


def read_profile(prof, top: int = 10) -> Dict:
    """The traced span's device busy time, its length, the kernels' device
    time by name, and the ``top`` longest idle gaps, each labelled with the
    benchmark's span and the innermost host op around its middle."""
    dev, host = _events(prof)
    win = [(s, e) for n, s, e in host if n == WINDOW]
    if not win:
        raise RuntimeError("the traced span is missing from the profile")
    lo, hi = win[0]
    busy, gaps = union([(s, e) for _, s, e in dev], lo, hi)
    by_name: Dict[str, float] = {}
    kernels = []
    for n, s, e in dev:
        if e > lo and s < hi:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
            kernels.append((n, s / 1e6, e / 1e6))
    labelled = []
    ops = [(n, s, e) for n, s, e in host if n != WINDOW]
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (g0 + g1) / 2
        around = [(e - s, n) for n, s, e in ops if s <= mid <= e]
        mine = [n for _, n in sorted(around, reverse=True) if n in SPANS]
        other = [n for _, n in sorted(around) if n not in SPANS]
        label = " > ".join(mine[-1:] + other[:1]) or "no host span"
        labelled.append([label, (g1 - g0) / 1e6])
    return {"busy_s": busy / 1e6, "window_s": (hi - lo) / 1e6,
            "kernels": kernels, "by_name": by_name, "gaps": labelled}


class SyncCensus:
    """Counts the syncs PyTorch's sync debug mode reports (blocking copies
    and explicit waits), each attributed to the benchmark span it fell in.
    ``where`` is set by the harness around each call it makes."""

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self.where = "other"
        self._old = None

    def _record(self, message, category, filename, lineno, file=None,
                line=None):
        if "synchroniz" in str(message):
            self.counts[self.where] = self.counts.get(self.where, 0) + 1
        elif self._old is not None:
            self._old(message, category, filename, lineno, file, line)

    @contextlib.contextmanager
    def on(self):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            self._old = warnings.showwarning
            warnings.showwarning = self._record
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield self
            finally:
                torch.cuda.set_sync_debug_mode("default")
                warnings.showwarning = self._old


def foreign_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or
    the JAX package's (whole names: ``repro_torch`` is not ``repro``)."""
    banned = {"jax", "jaxlib", "flax", "repro"}
    return sorted({m.split(".")[0] for m in list(sys.modules)} & banned)
