"""The one traffic generator: reads a mix's parameters (``traffic/<mix>.json``)
and yields a closed loop's requests.

The lengths follow a clipped lognormal of a given mean and sigma, as the
port's ``cluster/workload.py`` ``azure_conversation_like`` draws them, but
as stratified quantiles: every block of ``block`` requests holds the same
``block`` input lengths and the same ``block`` output lengths. Their
pairing and order are the mix's own, the same for every seed, so that
every seed offers the engine the same work: in a closed loop the order
decides which requests a window of a few dozen finishes takes in, and an
order drawn from the seed made the work of a window differ by seed. The
seed draws the prompts' tokens.

Parameters of a mix (``traffic/<mix>.json``):

- ``backlog_per_slot``: requests kept queued, per row of the engine;
- ``input`` / ``output``: ``{"mean", "sigma", "lo", "hi"}`` of a clipped
  lognormal, in tokens;
- ``block``: the stratification block;
- ``residual_first``: the first ``max_batch`` requests keep only a share
  of their output (stratified shares: the remaining life of requests
  already in flight), so the window does not open on a batch that
  finishes together;
- ``engine``: Engine keywords this mix sets over the configuration's;
- ``check``: how many served tokens the correctness sample takes;
- ``trace_s``, ``census_steps``: the traced span and the sync census of a
  ``--trace 1`` run.

Other keys (``source``, ``assumed``) document the mix and are not read.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Dict, Iterator, List

import numpy as np

# the stream that pairs and orders the sizes: a constant, not the seed
ORDER = 0


@dataclasses.dataclass
class Req:
    """One generated request: its prompt and output length."""
    idx: int
    prompt: List[int]
    max_new: int


def lognormal_quantiles(mean: float, sigma: float, lo: int, hi: int,
                        n: int) -> np.ndarray:
    """The ``n`` midpoint quantiles ((i + 0.5) / n) of a lognormal of the
    given mean and sigma, clipped to [lo, hi] and rounded down, as
    ``azure_conversation_like`` clips its draws."""
    mu = math.log(mean) - sigma ** 2 / 2.0
    nd = NormalDist()
    q = np.array([math.exp(mu + sigma * nd.inv_cdf((i + 0.5) / n))
                  for i in range(n)])
    return np.clip(q, lo, hi).astype(np.int64)


def clipped_lognormal_mean(mean: float, sigma: float, lo: int, hi: int
                           ) -> float:
    """The mean of ``clip(X, lo, hi)`` for that lognormal X (before the
    rounding down), in closed form."""
    mu = math.log(mean) - sigma ** 2 / 2.0
    nd = NormalDist()
    a = (math.log(lo) - mu) / sigma
    b = (math.log(hi) - mu) / sigma
    inner = mean * (nd.cdf(b - sigma) - nd.cdf(a - sigma))
    return lo * nd.cdf(a) + inner + hi * (1.0 - nd.cdf(b))


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one stream of a seed; any whole number is a
    seed (taken modulo 2**64)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def requests(mix: Dict, seed: int, vocab: int, max_batch: int
             ) -> Iterator[Req]:
    """The mix's requests in order, without end: sizes in the mix's own
    order, tokens from ``seed``."""
    n = int(mix["block"])
    ins = lognormal_quantiles(n=n, **mix["input"])
    outs = lognormal_quantiles(n=n, **mix["output"])
    order = rng_of(ORDER, 0)
    tokens = rng_of(seed, 1)
    first = max_batch if mix.get("residual_first") else 0
    shares = rng_of(ORDER, 1).permutation(
        (np.arange(first) + 0.5) / max(first, 1))
    idx = 0
    while True:
        pi = order.permutation(n)
        po = order.permutation(n)
        for j in range(n):
            s_in, s_out = int(ins[pi[j]]), int(outs[po[j]])
            if idx < first:
                s_out = max(1, int(math.ceil(shares[idx] * s_out)))
            prompt = tokens.integers(0, vocab, size=s_in).tolist()
            yield Req(idx, prompt, s_out)
            idx += 1
