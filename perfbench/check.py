"""How a run's ``correct`` is decided: a sample of the requests the timed path
finished, drawn from the seed with the longest among them, is run through
the plain reference over each prompt and its served tokens; the number
compared is the widest gap by which a served (greedy) token's logit lies
below the reference's best at that position.

The control (``control.py``) reads the same gap for the token that the
reference in float8 puts first at each of those positions.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from perfbench.loadgen import rng_of


def sample(finished: Sequence, seed: int, served_tokens: int,
           max_requests: int) -> List:
    """The finished request with the most served tokens, then others in
    an order drawn from the seed, until ``served_tokens`` are covered or
    ``max_requests`` taken."""
    pool = sorted(finished, key=lambda r: r.idx)
    if not pool:
        return []
    longest = max(pool, key=lambda r: (len(r.generated), -r.idx))
    rest = [r for r in pool if r is not longest]
    order = rng_of(seed, 3).permutation(len(rest)).tolist()
    out, n = [longest], len(longest.generated)
    for j in order:
        if n >= served_tokens or len(out) >= max_requests:
            break
        out.append(rest[j])
        n += len(rest[j].generated)
    return out


def gaps(logits: torch.Tensor, chosen: Sequence[int]) -> torch.Tensor:
    """Per position: the best logit minus the logit of the chosen token."""
    idx = torch.as_tensor(list(chosen), dtype=torch.long,
                          device=logits.device)
    best = logits.max(dim=-1).values
    return best - logits.gather(1, idx[:, None])[:, 0]


def served_gap(ref_logits: Sequence[torch.Tensor],
               served: Sequence[Sequence[int]]) -> float:
    """The widest gap over every sampled request's served tokens."""
    return max(float(gaps(lg, s).max()) for lg, s in zip(ref_logits, served))


def control_gap(ref_logits: Sequence[torch.Tensor],
                ctl_logits: Sequence[torch.Tensor]) -> float:
    """The widest gap of the tokens the control puts first."""
    return max(float(gaps(r, c.argmax(dim=-1).tolist()).max())
               for r, c in zip(ref_logits, ctl_logits))


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Each number against its limit (a number passes at or below its
    limit); returns (all pass, {name: {value, limit}})."""
    table = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(values[k] <= limits[k] for k in limits)
    return ok, table
