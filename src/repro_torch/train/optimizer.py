"""AdamW with global-norm gradient clipping (port of
``repro/train/optimizer.py``), as plain functions over the parameter dict.

The reference's semantics and order, exactly: the clip scale
``min(1, clip / (|g| + 1e-9))`` from the global norm of the raw gradients,
computed before the step advances; the learning rate
``lr * min(1, (step + 1) / warmup)`` on the OLD step; bias correction on the
NEW step; decoupled weight decay on leaves with ``ndim >= 2`` only; fp32
moments whatever the parameter's dtype; the result cast back to the
parameter's dtype. ``torch.optim.AdamW`` orders decay and clipping
differently and is not used.

Where the reference is functional, ``adamw_update`` updates the parameters
and the moments IN PLACE under ``torch.no_grad()`` (the port's counterpart
of ``donate_argnums``) and returns them with the advanced step. ``step`` is
a Python int: the schedule's scalars are host numbers, so a step issues no
device-to-host copy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch


class AdamWState(NamedTuple):
    step: int                # steps taken
    m: Any                   # fp32 tree shaped like the params
    v: Any                   # fp32 tree shaped like the params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    # gradient compression hook: each microbatch's gradients round-trip
    # through bf16 before the fp32 accumulation, what a data-parallel
    # all-reduce in bf16 would carry
    compress_grads_bf16: bool = True


def leaves(tree) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_adamw(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(0, tree_map(zeros, params), tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, in fp32, on the device."""
    sq = [torch.sum(torch.square(g.float())) for g in leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def _f32(x) -> np.float32:
    return np.float32(x)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params,
                 gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, AdamWState]:
    """One AdamW step; ``params``, ``state.m`` and ``state.v`` are updated
    in place. Returns (params, the state with ``step + 1``). ``gnorm``:
    the global norm the clip scales by, where ``grads`` are one rank's
    shards of a tree split over ranks (a mesh step sums each element once
    over the ranks); by default ``global_norm(grads)``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    # the schedule's scalars in fp32, as the reference computes them
    warm = min(_f32(1.0), _f32(state.step + 1) / _f32(max(1,
                                                          cfg.warmup_steps)))
    lr = float(_f32(cfg.lr) * warm)
    b1c = float(_f32(1.0) - _f32(cfg.b1) ** _f32(step))
    b2c = float(_f32(1.0) - _f32(cfg.b2) ** _f32(step))
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        p32 = p.float()
        if p.ndim >= 2:             # decoupled weight decay, matrices only
            delta = delta + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    return params, AdamWState(step, state.m, state.v)
