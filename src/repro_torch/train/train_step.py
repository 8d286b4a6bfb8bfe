"""Training step: microbatched gradient accumulation + AdamW (port of
``repro/train/train_step.py``).

The batch is split into microbatches; each one's gradients come from
``torch.autograd.grad`` of ``model.loss`` (each layer rematerialised with
the model's ``remat``), optionally round-trip through bf16 (the
compression hook), and accumulate in fp32; their mean feeds
``adamw_update``, which updates the state in place. On the card the
attention layers train through the flash forward and backward kernels.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                         adamw_update, global_norm,
                                         init_adamw, leaves, tree_map)


class TrainState(NamedTuple):
    params: Dict
    opt: AdamWState


def init_train_state(params) -> TrainState:
    return TrainState(params, init_adamw(params))


def train_state_specs(param_specs) -> TrainState:
    """Logical-name tree matching ``TrainState`` (the reference's, for its
    ``in_shardings``): the moments carry the params' names, ``step`` is
    replicated."""
    return TrainState(
        params=param_specs,
        opt=AdamWState(step=(), m=param_specs, v=param_specs))


def choose_microbatches(global_batch: int, seq_len: int, vocab: int,
                        n_chips: int, logit_budget_bytes: float = 2.68e8
                        ) -> int:
    """Pick grad-accum steps so per-chip microbatch logits stay under budget.

    logits bytes/chip ~= mb*seq*vocab*4 / n_chips (batch+vocab sharded).
    """
    n_micro = 1
    while n_micro < global_batch:
        mb = global_batch // n_micro
        if mb * seq_len * vocab * 4.0 / n_chips <= logit_budget_bytes:
            break
        n_micro *= 2
    return min(n_micro, global_batch)


def split_microbatches(batch: Dict, n: int):
    """``batch`` as ``n`` microbatches along the batch axis: axis 1 of the
    (3, B, S) M-RoPE ``positions``, axis 0 of every other leaf."""
    def piece(key, x, i):
        axis = 1 if key == "positions" else 0
        b = x.shape[axis]
        if b % n:
            raise ValueError(f"batch {b} is not a multiple of {n} "
                             f"microbatches")
        return x.narrow(axis, i * (b // n), b // n)
    return [{k: piece(k, v, i) for k, v in batch.items()} for i in range(n)]


def make_train_step(model, opt_cfg: Optional[AdamWConfig] = None,
                    n_microbatches: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``: ``batch``
    a dict of tensors on the parameters' device with leading dim
    global_batch (``positions`` (3, B, S)); ``metrics`` ``loss`` (the
    microbatches' mean) and ``grad_norm`` (of the mean gradient), 0-dim
    fp32 tensors on the device. The state is updated in place."""
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        gsum: list = []
        lsum = 0.0
        for mb in split_microbatches(batch, n_microbatches):
            # fresh leaves that alias the parameters: the state's tensors
            # never require grad, so serving them afterwards records nothing
            alias = tree_map(lambda p: p.detach().requires_grad_(True),
                             state.params)
            loss = model.loss(alias, mb)
            grads = list(torch.autograd.grad(loss, list(leaves(alias))))
            del alias
            with torch.no_grad():
                # leaf by leaf into the fp32 sum, each gradient freed as it
                # lands (no second full set of gradients alive at once); the
                # sum starts as a copy, since autograd may hand two leaves
                # one gradient tensor
                for i, g in enumerate(grads):
                    grads[i] = None
                    if opt_cfg.compress_grads_bf16:
                        g = g.to(torch.bfloat16)
                    if len(gsum) <= i:
                        gsum.append(g.to(torch.float32, copy=True))
                    else:
                        gsum[i].add_(g)
                lsum = lsum + loss.detach()
            del grads, loss
        with torch.no_grad():
            for s in gsum:
                s.div_(n_microbatches)
            it = iter(gsum)
            grads = tree_map(lambda _: next(it), state.params)
            params, opt = adamw_update(opt_cfg, grads, state.opt,
                                       state.params)
            metrics = {"loss": lsum / n_microbatches,
                       "grad_norm": global_norm(grads)}
        return TrainState(params, opt), metrics

    return train_step
