"""Top-k mixture-of-experts FFN with capacity dispatch (port of
``repro/models/moe.py``).

Tokens are flattened to (T, H); each (token, k) pair gets a slot in its
expert's capacity buffer (E, C, H); pairs past an expert's capacity are
dropped (their gate weight contributes nothing). Every expert's buffer is
computed, full or empty, as in the reference: a decode step reads all the
experts' weights.

Three details carry the reference's exact token choices over:

* top-k ties go to the lower expert index, as ``jax.lax.top_k`` breaks
  them (``torch.topk`` promises no order on ties; a stable descending sort
  does);
* slots are handed out in flattened (token-major, k-minor) order by an
  exclusive cumulative count, over the whole flattened batch, so every row
  of a batch (dead engine rows included) competes for the same capacity;
* the router logits are the product in the activation dtype cast to fp32;
  the renormalised gates are cast back to the activation dtype before they
  weight the expert outputs.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.common import ParamDef, activation, matmul_fp32


def moe_schema(d_model: int, d_ff: int, n_experts: int, gated: bool) -> Dict:
    s = {
        "router": ParamDef((d_model, n_experts), ("embed", None)),
        "w_up": ParamDef((n_experts, d_model, d_ff),
                         ("experts", "embed", "expert_ffn")),
        "w_down": ParamDef((n_experts, d_ff, d_model),
                           ("experts", "expert_ffn", "embed")),
    }
    if gated:
        s["w_gate"] = ParamDef((n_experts, d_model, d_ff),
                               ("experts", "embed", "expert_ffn"))
    return s


def _capacity(n_tokens: int, n_experts: int, top_k: int,
              capacity_factor: float) -> int:
    c = int(n_tokens * top_k / n_experts * capacity_factor)
    return max(4, min(n_tokens, c))


def route(p: Dict, xt: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router of flattened tokens xt (T, H): (probs (T, E) fp32, top-k
    gates renormalised (T, k), expert indices (T, k)); ties to the lower
    expert index."""
    logits = (xt @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    idx = order[:, :top_k]
    gates = torch.gather(probs, 1, idx)
    return probs, gates / gates.sum(dim=-1, keepdim=True), idx


def moe_apply(p: Dict, x: torch.Tensor, top_k: int, act: str, gated: bool,
              capacity_factor: float = 1.25,
              reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
              queue_share: Optional[Callable[[torch.Tensor], Tuple[
                  torch.Tensor, int]]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, H) -> ((B, S, H), router probs (T, E), expert indices
    (T, k)). The reference also returns the load-balancing aux loss; here
    ``moe_aux`` computes it from the router outputs, so serving, which
    drops it, does not pay for it.

    Under tensor parallelism the router is whole on every rank (every rank
    routes and drops the same pairs) and the experts' FFNs hold this
    rank's ``expert_ffn`` slice: their ``w_down`` products stay fp32
    through the combine, ``reduce`` sums the combined output (B, S, H)
    over the ranks (or, with the sequence cut by the ``seq`` rule, into
    this rank's slice of the positions), and it is rounded once to the
    activation dtype (as the dense row-parallel products). When the batch
    is split over ranks,
    ``queue_share(counts)`` takes this rank's pairs per expert (E,) and
    returns (the pairs per expert of the ranks whose rows come first, the
    number of such row shards): capacity and queue positions are then
    those of the whole batch, as in the unsplit layer."""
    b, s, h = x.shape
    e = p["router"].shape[-1]
    t = b * s
    xt = x.reshape(t, h)
    probs, gates, idx = route(p, xt, top_k)

    # position of each (token, k) pair in its expert's queue, flat order
    flat_expert = idx.reshape(-1)                                # (T*k,)
    onehot = torch.nn.functional.one_hot(flat_expert, e)         # (T*k, E)
    before = torch.cumsum(onehot, dim=0) - onehot                # exclusive
    shards = 1
    if queue_share is not None:
        earlier, shards = queue_share(onehot.sum(dim=0))
        before = before + earlier
    cap = _capacity(t * shards, e, top_k, capacity_factor)
    pos = torch.gather(before, 1, flat_expert[:, None])[:, 0]
    keep = pos < cap
    slot = flat_expert * cap + torch.where(keep, pos, torch.zeros_like(pos))

    token_idx = torch.arange(t, device=x.device).repeat_interleave(top_k)
    gathered = torch.where(keep[:, None], xt[token_idx],
                           torch.zeros((), dtype=xt.dtype, device=x.device))
    buf = torch.zeros((e * cap, h), dtype=xt.dtype, device=x.device)
    buf.index_add_(0, slot, gathered)      # dropped pairs add 0 to slot 0
    buf = buf.reshape(e, cap, h)

    # expert compute: (E, C, H) x (E, H, F), every expert
    hmid = torch.bmm(buf, p["w_up"])
    a = activation(act)
    if gated:
        hmid = a(torch.bmm(buf, p["w_gate"])) * hmid
    else:
        hmid = a(hmid)
    if reduce is None:
        out_buf = torch.bmm(hmid, p["w_down"])
    else:
        # row-parallel w_down: fp32 partials, combined and summed over the
        # ranks in fp32 and rounded once, as the dense layers' products
        out_buf = matmul_fp32(hmid, p["w_down"])
    out_buf = out_buf.reshape(e * cap, h)

    # combine: each pair's slot output, weighted by its gate, summed over k
    weight = (gates.reshape(-1) * keep).to(x.dtype).to(out_buf.dtype)
    per_pair = out_buf[slot] * weight[:, None]
    out = per_pair.reshape(t, top_k, h).sum(dim=1).reshape(b, s, h)
    if reduce is not None:
        out = reduce(out).to(x.dtype)
    return out, probs, idx


def moe_aux(probs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balancing loss of one ``moe_apply`` call's router
    outputs: E * sum(mean prob per expert * share of first choices)."""
    e = probs.shape[-1]
    me = probs.mean(dim=0)                                       # (E,)
    ce = torch.nn.functional.one_hot(idx[:, 0], e).float().mean(dim=0)
    return e * torch.sum(me * ce)


def moe_aux_shard(probs: torch.Tensor, idx: torch.Tensor, n_tokens: int,
                  reduce: Optional[Callable[[torch.Tensor], torch.Tensor]]
                  = None) -> torch.Tensor:
    """A row shard's part of ``moe_aux`` over a batch of ``n_tokens``
    tokens split over ranks: E * sum(this shard's summed probabilities /
    n_tokens * share of first choices over every shard), the shares'
    counts summed over the shards by ``reduce`` (they carry no gradient).
    The parts sum over the shards to ``moe_aux`` of the whole batch, and
    each part's gradient reaches only its rows."""
    e = probs.shape[-1]
    me = probs.sum(dim=0) / n_tokens
    first = torch.nn.functional.one_hot(idx[:, 0], e).float().sum(dim=0)
    if reduce is not None:
        first = reduce(first)
    return e * torch.sum(me * (first / n_tokens))
