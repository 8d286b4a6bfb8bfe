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

from typing import Dict, Tuple

import torch

from repro_torch.models.common import ParamDef, activation


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
              capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, H) -> ((B, S, H), router probs (T, E), expert indices
    (T, k)). The reference also returns the load-balancing aux loss; here
    ``moe_aux`` computes it from the router outputs, so serving, which
    drops it, does not pay for it."""
    b, s, h = x.shape
    e = p["router"].shape[-1]
    t = b * s
    xt = x.reshape(t, h)
    probs, gates, idx = route(p, xt, top_k)

    cap = _capacity(t, e, top_k, capacity_factor)
    # position of each (token, k) pair in its expert's queue, flat order
    flat_expert = idx.reshape(-1)                                # (T*k,)
    onehot = torch.nn.functional.one_hot(flat_expert, e)         # (T*k, E)
    before = torch.cumsum(onehot, dim=0) - onehot                # exclusive
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
    out_buf = torch.bmm(hmid, p["w_down"]).reshape(e * cap, h)

    # combine: each pair's slot output, weighted by its gate, summed over k
    weight = (gates.reshape(-1) * keep).to(out_buf.dtype)
    per_pair = out_buf[slot] * weight[:, None]
    out = per_pair.reshape(t, top_k, h).sum(dim=1)
    return out.reshape(b, s, h), probs, idx


def moe_aux(probs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balancing loss of one ``moe_apply`` call's router
    outputs: E * sum(mean prob per expert * share of first choices)."""
    e = probs.shape[-1]
    me = probs.mean(dim=0)                                       # (E,)
    ce = torch.nn.functional.one_hot(idx[:, 0], e).float().mean(dim=0)
    return e * torch.sum(me * ce)
