"""Dense feed-forward blocks (port of ``repro/models/ffn.py``)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.models.common import ParamDef, activation


def ffn_schema(d_model: int, d_ff: int, gated: bool, bias: bool) -> Dict:
    s = {
        "w_up": ParamDef((d_model, d_ff), ("embed", "ffn")),
        "w_down": ParamDef((d_ff, d_model), ("ffn", "embed")),
    }
    if gated:
        s["w_gate"] = ParamDef((d_model, d_ff), ("embed", "ffn"))
    if bias:
        s["b_up"] = ParamDef((d_ff,), ("ffn",), "zeros")
        s["b_down"] = ParamDef((d_model,), ("embed",), "zeros")
    return s


def ffn_apply(p: Dict, x: torch.Tensor, act: str, gated: bool,
              row_parallel: Optional[Callable[[torch.Tensor, torch.Tensor],
                                              torch.Tensor]] = None
              ) -> torch.Tensor:
    """The FFN of ``x``. Under tensor parallelism ``w_up`` / ``w_gate`` /
    ``b_up`` hold this rank's ffn columns and ``w_down`` its rows:
    ``row_parallel(h, w_down)`` is the product summed over the ranks,
    before ``b_down`` is added once."""
    h = x @ p["w_up"]
    if "b_up" in p:
        h = h + p["b_up"]
    a = activation(act)
    if gated:
        h = a(x @ p["w_gate"]) * h
    else:
        h = a(h)
    if row_parallel is None:
        y = h @ p["w_down"]
    else:
        y = row_parallel(h, p["w_down"])
    if "b_down" in p:
        y = y + p["b_down"]
    return y
