"""Dense feed-forward blocks (port of ``repro/models/ffn.py``)."""

from __future__ import annotations

from typing import Dict

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


def ffn_apply(p: Dict, x: torch.Tensor, act: str, gated: bool
              ) -> torch.Tensor:
    h = x @ p["w_up"]
    if "b_up" in p:
        h = h + p["b_up"]
    a = activation(act)
    if gated:
        h = a(x @ p["w_gate"]) * h
    else:
        h = a(h)
    y = h @ p["w_down"]
    if "b_down" in p:
        y = y + p["b_down"]
    return y
