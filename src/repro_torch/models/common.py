"""Shared model building blocks (port of ``repro/models/common.py``):
norms, activations, RoPE, and schema-driven parameter initialization.

Parameters are nested dicts of tensors with the same names and the same
``(d_in, d_out)`` layouts as the JAX package, so ``models/convert.py`` can
copy a JAX tree across without transposes. Initialization draws from an
explicit ``torch.Generator`` with the distributions of the JAX
``_init_array``; the numbers differ from ``jax.random``'s (the parity tests
convert JAX-initialised params instead).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    names: Tuple[Optional[str], ...]
    init: str = "normal"   # normal | zeros | ones | small_normal | mamba_*
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.names), (self.shape, self.names)


def stack_schema(schema: Dict, n: int) -> Dict:
    """Prepend the stacked layer dimension to every ParamDef in a schema."""
    out = {}
    for k, v in schema.items():
        if isinstance(v, dict):
            out[k] = stack_schema(v, n)
        else:
            out[k] = ParamDef((n,) + v.shape, ("layers",) + v.names,
                              v.init, v.scale)
    return out


def _init_tensor(d: ParamDef, gen: torch.Generator, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init == "mamba_dt":
        # dt bias so softplus(dt_bias) spans [1e-3, 1e-1]
        u = torch.rand(d.shape, generator=gen, dtype=torch.float32,
                       device=device)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                       + math.log(1e-3))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    if d.init == "mamba_alog":
        n = math.prod(d.shape) or 1
        a = torch.linspace(1.0, 16.0, n, dtype=torch.float32, device=device)
        return torch.log(a).reshape(d.shape).to(dtype)
    scale = d.scale if d.init == "normal" else d.scale * 0.25
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(dtype)


def init_params(schema: Dict, gen: torch.Generator, dtype: torch.dtype,
                device: torch.device) -> Dict:
    """Nested param dict drawn leaf by leaf (sorted key order) from ``gen``."""
    def build(node):
        if isinstance(node, ParamDef):
            return _init_tensor(node, gen, dtype, device)
        return {k: build(node[k]) for k in sorted(node)}
    return build(schema)


def schema_shapes(schema: Dict) -> Dict:
    def walk(node):
        if isinstance(node, ParamDef):
            return tuple(node.shape)
        return {k: walk(v) for k, v in node.items()}
    return walk(schema)


def param_count(schema: Dict) -> int:
    def walk(node):
        if isinstance(node, ParamDef):
            n = 1
            for s in node.shape:
                n *= s
            return n
        return sum(walk(v) for v in node.values())
    return walk(schema)


# ---------------------------------------------------------------------------
# Norms & activations
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * w.float()).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None, eps: float = 1e-5
               ) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * w.float()
    if b is not None:
        y = y + b.float()
    return y.to(dt)


def make_norm(kind: str):
    if kind == "rmsnorm":
        return lambda x, p: rms_norm(x, p["w"])
    return lambda x, p: layer_norm(x, p["w"], p.get("b"))


def norm_schema(kind: str, dim: int) -> Dict:
    s = {"w": ParamDef((dim,), ("embed",), "ones")}
    if kind == "layernorm":
        s["b"] = ParamDef((dim,), ("embed",), "zeros")
    return s


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation(kind: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[kind]


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split rotation, fp32 inside)
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    half = head_dim // 2
    expo = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), expo)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions broadcastable to (..., S)."""
    if theta <= 0:
        return x
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)     # (half,)
    ang = positions[..., None].float() * freqs                 # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                         # (..., S, 1, h)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)
