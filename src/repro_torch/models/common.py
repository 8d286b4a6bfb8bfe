"""Shared model building blocks (port of ``repro/models/common.py``):
norms, activations, RoPE and M-RoPE, sinusoidal positions,
schema-driven parameter initialization, and ``astype``, the port's one
cast into an fp8 dtype.

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
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint


# the fp8 storage dtypes the reference's ``weight_dtype`` and
# ``kv_cache_dtype`` name
FP8_DTYPES = {"float8_e4m3fn": torch.float8_e4m3fn,
              "float8_e5m2": torch.float8_e5m2}
# float8_e4m3fn has no infinity: 464 is the midpoint between its largest
# finite value, 448, and the code above it, its NaN, so JAX's cast (round
# to nearest even) turns anything past +-464 into NaN; torch's saturates
# to +-448
E4M3_NAN_PAST = 464.0


def astype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to ``dtype`` with the bytes of JAX's ``astype``: torch's
    cast (the same rounding), except that a ``float8_e4m3fn`` value past
    +-464, or +-inf, becomes NaN (its sign kept), as the reference stores
    it, where torch's cast saturates to +-448. Every write of the port into
    an fp8 tensor (weights, KV caches) goes through it; for any other
    target it is ``x.to(dtype)``."""
    y = x.to(dtype)
    if dtype != torch.float8_e4m3fn or x.dtype == dtype:
        return y
    code = y.view(torch.uint8)
    nan = (code & 0x80) | 0x7F
    return torch.where(x.abs() > E4M3_NAN_PAST, nan, code).view(dtype)


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
                device: torch.device,
                local: Optional[Callable[[ParamDef, torch.Tensor],
                                         torch.Tensor]] = None) -> Dict:
    """Nested param dict drawn leaf by leaf (sorted key order) from
    ``gen``. ``local(def, full)``, when given, maps each full leaf to the
    tensor kept (a rank's shard) before the next leaf is drawn, so the
    numbers equal the unsplit init's and only one full leaf is alive."""
    def build(node):
        if isinstance(node, ParamDef):
            t = _init_tensor(node, gen, dtype, device)
            return t if local is None else local(node, t)
        return {k: build(node[k]) for k in sorted(node)}
    return build(schema)


def schema_specs(schema: Dict) -> Dict:
    """Logical-name tree (leaves are tuples of names)."""
    def walk(node):
        if isinstance(node, ParamDef):
            return node.names
        return {k: walk(v) for k, v in node.items()}
    return walk(schema)


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


def apply_m_rope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                 sections: Tuple[int, int, int]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): the head_dim/2 frequency slots are split
    into (temporal, height, width) sections, each rotated by its own
    position stream. x: (B, S, n, d); positions3: (3, B, S). Identical
    streams (text tokens) give ``apply_rope``."""
    if theta <= 0:
        return x
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"head_dim / 2 = {half}")
    freqs = rope_frequencies(x.shape[-1], theta, x.device)     # (half,)
    ang_all = positions3[..., None].float() * freqs            # (3,B,S,half)
    bounds = [0]
    for sec in sections:
        bounds.append(bounds[-1] + sec)
    ang = torch.cat([ang_all[i, ..., bounds[i]:bounds[i + 1]]
                     for i in range(len(sections))], dim=-1)   # (B,S,half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(max_len: int, dim: int,
                         device: Optional[torch.device] = None
                         ) -> torch.Tensor:
    """Whisper-style absolute sinusoidal embeddings (max_len, dim), fp32."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device),
                            2 * i / dim)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def lm_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                     mask: Optional[torch.Tensor], vocab: int
                     ) -> torch.Tensor:
    """The reference's causal-LM loss of ``logits`` (B, S, padded vocab):
    fp32, the padded vocab columns at -1e30, ``log_softmax`` NLL of
    ``targets``, summed over ``mask`` and divided by max(sum(mask), 1), or
    the mean over every token without a mask."""
    nll = _nll(logits, targets, vocab)
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def lm_nll_sum(logits: torch.Tensor, targets: torch.Tensor,
               mask: Optional[torch.Tensor], vocab: int) -> torch.Tensor:
    """``lm_cross_entropy``'s numerator: the NLL summed over ``mask`` (over
    every token without one), fp32."""
    nll = _nll(logits, targets, vocab)
    if mask is None:
        return nll.sum()
    return (nll * mask.to(nll.dtype)).sum()


def _nll(logits: torch.Tensor, targets: torch.Tensor, vocab: int
         ) -> torch.Tensor:
    """Per-token NLL of ``targets`` under fp32 ``log_softmax``, the padded
    vocab columns at -1e30."""
    logits = logits.float()
    if logits.shape[-1] != vocab:
        keep = torch.arange(logits.shape[-1], device=logits.device) < vocab
        logits = torch.where(keep, logits,
                             torch.full((), -1e30, device=logits.device))
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def matmul_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated and returned in fp32 without rounding to the
    inputs' dtype: cuBLAS's fp32 output (``out_dtype``) on the card, an
    fp32 product of the upcast inputs on the CPU; fp32 inputs multiply as
    they are. ``w`` 2-D (``x`` (..., K)), or batched: ``x`` (E, M, K) and
    ``w`` (E, K, N). Under autograd (``_MatmulFp32``) the backward's two
    products take the fp32 gradient rounded to the inputs' dtype and
    accumulate in fp32 the same way, rounding each result once to its
    input's dtype: tensor-core products on the card, where an upcast
    product would run in fp32."""
    if x.dtype == torch.float32:
        return x @ w
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _MatmulFp32.apply(x, w)
    return _mm_fp32(x, w)


def _mm_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``matmul_fp32``'s product of two low-precision operands."""
    if w.ndim == 3:
        if x.is_cuda:
            return torch.bmm(x, w, out_dtype=torch.float32)
        return torch.bmm(x.float(), w.float())
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        out = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        out = x2.float() @ w.float()
    return out.reshape(tuple(x.shape[:-1]) + (w.shape[-1],))


class _MatmulFp32(torch.autograd.Function):
    """``_mm_fp32`` with its derivative (the ``out_dtype`` product has
    none): ``dx = g @ w^T`` and ``dw = x^T @ g`` with ``g`` rounded to the
    operands' dtype, each through ``_mm_fp32``."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_fp32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_fp32(g, w.transpose(-1, -2)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            if w.ndim == 3:
                dw = _mm_fp32(x.transpose(1, 2), g)
            else:
                dw = _mm_fp32(x.reshape(-1, x.shape[-1]).t(),
                              g.reshape(-1, g.shape[-1]))
            dw = dw.to(w.dtype)
        return dx, dw


def remat(enabled: bool, fn: Callable, *args):
    """``fn(*args)``; with ``enabled`` and autograd recording, its
    activations are recomputed in the backward pass instead of kept
    (per-layer activation checkpointing, the reference's ``_remat``). The
    layers draw no random numbers, so no RNG state is carried."""
    if enabled and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def unbind_layers(stack: Dict) -> List[Dict]:
    """Every layer's slice of stacked layer params (leading axis L), from
    one ``unbind`` per leaf. Under autograd the L slices' gradients come
    back as one ``stack``; indexing ``stack[i]`` layer by layer would
    scatter each layer's gradient into a zero tensor the size of the
    whole stack and add L of those (L x the stack's bytes, twice)."""
    def split(node):
        if isinstance(node, dict):
            return {k: split(v) for k, v in node.items()}
        return node.unbind(0)

    def pick(node, i):
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        return node[i]
    parts = split(stack)
    first = parts
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [pick(parts, i) for i in range(len(first))]
