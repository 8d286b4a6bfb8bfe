"""Mamba2 (SSD, state-space duality) block (port of ``repro/models/ssm.py``).

Prefill runs the chunked SSD scan through ``kernels.ops.ssd_scan``: the
hand-written CUDA kernel for tensors on the card, its plain PyTorch version
(the reference's ``ssd_chunked``) for CPU tensors; the device decides,
where the reference has a ``use_kernel`` switch. Decode is the O(1)
recurrent step. The causal depthwise conv and the one-token ``ssd_step``
are not Pallas kernels in the reference and stay plain PyTorch ops.

Layout (n_groups=1, as mamba2-1.3b / zamba2):
  in_proj : H -> [z (d_inner), x (d_inner), B (N), C (N), dt (nheads)]
  conv1d  : causal depthwise width-4 over [x, B, C]
  SSD     : h_t = h_{t-1} * exp(dt_t A) + dt_t * B_t (x) x_t ; y_t = C_t . h_t
  gate    : y = RMSNorm(y) * silu(z) ; out_proj : d_inner -> H

Under tensor parallelism a rank holds its SSD heads' slice of the mixer
(``sharding.rules.MixerSplit``: its z, x and dt columns of ``w_in``, B and
C whole) and runs the block at its local widths, read off the params. Two
callables carry the cross-rank sums: ``reduce`` sums the gated RMSNorm's
fp32 sums of squares over the ranks, so the norm still divides by the
whole ``d_inner``, and ``row_parallel`` is the summed ``w_out`` product.
Both None (one rank, or a mixer kept whole) is the unsplit block.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.common import ParamDef


class SSMState(NamedTuple):
    conv: torch.Tensor    # (B, conv_width-1, d_inner + 2N), pre-activation
    ssd: torch.Tensor     # (B, nheads, head_dim, N) float32


def mamba2_schema(d_model: int, d_inner: int, n_state: int, n_heads: int,
                  conv_width: int) -> Dict:
    conv_ch = d_inner + 2 * n_state
    proj_out = 2 * d_inner + 2 * n_state + n_heads
    return {
        "w_in": ParamDef((d_model, proj_out), ("embed", "ssm_inner")),
        "conv_w": ParamDef((conv_width, conv_ch), (None, "ssm_inner"),
                           "normal", 0.1),
        "conv_b": ParamDef((conv_ch,), ("ssm_inner",), "zeros"),
        "dt_bias": ParamDef((n_heads,), ("ssm_heads",), "mamba_dt"),
        "a_log": ParamDef((n_heads,), ("ssm_heads",), "mamba_alog"),
        "d_skip": ParamDef((n_heads,), ("ssm_heads",), "ones"),
        "gate_norm": ParamDef((d_inner,), ("ssm_inner",), "ones"),
        "w_out": ParamDef((d_inner, d_model), ("ssm_inner", "embed")),
    }


def _split_proj(proj: torch.Tensor, d_inner: int, n_state: int,
                n_heads: int):
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:2 * d_inner + 2 * n_state]
    dt = proj[..., 2 * d_inner + 2 * n_state:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv. xbc: (B,S,C), w: (K,C). init_state (B,K-1,C)
    supplies left context (zeros for a fresh prompt)."""
    k = w.shape[0]
    if init_state is None:
        init_state = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[-1]))
    xp = torch.cat([init_state, xbc], dim=1)
    s = xbc.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return F.silu(out + b)


def ssd_step(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, h: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step. x: (B,nh,hd), dt: (B,nh), b/c: (B,N),
    h: (B,nh,hd,N) fp32."""
    da = torch.exp(dt * a)                                    # (B,nh)
    upd = torch.einsum("bhd,bn->bhdn", x.float() * dt[..., None], b.float())
    h_new = h * da[..., None, None] + upd
    y = torch.einsum("bhdn,bn->bhd", h_new, c.float())
    return y.to(x.dtype), h_new


def _dt_a(p: Dict, dt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """softplus(dt + dt_bias) and A = -exp(a_log), both fp32."""
    return (F.softplus(dt.float() + p["dt_bias"].float()),
            -torch.exp(p["a_log"].float()))


Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]
RowParallel = Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]]


def _local(p: Dict, head_dim: int) -> Tuple[int, int]:
    """(d_inner, heads) of the mixer slice ``p`` holds."""
    nh = p["a_log"].shape[-1]
    return nh * head_dim, nh


def _gate_out(p: Dict, y: torch.Tensor, z: torch.Tensor, d_inner: int,
              reduce: Reduce, row_parallel: RowParallel) -> torch.Tensor:
    """``RMSNorm(y) * silu(z) @ w_out``, the norm's fp32 sum of squares
    divided by the whole ``d_inner`` (the reference's mean over the last
    axis). Split over ranks, ``y`` holds the rank's heads: ``reduce`` sums
    the sums of squares over the ranks, and ``row_parallel`` sums the
    ``w_out`` partial products."""
    yf = y.float()
    ss = (yf * yf).sum(dim=-1, keepdim=True)
    if reduce is not None:
        ss = reduce(ss)
    yf = yf * torch.rsqrt(ss / d_inner + 1e-5)
    y = (yf * p["gate_norm"].float()).to(y.dtype) * F.silu(z)
    if row_parallel is None:
        return y @ p["w_out"]
    return row_parallel(y, p["w_out"])


def mamba2_prefill(p: Dict, x: torch.Tensor, d_inner: int, n_state: int,
                   n_heads: int, head_dim: int, chunk: int = 128,
                   reduce: Reduce = None, row_parallel: RowParallel = None
                   ) -> Tuple[torch.Tensor, SSMState]:
    """Full-prompt Mamba2 block. x: (B,S,H) -> (y (B,S,H), final state).
    ``d_inner`` and ``n_heads`` are the whole mixer's; ``p`` may hold a
    rank's heads (module docstring)."""
    bsz, s, _ = x.shape
    k = p["conv_w"].shape[0]
    d_full = d_inner
    d_inner, n_heads = _local(p, head_dim)
    proj = x @ p["w_in"]
    z, xbc, dt = _split_proj(proj, d_inner, n_state, n_heads)
    # pre-activation; a copy, since a view would keep the layer's whole
    # projection alive until the trunk stacks every layer's state
    conv_tail = xbc[:, -(k - 1):, :].clone()
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    # views of the conv output: the kernel reads them in place
    xs = xbc[..., :d_inner].reshape(bsz, s, n_heads, head_dim)
    bmat = xbc[..., d_inner:d_inner + n_state]
    cmat = xbc[..., d_inner + n_state:]
    dt, a = _dt_a(p, dt)
    y, h = kops.ssd_scan(xs, dt, a, bmat, cmat, chunk=chunk)
    y = y + xs * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, d_inner)
    out = _gate_out(p, y, z, d_full, reduce, row_parallel)
    # conv state for subsequent decode: last K-1 *pre-conv* channel values
    pad = k - 1 - conv_tail.shape[1]
    if pad > 0:
        conv_tail = F.pad(conv_tail, (0, 0, pad, 0))
    return out, SSMState(conv_tail, h)


def mamba2_step(p: Dict, x: torch.Tensor, state: SSMState, d_inner: int,
                n_state: int, n_heads: int, head_dim: int,
                reduce: Reduce = None, row_parallel: RowParallel = None
                ) -> Tuple[torch.Tensor, SSMState]:
    """One-token Mamba2 step. x: (B,1,H); widths as ``mamba2_prefill``
    takes them, ``state`` at the local widths."""
    bsz = x.shape[0]
    d_full = d_inner
    d_inner, n_heads = _local(p, head_dim)
    proj = x @ p["w_in"]                                      # (B,1,P)
    z, xbc, dt = _split_proj(proj, d_inner, n_state, n_heads)
    # conv over [state ; current]
    window = torch.cat([state.conv, xbc], dim=1)              # (B,K,C)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out)[:, None, :]                   # (B,1,C)
    new_conv = window[:, 1:, :]
    xs = conv_out[..., :d_inner].reshape(bsz, n_heads, head_dim)
    bmat = conv_out[:, 0, d_inner:d_inner + n_state]
    cmat = conv_out[:, 0, d_inner + n_state:]
    dt1, a = _dt_a(p, dt[:, 0])
    y, h_new = ssd_step(xs, dt1, a, bmat, cmat, state.ssd)
    y = y + xs * p["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, d_inner)
    out = _gate_out(p, y, z, d_full, reduce, row_parallel)
    return out, SSMState(new_conv, h_new)
