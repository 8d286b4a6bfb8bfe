"""Full-sequence (prefill) flash attention: the CUDA kernels' wrappers, the
autograd function that trains through them, and their plain PyTorch
versions.

The forward replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
``flash_attention`` (``_fa_kernel``); its source is
``csrc/flash_attention.cu``. The JAX wrapper's ``sq % block_q == 0``
requirement does not carry over: the kernel masks ragged ``Sq``/``Sk``.

The backward (``csrc/flash_attention_bwd.cu``) has no Pallas counterpart:
the JAX package trains with ``use_pallas=False`` and lets XLA
differentiate its jnp attention. ``FlashAttentionFn`` runs the forward
with the per-row log-sum-exp and the backward kernel on its output
gradient, so a model on the card trains through hand-written kernels both
ways.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.models import attention as _attn

SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
REPLACES = {"flash_attention": "src/repro/kernels/flash_attention.py:77",
            # no Pallas kernel: XLA's gradient of the jnp attention
            "flash_attention_bwd": "src/repro/models/attention.py:61 (XLA's "
                                   "gradient of prefill_attention; no Pallas "
                                   "kernel)"}

# kernel launches (plain-version calls excluded); the backward counts one
# per backward pass, whatever the number of launches inside it
launch_counts = {"flash_attention": 0, "flash_attention_bwd": 0}


def _mask(sq: int, sk: int, causal: bool, window: Optional[int], device
          ) -> Optional[torch.Tensor]:
    """The kernels' mask: query i sees key j when ``j <= i`` under
    ``causal`` and ``j > i - window`` whenever a window is given."""
    if causal:
        return _attn.causal_mask(sq, sk, 0, window, device)
    if window is not None:
        qpos = torch.arange(sq, device=device)[:, None]
        kpos = torch.arange(sk, device=device)[None, :]
        return (kpos > qpos - window)[None, None, None]
    return None


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """Plain version: the ``models/attention.py`` SDPA under the kernel's
    own mask. As ``_fa_kernel`` (and the CUDA kernel), query i sees key j
    when ``j <= i`` under ``causal`` and ``j > i - window`` whenever a window
    is given; the model oracle ``prefill_attention`` drops the window
    without ``causal``, the kernels do not."""
    return _attn.sdpa(q, k, v, _mask(q.shape[1], k.shape[1], causal, window,
                                     q.device))


def flash_lse_plain(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Plain version of the forward's second output: each query row's
    log-sum-exp of its scaled scores, (B, nh, Sq) fp32, in the base-2 units
    the kernels store (natural log-sum-exp times log2(e))."""
    q32, k32 = q.float(), k.float()
    g = q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q32,
                     k32.repeat_interleave(g, dim=2)) / math.sqrt(q.shape[3])
    m = _mask(q.shape[1], k.shape[1], causal, window, q.device)
    if m is not None:
        s = torch.where(m[:, :, 0], s, torch.full_like(s, _attn.NEG_INF))
    return torch.logsumexp(s, dim=-1) * math.log2(math.e)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True,
                              window: Optional[int] = None
                              ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward: (dq, dk, dv) of
    ``flash_attention_plain`` at ``dout``, through ``torch.autograd.grad``,
    computed in fp32 and returned in fp32 (tests and ``chip_smoke.py``
    only)."""
    with torch.enable_grad():
        q32, k32, v32 = (t.detach().float().requires_grad_(True)
                         for t in (q, k, v))
        out = flash_attention_plain(q32, k32, v32, causal=causal,
                                    window=window)
        return torch.autograd.grad(out, (q32, k32, v32), dout.float())


@functools.lru_cache(maxsize=1024)
def _bwd_plan(b: int, sq: int, sk: int, nh: int, nkv: int, d: int,
              causal: bool, window: int, bf16: bool,
              device: int) -> Tuple[int, int]:
    """(scratch floats, split count) of a backward launch from
    ``rt_flash_attention_bwd_plan``, the C side that also picks the body
    and the split from the device's SM count (``device`` keys the cache)."""
    out = (ctypes.c_longlong * 2)()
    rc = _build.load().rt_flash_attention_bwd_plan(
        b, sq, sk, nh, nkv, d, int(causal), window, int(bf16), out)
    _build.check(rc, "rt_flash_attention_bwd_plan")
    return out[0], out[1]


def bwd_plan(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
             window: Optional[int] = None) -> Tuple[int, int]:
    """(scratch floats, split count) the backward kernel takes for these
    q (B, Sq, nh, d), k (B, Sk, nkv, d) and mask on their card. With a
    split of s > 1 the bf16 body runs s CTAs per (key tile, KV head, row),
    each on a contiguous range of the key tile's (query head, query tile)
    steps."""
    b, sq, nh, d = q.shape
    _, sk, nkv, _ = k.shape
    return _bwd_plan(b, sq, sk, nh, nkv, d, causal, window or 0,
                     q.dtype == torch.bfloat16, q.device.index or 0)


def _check(name: str, q, k, v) -> None:
    _build.require_cuda(name, q, k, v)
    _build.expect_attention(name, q, k, v)
    _build.expect(k.shape[0] == q.shape[0], f"{name}: k/v batch "
                  f"{k.shape[0]} != q batch {q.shape[0]}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel launch. q: (B,Sq,nh,d), k/v: (B,Sk,nkv,d) -> (B,Sq,nh,d).
    CUDA tensors only. With ``lse`` (a (B, nh, Sq) fp32 tensor) the kernel
    also stores each row's base-2 log-sum-exp there. Gradients go through
    ``FlashAttentionFn`` (``ops.flash_attention`` picks it); called here
    directly with an input that requires grad, it raises."""
    name = "flash_attention"
    _build.refuse_grad(name, q, k, v, missing="use FlashAttentionFn")
    _check(name, q, k, v)
    b, sq, nh, d = q.shape
    _, sk, nkv, _ = k.shape
    if lse is not None:
        _build.require_cuda(name, lse)
        _build.expect(lse.dtype == torch.float32
                      and tuple(lse.shape) == (b, nh, sq),
                      f"{name}: lse must be fp32 ({b}, {nh}, {sq})")
    out = torch.empty_like(q)
    if b == 0 or sq == 0:
        return out
    lib = _build.load()
    rc = lib.rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, sq, sk, nh, nkv, d,
        int(causal), window or 0, 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    _build.check(rc, name)
    launch_counts[name] += 1
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel launch of the backward: (dq, dk, dv) in the inputs' dtype from
    the forward's inputs, output, output gradient and base-2 log-sum-exp.
    CUDA tensors only, all contiguous, 16-byte aligned."""
    name = "flash_attention_bwd"
    _check(name, q, k, v)
    _build.require_cuda(name, q, out, dout, lse)
    b, sq, nh, d = q.shape
    _, sk, nkv, _ = k.shape
    _build.expect(out.shape == q.shape and dout.shape == q.shape
                  and out.dtype == q.dtype and dout.dtype == q.dtype,
                  f"{name}: out / dout must match q {tuple(q.shape)}")
    _build.expect(lse.dtype == torch.float32
                  and tuple(lse.shape) == (b, nh, sq),
                  f"{name}: lse must be fp32 ({b}, {nh}, {sq})")
    _build.expect(all(t.data_ptr() % 16 == 0 for t in (q, k, v, out, dout)),
                  f"{name}: q, k, v, out and dout must be 16-byte aligned")
    if min(b, sq, sk) == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    work = torch.empty(bwd_plan(q, k, causal=causal, window=window)[0],
                       dtype=torch.float32, device=q.device)
    lib = _build.load()
    rc = lib.rt_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), work.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, sq, sk, nh, nkv, d, int(causal),
        window or 0, 1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
        _build.stream_ptr(q.device))
    _build.check(rc, name)
    launch_counts[name] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient, on the card: the forward kernel
    with the log-sum-exp, the backward kernel on a contiguous output
    gradient. ``apply(q, k, v, causal, window)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        b, sq, nh, _ = q.shape
        lse = torch.empty((b, nh, sq), dtype=torch.float32, device=q.device)
        out = flash_attention(q, k, v, causal=causal, window=window, lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, dout.contiguous(), lse, causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None
