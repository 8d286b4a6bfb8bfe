"""Kernel dispatch (port of ``repro/kernels/ops.py``): attention, the KV
sanitizer probe and the SSD scan.

The device decides, not a switch: a CUDA tensor always goes through the
hand-written kernel (which raises on what it does not take), a CPU tensor
through the kernel's plain PyTorch version. There is no fallback from a
failed build or launch to the plain version.

Gradients: on the card, flash attention trains through
``FlashAttentionFn`` and the SSD scan through ``SsdScanFn`` (each a
hand-written backward kernel); the serving kernels (decode, chunk, the
probe) raise when autograd records a gradient of their inputs
(``_build.refuse_grad``) instead of returning an output without a
``grad_fn``. On the CPU the plain versions are differentiable as they
are.

With ``probe=True`` the three attention calls whose Pallas kernels have a
probe output return ``(out, pmax)``, the (B, nh) maximum readable |K| /
|V| (``kernels/kv_probe.py``). Where the reference's wrappers checkify it
against ``KV_POISON`` inside the jit, here the caller holds it on the
device and checks it once per dispatch (the engine's ``_check_probe``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import chunk_attention as _ca
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import kv_probe as _kvp
from repro_torch.kernels import ssd_scan as _ssd

# every kernel by name -> the module holding its wrapper and launch count
KERNEL_MODULES = {"decode_attention_paged": _da,
                  "decode_attention": _da,
                  "chunk_attention_paged": _ca,
                  "chunk_attention": _ca,
                  "flash_attention": _fa,
                  "flash_attention_bwd": _fa,
                  "ssd_scan": _ssd,
                  "ssd_scan_bwd": _ssd,
                  "kv_probe": _kvp}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    """On the card: ``FlashAttentionFn`` (forward and backward kernels)
    while autograd records a gradient of q, k or v, else the forward kernel
    alone, as serving calls it."""
    if not q.is_cuda:
        return _fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _fa.FlashAttentionFn.apply(q, k, v, causal, window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention_paged(q: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, block_tbl: torch.Tensor,
                           pos: Union[int, torch.Tensor], *,
                           window: Optional[int] = None, probe: bool = False):
    fn = (_da.decode_attention_paged if q.is_cuda
          else _da.decode_attention_paged_plain)
    return fn(q, cache_k, cache_v, block_tbl, pos, window=window,
              probe=probe)


def chunk_attention_paged(q: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, block_tbl: torch.Tensor,
                          bases: Union[int, torch.Tensor], *,
                          window: Optional[int] = None, probe: bool = False,
                          probe_cols: Optional[torch.Tensor] = None):
    fn = (_ca.chunk_attention_paged if q.is_cuda
          else _ca.chunk_attention_paged_plain)
    return fn(q, cache_k, cache_v, block_tbl, bases, window=window,
              probe=probe, probe_cols=probe_cols)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: Union[int, torch.Tensor], *,
                     window: Optional[int] = None,
                     lse: Optional[torch.Tensor] = None):
    """With ``lse`` (B, nh) fp32: (the fp32 output, ``lse`` filled), the
    partial of a slice of a cache cut by sequence, read at the local
    position (``kernels/decode_attention.py``)."""
    fn = _da.decode_attention if q.is_cuda else _da.decode_attention_plain
    return fn(q, cache_k, cache_v, pos, window=window, lse=lse)


def decode_attention_ring(q: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor,
                          pos: Union[int, torch.Tensor]) -> torch.Tensor:
    """Decode against a ring (sliding-window) cache of ``S_alloc`` slots.
    Once full it holds exactly the last ``S_alloc`` positions, and before
    that slot j holds position j, so the slots the reference's ``slot_pos``
    mask keeps are slots [0, min(pos, S_alloc - 1)]: the contiguous decode
    kernel's function at that position with no window (softmax does not
    care about key order). The reference sends ring decode to its jnp
    path; here it runs the kernel."""
    pos = torch.as_tensor(pos, device=q.device)
    return decode_attention(q, cache_k, cache_v,
                            torch.clamp(pos, max=cache_k.shape[1] - 1))


def chunk_attention(q: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, bases: Union[int, torch.Tensor], *,
                    window: Optional[int] = None, probe: bool = False):
    fn = _ca.chunk_attention if q.is_cuda else _ca.chunk_attention_plain
    return fn(q, cache_k, cache_v, bases, window=window, probe=probe)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int = 128,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """On the card: ``SsdScanFn`` (forward and backward kernels) while
    autograd records a gradient of an input, else the forward kernel
    alone, as serving calls it."""
    if not x.is_cuda:
        return _ssd.ssd_scan_plain(x, dt, a, b, c, chunk=chunk, h0=h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, a, b, c, h0)):
        return _ssd.SsdScanFn.apply(x, dt, a, b, c, chunk, h0)
    return _ssd.ssd_scan(x, dt, a, b, c, chunk=chunk, h0=h0)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {n: m.launch_counts[n] for n, m in KERNEL_MODULES.items()}


def decode_launches_by_cache_dtype() -> Dict[str, int]:
    """``decode_attention``'s launches by the cache's dtype since the last
    reset (an fp8 serve step's reads of its fp8 cache)."""
    return dict(_da.launches_by_cache_dtype)


def decode_lse_launches() -> int:
    """Of ``decode_attention``'s launches since the last reset, those that
    also wrote the log-sum-exp output (``lse=``)."""
    return _da.lse_launches[0]


def reset_launch_counts() -> None:
    for n, m in KERNEL_MODULES.items():
        m.launch_counts[n] = 0
    _da.launches_by_cache_dtype.clear()
    _da.lse_launches[0] = 0
