"""Kernel dispatch (port of ``repro/kernels/ops.py``): attention, the KV
sanitizer probe and the SSD scan.

The device decides, not a switch: a CUDA tensor always goes through the
hand-written kernel (which raises on what it does not take), a CPU tensor
through the kernel's plain PyTorch version. There is no fallback from a
failed build or launch to the plain version.

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
                  "ssd_scan": _ssd,
                  "kv_probe": _kvp}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    fn = _fa.flash_attention if q.is_cuda else _fa.flash_attention_plain
    return fn(q, k, v, causal=causal, window=window)


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
                     window: Optional[int] = None) -> torch.Tensor:
    fn = _da.decode_attention if q.is_cuda else _da.decode_attention_plain
    return fn(q, cache_k, cache_v, pos, window=window)


def chunk_attention(q: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, bases: Union[int, torch.Tensor], *,
                    window: Optional[int] = None, probe: bool = False):
    fn = _ca.chunk_attention if q.is_cuda else _ca.chunk_attention_plain
    return fn(q, cache_k, cache_v, bases, window=window, probe=probe)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int = 128,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    fn = _ssd.ssd_scan if x.is_cuda else _ssd.ssd_scan_plain
    return fn(x, dt, a, b, c, chunk=chunk, h0=h0)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {n: m.launch_counts[n] for n, m in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for n, m in KERNEL_MODULES.items():
        m.launch_counts[n] = 0
