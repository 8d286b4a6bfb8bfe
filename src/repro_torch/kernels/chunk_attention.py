"""Paged chunk-prefill attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/chunk_attention.py``
``chunk_attention_paged`` (``_chunk_paged_kernel`` -> ``_chunk_kernel``);
the kernel source is ``csrc/chunk_attention.cu``. Unlike the JAX ops
wrapper there is no "shape does not tile, use the oracle" fallback: the
kernel masks its own ragged edge, so any chunk length goes through it.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from repro_torch.kernels import _build
from repro_torch.models import attention as _attn

SOURCE = "src/repro_torch/kernels/csrc/chunk_attention.cu"
REPLACES = "src/repro/kernels/chunk_attention.py:198"

launch_count = 0          # kernel launches (plain-version calls excluded)


def chunk_attention_paged_plain(q: torch.Tensor, cache_k: torch.Tensor,
                                cache_v: torch.Tensor,
                                block_tbl: torch.Tensor,
                                bases: Union[int, torch.Tensor],
                                window: Optional[int] = None
                                ) -> torch.Tensor:
    """Plain version: the ``models/attention.py`` oracle at the absolute
    query positions ``bases[b] + [0, C)``."""
    b, c = q.shape[0], q.shape[1]
    bases = torch.as_tensor(bases, device=q.device).long()
    bases = bases.expand(b) if bases.ndim == 0 else bases
    q_pos = bases[:, None] + torch.arange(c, device=q.device)[None, :]
    return _attn.chunk_attention_paged(q, cache_k, cache_v, block_tbl, q_pos,
                                       window=window)


def chunk_attention_paged(q: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, block_tbl: torch.Tensor,
                          bases: Union[int, torch.Tensor],
                          window: Optional[int] = None) -> torch.Tensor:
    """Kernel launch. q: (B,C,nh,d) with the chunk's K/V already written
    to the pool (n_blocks, block, nkv, d); block_tbl: (B, max_blocks)
    int32; bases scalar or (B,). CUDA tensors only."""
    global launch_count
    name = "chunk_attention_paged"
    _build.require_cuda(name, q, cache_k, cache_v, block_tbl)
    _build.expect(q.ndim == 4, f"{name}: q must be (B,C,nh,d)")
    b, c, nh, d = q.shape
    _, bs, nkv, dk = cache_k.shape
    _build.expect(q.dtype in _build.DTYPES and cache_k.dtype == q.dtype
                  and cache_v.dtype == q.dtype,
                  f"{name}: q and pool must share fp32 or bf16")
    _build.expect(cache_v.shape == cache_k.shape and dk == d
                  and d in _build.HEAD_DIMS and nh % nkv == 0,
                  f"{name}: unsupported shapes q={tuple(q.shape)} "
                  f"pool={tuple(cache_k.shape)}")
    _build.expect(block_tbl.dtype == torch.int32 and block_tbl.ndim == 2
                  and block_tbl.shape[0] == b, f"{name}: block_tbl must "
                  f"be ({b}, max_blocks) int32")
    bases = _build.row_vector(bases, b, q.device)
    out = torch.empty_like(q)
    if b == 0 or c == 0:
        return out
    lib = _build.load()
    rc = lib.rt_chunk_attention_paged(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        block_tbl.data_ptr(), bases.data_ptr(), out.data_ptr(), b, c, nh,
        nkv, d, bs, block_tbl.shape[1], window or 0, 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    _build.check(rc, name)
    launch_count += 1
    return out
