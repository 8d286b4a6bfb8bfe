"""Chunk-prefill attention, paged and contiguous: the CUDA kernels'
wrappers and their plain PyTorch versions.

Replaces the Pallas TPU kernels of ``repro/kernels/chunk_attention.py``:
``chunk_attention_paged`` (``_chunk_paged_kernel`` -> ``_chunk_kernel``)
against a block pool, and ``chunk_attention`` (``_chunk_kernel``) against a
contiguous ``(B, S, nkv, d)`` cache. Both kernels live in
``csrc/chunk_attention.cu``. Unlike the JAX ops wrapper there is no "shape
does not tile, use the oracle" fallback: the kernels mask their own ragged
edges, so any chunk length and any cache length go through them. With
``probe=True`` the wrappers also return the KV sanitizer's (B, nh) probe
(``kernels/kv_probe.py``), as the Pallas kernels do: over every column of
the chunk, pad columns included, or, paged, over each row's first
``probe_cols[b]`` columns.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import kv_probe as _kvp
from repro_torch.models import attention as _attn

SOURCE = "src/repro_torch/kernels/csrc/chunk_attention.cu"
REPLACES = {
    "chunk_attention_paged": "src/repro/kernels/chunk_attention.py:198",
    "chunk_attention": "src/repro/kernels/chunk_attention.py:148"}

# kernel launches per kernel (plain-version calls excluded)
launch_counts = {name: 0 for name in REPLACES}


def _q_positions(q: torch.Tensor, bases: Union[int, torch.Tensor]
                 ) -> torch.Tensor:
    """Absolute query positions ``bases[b] + [0, C)`` as (B, C) int64."""
    b, c = q.shape[0], q.shape[1]
    bases = torch.as_tensor(bases, device=q.device).long()
    bases = bases.expand(b) if bases.ndim == 0 else bases
    return bases[:, None] + torch.arange(c, device=q.device)[None, :]


def chunk_attention_paged_plain(q: torch.Tensor, cache_k: torch.Tensor,
                                cache_v: torch.Tensor,
                                block_tbl: torch.Tensor,
                                bases: Union[int, torch.Tensor],
                                window: Optional[int] = None,
                                probe: bool = False,
                                probe_cols: Optional[torch.Tensor] = None):
    """Plain version: the ``models/attention.py`` oracle at the absolute
    query positions ``bases[b] + [0, C)``; with ``probe``, (out, the
    probe's plain version)."""
    out = _attn.chunk_attention_paged(q, cache_k, cache_v, block_tbl,
                                      _q_positions(q, bases), window=window)
    if not probe:
        return out
    return out, _kvp.kv_probe_plain(cache_k, cache_v, block_tbl, bases,
                                    q.shape[1], q.shape[2], window=window,
                                    cols=probe_cols)


def chunk_attention_paged(q: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, block_tbl: torch.Tensor,
                          bases: Union[int, torch.Tensor],
                          window: Optional[int] = None, probe: bool = False,
                          probe_cols: Optional[torch.Tensor] = None):
    """Kernel launch. q: (B,C,nh,d) with the chunk's K/V already written
    to the pool (n_blocks, block, nkv, d); block_tbl: (B, max_blocks)
    int32; bases scalar or (B,). CUDA tensors only. With ``probe``,
    returns (out, the (B, nh) probe over every column, or over each row's
    first ``probe_cols[b]`` ((B,) int32)), the probe a second launch."""
    name = "chunk_attention_paged"
    _build.require_cuda(name, q, cache_k, cache_v, block_tbl)
    _build.expect_attention(name, q, cache_k, cache_v)
    b, c, nh, d = q.shape
    _, bs, nkv, _ = cache_k.shape
    _build.expect(block_tbl.dtype == torch.int32 and block_tbl.ndim == 2
                  and block_tbl.shape[0] == b, f"{name}: block_tbl must "
                  f"be ({b}, max_blocks) int32")
    bases = _build.row_vector(bases, b, q.device)
    out = torch.empty_like(q)
    if b > 0 and c > 0:
        rc = _build.load().rt_chunk_attention_paged(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            block_tbl.data_ptr(), bases.data_ptr(), out.data_ptr(), b, c, nh,
            nkv, d, bs, block_tbl.shape[1], window or 0, 1.0 / math.sqrt(d),
            int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
        _build.check(rc, name)
        launch_counts[name] += 1
    if not probe:
        return out
    return out, _kvp.kv_probe(cache_k, cache_v, block_tbl, bases, c, nh,
                              window=window, cols=probe_cols)


def chunk_attention_plain(q: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor,
                          bases: Union[int, torch.Tensor],
                          window: Optional[int] = None, probe: bool = False):
    """Plain version: the ``models/attention.py`` linear-cache oracle at
    the absolute query positions ``bases[b] + [0, C)``; with ``probe``,
    (out, the probe's plain version)."""
    out = _attn.chunk_attention(q, cache_k, cache_v, _q_positions(q, bases),
                                window=window)
    if not probe:
        return out
    return out, _kvp.kv_probe_plain(cache_k, cache_v, None, bases,
                                    q.shape[1], q.shape[2], window=window)


def chunk_attention(q: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, bases: Union[int, torch.Tensor],
                    window: Optional[int] = None, probe: bool = False):
    """Kernel launch. q: (B,C,nh,d) with the chunk's K/V already written
    to the contiguous cache (B, S, nkv, d), any C and S; bases scalar or
    (B,). CUDA tensors only. With ``probe``, returns (out, the (B, nh)
    probe), the probe a second launch."""
    name = "chunk_attention"
    _build.require_cuda(name, q, cache_k, cache_v)
    _build.expect_attention(name, q, cache_k, cache_v)
    b, c, nh, d = q.shape
    _, s, nkv, _ = cache_k.shape
    _build.expect(cache_k.shape[0] == b and b * s < 2 ** 31,
                  f"{name}: cache {tuple(cache_k.shape)} for q batch {b} "
                  f"(batch must match; B * S rows must fit an int32)")
    bases = _build.row_vector(bases, b, q.device)
    out = torch.empty_like(q)
    if b > 0 and c > 0:
        rc = _build.load().rt_chunk_attention(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            bases.data_ptr(), out.data_ptr(), b, c, nh, nkv, d, s,
            window or 0, 1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
            _build.stream_ptr(q.device))
        _build.check(rc, name)
        launch_counts[name] += 1
    if not probe:
        return out
    return out, _kvp.kv_probe(cache_k, cache_v, None, bases, c, nh,
                              window=window)
