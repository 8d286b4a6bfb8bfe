"""Attention, plain PyTorch (port of ``repro/models/attention.py``:
full-sequence, contiguous-cache and paged paths).

These functions are the CPU path of the port and the oracles the CUDA
kernels in ``repro_torch/kernels`` are held against. Three properties of
the JAX reference carry over exactly:

* finite masking: masked scores are ``NEG_INF = -1e30`` via ``torch.where``
  (never ``-inf``, never a boolean-mask SDPA), so a fully masked dead row
  stays finite and the finite ``KV_POISON`` sentinel contributes exactly
  ``0.0 * poison`` at masked positions;
* numerics: scores in fp32 (inputs upcast before the contraction, as
  ``preferred_element_type=jnp.float32`` does), softmax cast to
  ``v.dtype`` before the PV product;
* index clamping: JAX clamps (or drops) out-of-range gather indices where
  torch raises, so every table lookup clamps explicitly.

Cache writes update the pool tensors IN PLACE (the JAX versions return new
arrays that the engine's donated jit aliases); they return the same
tensors for symmetry with the reference signatures.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e30

IntLike = Union[int, torch.Tensor]


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,nh,d), k: (B,Sk,nkv,d) -> fp32 scores (B,nkv,g,Sq,Sk)."""
    b, sq, nh, d = q.shape
    nkv = k.shape[2]
    qg = q.float().reshape(b, sq, nkv, nh // nkv, d)
    return torch.einsum("bskgd,btkd->bkgst", qg, k.float())


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B,nkv,g,Sq,Sk), v: (B,Sk,nkv,d) -> (B,Sq,nh,d)."""
    b, nkv, g, sq, _ = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, sq, nkv * g, v.shape[-1])


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor] = None,
         scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query SDPA. mask broadcastable to (B,1,1,Sq,Sk), True=keep."""
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    scores = _gqa_scores(q, k) * scale
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return _gqa_out(probs, v)


def causal_mask(sq: int, sk: int, q_offset: int = 0,
                window: Optional[int] = None,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """(1,1,1,Sq,Sk) boolean mask; query i (absolute q_offset+i) sees keys
    j <= q_pos and, with SWA, j > q_pos - window."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m[None, None, None]


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None
                      ) -> torch.Tensor:
    """Self-attention over a full prompt (the flash kernel's oracle)."""
    mask = (causal_mask(q.shape[1], k.shape[1], 0, window, q.device)
            if causal else None)
    return sdpa(q, k, v, mask)


# ---------------------------------------------------------------------------
# Contiguous (linear) KV cache
#
# Each row owns ``cache_k/v: (B, S, nkv, d)`` (a per-layer slice of the
# stacked ``(L, B, max_len, nkv, d)`` engine cache); key position t lives at
# ``[b, t]``. Sliding windows apply by masking. The reference's ring caches
# (``slot_pos``) are not an engine path (the engine always allocates linear
# caches), so they are not ported.
# ---------------------------------------------------------------------------
def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: IntLike,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token attention. q: (B,1,nh,d); cache_k/v: (B,S,nkv,d); ``pos``
    scalar or (B,), the position of the current (already written) token."""
    pos = _row_vector(pos, q.shape[0], q.device)
    kpos = torch.arange(cache_k.shape[1], device=q.device)
    valid = kpos[None, :] <= pos[:, None]                     # (B, S)
    if window is not None:
        valid &= kpos[None, :] > (pos[:, None] - window)
    mask = valid[:, None, None, None, :]
    if cache_k.dtype != q.dtype:
        cache_k, cache_v = cache_k.to(q.dtype), cache_v.to(q.dtype)
    return sdpa(q, cache_k, cache_v, mask)


def chunk_attention(q: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, q_pos: torch.Tensor,
                    window: Optional[int] = None) -> torch.Tensor:
    """Chunk attention against a linear cache: q (B,C,nh,d) whose K/V are
    already written at their absolute positions ``q_pos`` (B,C); query i
    sees keys at positions <= q_pos[i] (and > q_pos[i] - window)."""
    kpos = torch.arange(cache_k.shape[1], device=q.device)
    valid = kpos[None, None, :] <= q_pos[:, :, None]          # (B, C, S)
    if window is not None:
        valid &= kpos[None, None, :] > (q_pos[:, :, None] - window)
    mask = valid[:, None, None, :, :]
    if cache_k.dtype != q.dtype:
        cache_k, cache_v = cache_k.to(q.dtype), cache_v.to(q.dtype)
    return sdpa(q, cache_k, cache_v, mask)


def cache_write_token(cache_k: torch.Tensor, cache_v: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor, pos: IntLike
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one token's K/V (B,1,nkv,d) at position ``pos`` (scalar or
    (B,), row by row) of a linear cache, in place. The slot clamps to
    ``S - 1`` as the reference's does, so a frozen dead row whose position
    sits at the cache end writes there instead of raising."""
    rows = torch.arange(k.shape[0], device=k.device)
    slot = torch.clamp(_row_vector(pos, k.shape[0], k.device),
                       max=cache_k.shape[1] - 1)
    cache_k[rows, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, slot] = v[:, 0].to(cache_v.dtype)
    return cache_k, cache_v


def cache_write_chunk(cache_k: torch.Tensor, cache_v: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor, base: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write a C-token chunk's K/V (B,C,nkv,d) at positions [base, base+C)
    of a linear cache, in place. ``base`` is one scalar for every row, as
    the reference's ``dynamic_update_slice`` takes it; a chunk running past
    the cache end raises (the reference would shift it back silently, and
    the engine never asks for it)."""
    c, s = k.shape[1], cache_k.shape[1]
    if not 0 <= base <= s - c:
        raise ValueError(f"chunk [{base}, {base + c}) outside a cache of "
                         f"{s} positions")
    cache_k[:, base:base + c] = k.to(cache_k.dtype)
    cache_v[:, base:base + c] = v.to(cache_v.dtype)
    return cache_k, cache_v


# ---------------------------------------------------------------------------
# Paged (block-table) KV cache
#
# The pool holds ``n_blocks`` fixed-size token blocks per layer:
# ``cache_k/v: (n_blocks, block, nkv, d)`` (a per-layer slice of the stacked
# ``(L, n_blocks, block, nkv, d)`` engine pool). ``block_tbl: (B, max_blocks)``
# maps virtual position t to pool block ``block_tbl[b, t // block]`` at
# offset ``t % block``; unallocated entries point at the reserved trash
# block 0, whose contents position masking keeps invisible.
# ---------------------------------------------------------------------------
def _gather_pages(cache_k: torch.Tensor, cache_v: torch.Tensor,
                  block_tbl: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize each row's virtual KV view: (B, max_blocks*block, nkv, d)."""
    b, mb = block_tbl.shape
    idx = block_tbl.long()
    shape = (b, mb * cache_k.shape[1]) + tuple(cache_k.shape[2:])
    return cache_k[idx].reshape(shape), cache_v[idx].reshape(shape)


def _row_vector(x: IntLike, b: int, device) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.long, device=device)
    return x.expand(b) if x.ndim == 0 else x.long()


def decode_attention_paged(q: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, block_tbl: torch.Tensor,
                           pos: IntLike, window: Optional[int] = None
                           ) -> torch.Tensor:
    """Block-table decode. q: (B,1,nh,d); cache_k/v: (n_blocks, block, nkv,
    d); pos scalar or (B,), position of the current (already written)
    token."""
    pos = _row_vector(pos, q.shape[0], q.device)
    pk, pv = _gather_pages(cache_k, cache_v, block_tbl)
    kpos = torch.arange(pk.shape[1], device=q.device)
    valid = kpos[None, :] <= pos[:, None]
    if window is not None:
        valid &= kpos[None, :] > (pos[:, None] - window)
    mask = valid[:, None, None, None, :]
    if pk.dtype != q.dtype:
        pk, pv = pk.to(q.dtype), pv.to(q.dtype)
    return sdpa(q, pk, pv, mask)


def chunk_attention_paged(q: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, block_tbl: torch.Tensor,
                          q_pos: torch.Tensor, window: Optional[int] = None
                          ) -> torch.Tensor:
    """Block-table chunk attention: (B,C) queries at absolute positions
    ``q_pos`` against each row's gathered pages."""
    pk, pv = _gather_pages(cache_k, cache_v, block_tbl)
    kpos = torch.arange(pk.shape[1], device=q.device)
    valid = kpos[None, None, :] <= q_pos[:, :, None]          # (B, C, S)
    if window is not None:
        valid &= kpos[None, None, :] > (q_pos[:, :, None] - window)
    mask = valid[:, None, None, :, :]
    if pk.dtype != q.dtype:
        pk, pv = pk.to(q.dtype), pv.to(q.dtype)
    return sdpa(q, pk, pv, mask)


def cache_write_token_paged(cache_k: torch.Tensor, cache_v: torch.Tensor,
                            k: torch.Tensor, v: torch.Tensor, pos: IntLike,
                            block_tbl: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one token's K/V (B,1,nkv,d) at per-row virtual position ``pos``
    through the block table, in place. Rows whose table entry is the trash
    block write garbage there (never read)."""
    blk = cache_k.shape[1]
    pos = _row_vector(pos, k.shape[0], k.device)
    col = torch.clamp(pos // blk, max=block_tbl.shape[1] - 1)
    dest = torch.gather(block_tbl.long(), 1, col[:, None])[:, 0]   # (B,)
    off = pos % blk
    cache_k[dest, off] = k[:, 0].to(cache_k.dtype)
    cache_v[dest, off] = v[:, 0].to(cache_v.dtype)
    return cache_k, cache_v


def cache_write_chunk_paged(cache_k: torch.Tensor, cache_v: torch.Tensor,
                            k: torch.Tensor, v: torch.Tensor, base: IntLike,
                            block_tbl: torch.Tensor,
                            lens: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write a C-token chunk's K/V (B,C,nkv,d) at virtual positions
    [base, base+C) through the block table, in place. ``base`` may be
    per-row (B,); ``lens`` (B,) masks each row's columns past its real
    length into the trash block."""
    blk = cache_k.shape[1]
    b, c = k.shape[0], k.shape[1]
    ar = torch.arange(c, device=k.device)
    t = _row_vector(base, b, k.device)[:, None] + ar[None, :]      # (B, C)
    # clamp: pad columns may index past the table width (JAX clamps the
    # gather; torch would raise)
    t = torch.clamp(t, max=block_tbl.shape[1] * blk - 1)
    dest = torch.gather(block_tbl.long(), 1, t // blk)
    off = t % blk
    if lens is not None:
        dest = torch.where(ar[None, :] < lens.long()[:, None], dest,
                           torch.zeros_like(dest))
    cache_k[dest, off] = k.to(cache_k.dtype)
    cache_v[dest, off] = v.to(cache_v.dtype)
    return cache_k, cache_v


def cache_write_prefill_paged(pool_k: torch.Tensor, pool_v: torch.Tensor,
                              k: torch.Tensor, v: torch.Tensor,
                              block_tbl: torch.Tensor,
                              lens: Optional[torch.Tensor] = None) -> None:
    """Scatter stacked prefill K/V (L,B,S,nkv,d) into the stacked pool
    (L, n_blocks, block, nkv, d) through ``block_tbl`` (B, max_blocks), in
    place; positions at or past ``lens[b]`` land in the trash block."""
    blk = pool_k.shape[2]
    t = torch.arange(k.shape[2], device=k.device)
    col = torch.clamp(t // blk, max=block_tbl.shape[1] - 1)
    dest = block_tbl.long()[:, col]                              # (B, S)
    if lens is not None:
        dest = torch.where(t[None, :] < lens.long()[:, None], dest,
                           torch.zeros_like(dest))
    off = t % blk
    pool_k[:, dest, off] = k.to(pool_k.dtype)
    pool_v[:, dest, off] = v.to(pool_v.dtype)
