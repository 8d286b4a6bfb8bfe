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
tensors for symmetry with the reference signatures. A write casts with
``common.astype``, so an fp8 cache (the reference's ``kv_cache_dtype``)
holds the bytes the reference's ``astype`` writes; every read upcasts to
the query's dtype, exactly.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.models.common import FP8_DTYPES, astype

NEG_INF = -1e30

IntLike = Union[int, torch.Tensor]
_FP8 = tuple(FP8_DTYPES.values())


def _put(cache: torch.Tensor, index, val: torch.Tensor) -> None:
    """``cache[index] = val`` in place, cast by ``astype``; an fp8 cache is
    written as its bytes (uint8 views), so the indexing kernels need no
    fp8 dtype."""
    val = astype(val, cache.dtype)
    if cache.dtype in _FP8:
        cache, val = cache.view(torch.uint8), val.view(torch.uint8)
    cache[index] = val


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
# ``[b, t]``. Sliding windows apply by masking.
#
# A ring (sliding-window) cache holds ``S_alloc = min(max_len, window)``
# slots shared by rows at one position: position p lives in slot
# ``p % S_alloc``, and ``slot_pos (S_alloc,)`` records the position each
# slot holds (-1: empty). The engine never allocates one (it names
# ``ring=False``, as the reference's does); ``LM.prefill(ring=True)`` and
# its decode steps do.
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


def decode_attention_lse(q: torch.Tensor, cache_k: torch.Tensor,
                         cache_v: torch.Tensor, pos: IntLike,
                         window: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``decode_attention``'s function as one slice's partial of a cache
    cut by sequence: (out (B,1,nh,d) fp32, lse (B,nh) fp32, the natural
    log-sum-exp of the row's visible scores). A row that sees no key
    (``pos`` negative: its position lies before the slice) gives 0 and
    -inf, where the finite-masked ``decode_attention`` averages every
    value; probabilities are rounded to the cache's compute dtype before
    the PV product, as ``sdpa`` rounds them."""
    b, _, nh, d = q.shape
    pos = _row_vector(pos, b, q.device)
    kpos = torch.arange(cache_k.shape[1], device=q.device)
    valid = kpos[None, :] <= pos[:, None]                     # (B, S)
    if window is not None:
        valid &= kpos[None, :] > (pos[:, None] - window)
    if cache_k.dtype != q.dtype:
        cache_k, cache_v = cache_k.to(q.dtype), cache_v.to(q.dtype)
    scores = _gqa_scores(q, cache_k) / math.sqrt(d)           # (B,k,g,1,S)
    mask = valid[:, None, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, -math.inf))
    lse = torch.logsumexp(scores, dim=-1)                     # (B,k,g,1)
    probs = torch.where(mask, torch.exp(scores - torch.where(
        torch.isfinite(lse), lse, torch.zeros_like(lse))[..., None]),
        torch.zeros_like(scores))
    o = _gqa_out(probs.to(cache_v.dtype).float(), cache_v.float())
    return o, lse.reshape(b, nh)


def merge_partials(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Merge the partials of R slices of a cache cut by sequence:
    ``o`` (R, B, 1, nh, d) and ``lse`` (R, B, nh), fp32, as
    ``decode_attention_lse`` or the kernel with ``lse=`` gives them, into
    the attention over the whole cache, in fp32: sum_r e^{lse_r - M} o_r /
    sum_r e^{lse_r - M}, M the largest lse_r; a row whose every lse_r is
    -inf (it sees no key anywhere) gives 0."""
    m = lse.amax(dim=0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - m)                                    # (R, B, nh)
    den = w.sum(dim=0)
    num = (w[:, :, None, :, None] * o.float()).sum(dim=0)
    den = torch.where(den > 0, den, torch.ones_like(den))
    return num / den[:, None, :, None]


def decode_attention_ring(q: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, pos: IntLike,
                          slot_pos: torch.Tensor) -> torch.Tensor:
    """One-token attention against a ring cache (the reference's
    ``slot_pos`` branch): a slot is visible when it holds a position in
    ``[0, pos]``; the window is in the ring's size."""
    pos = _row_vector(pos, q.shape[0], q.device)
    sp = slot_pos.long()[None, :]
    valid = (sp >= 0) & (sp <= pos[:, None])                  # (B, S)
    if cache_k.dtype != q.dtype:
        cache_k, cache_v = cache_k.to(q.dtype), cache_v.to(q.dtype)
    return sdpa(q, cache_k, cache_v, valid[:, None, None, None, :])


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
    _put(cache_k, (rows, slot), k[:, 0])
    _put(cache_v, (rows, slot), v[:, 0])
    return cache_k, cache_v


def cache_write_token_slice(cache_k: torch.Tensor, cache_v: torch.Tensor,
                            k: torch.Tensor, v: torch.Tensor, pos: IntLike,
                            offset: int, length: int) -> None:
    """``cache_write_token`` on one slice of a cache of ``length``
    positions cut by sequence, the slice holding positions [offset, offset
    + S) (S = ``cache_k.shape[1]``): a row writes here only when its slot
    (``pos`` clamped to ``length - 1``, as the whole cache clamps it)
    falls in the slice; the other rows keep what they hold. In place,
    without a host sync (the rows that keep theirs write it back)."""
    b, s = k.shape[0], cache_k.shape[1]
    rows = torch.arange(b, device=k.device)
    at = torch.clamp(_row_vector(pos, b, k.device), max=length - 1) - offset
    own = ((at >= 0) & (at < s))[:, None, None]
    slot = at.clamp(0, s - 1)
    for cache, new in ((cache_k, k), (cache_v, v)):
        val = astype(new[:, 0], cache.dtype)
        if cache.dtype in _FP8:
            cache, val = cache.view(torch.uint8), val.view(torch.uint8)
        cache[rows, slot] = torch.where(own, val, cache[rows, slot])


def cache_write_token_ring_slice(cache_k: torch.Tensor,
                                 cache_v: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, pos: IntLike,
                                 slot_pos: torch.Tensor, offset: int) -> None:
    """``cache_write_token_ring`` on one slice of a ring cut by sequence,
    the slice holding slots [offset, offset + S) of ``slot_pos``'s
    ``S_alloc``: the token lands here only when its slot ``pos % S_alloc``
    falls in the slice, and ``slot_pos`` (every slot's, held whole) records
    it either way."""
    pos = _row_vector(pos, k.shape[0], k.device)
    slot = pos % slot_pos.shape[0]
    cache_write_token_slice(cache_k, cache_v, k, v, slot, offset,
                            slot_pos.shape[0])
    slot_pos[slot] = pos.to(slot_pos.dtype)


def cache_write_token_ring(cache_k: torch.Tensor, cache_v: torch.Tensor,
                           k: torch.Tensor, v: torch.Tensor, pos: IntLike,
                           slot_pos: torch.Tensor) -> None:
    """Write one token's K/V (B,1,nkv,d) into a ring cache at slot ``pos %
    S_alloc`` and record ``pos`` in ``slot_pos``, in place (the
    reference's ring branch; its rows share one position)."""
    pos = _row_vector(pos, k.shape[0], k.device)
    slot = pos % cache_k.shape[1]
    rows = torch.arange(k.shape[0], device=k.device)
    _put(cache_k, (rows, slot), k[:, 0])
    _put(cache_v, (rows, slot), v[:, 0])
    slot_pos[slot] = pos.to(slot_pos.dtype)


def ring_prefill_layout(kv: torch.Tensor, s_alloc: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A prompt's stacked K or V (L,B,S,nkv,d) laid out in a ring of
    ``s_alloc`` slots (the reference's ``_write_prefill_stacked``): a
    prompt that fits lands at slots [0, S), the rest empty; a longer one
    keeps its last ``s_alloc`` positions, position p at slot p % s_alloc.
    Returns (the (L,B,s_alloc,nkv,d) contents, ``slot_pos``)."""
    s = kv.shape[2]
    ar = torch.arange(s_alloc, device=kv.device)
    out = kv.new_zeros(kv.shape[:2] + (s_alloc,) + kv.shape[3:])
    if s <= s_alloc:
        out[:, :, :s] = kv
        return out, torch.where(ar < s, ar, -1).to(torch.int32)
    start = s - s_alloc
    order = torch.argsort((start + ar) % s_alloc)
    out[:] = kv[:, :, start:][:, :, order]
    return out, (start + order).to(torch.int32)


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
    _put(cache_k, (slice(None), slice(base, base + c)), k)
    _put(cache_v, (slice(None), slice(base, base + c)), v)
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
    _put(cache_k, (dest, off), k[:, 0])
    _put(cache_v, (dest, off), v[:, 0])
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
    _put(cache_k, (dest, off), k)
    _put(cache_v, (dest, off), v)
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
    _put(pool_k, (slice(None), dest, off), k)
    _put(pool_v, (slice(None), dest, off), v)
