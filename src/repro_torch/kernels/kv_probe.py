"""KV sanitizer probe: the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces the ``probe=True`` output of three Pallas TPU kernels: the (B, nh)
maximum of |K| and |V| over the positions each row's mask may read, which
``decode_attention_paged`` (``repro/kernels/decode_attention.py``) and
``chunk_attention_paged`` / ``chunk_attention``
(``repro/kernels/chunk_attention.py``) return beside their output and
``repro/kernels/ops.py`` checks against ``KV_POISON``. Here it is one
kernel of its own, ``csrc/kv_probe.cu``, whose header note says what bounds
it and how it is built; the three attention wrappers call it when asked
for ``probe=True``.

Row b's queries sit at positions ``bases[b] + [0, n)``; it may read the
positions ``t <= bases[b] + n - 1`` (and ``t > bases[b] - window`` under a
sliding window) within its capacity: the ``S`` keys of a contiguous
``(B, S, nkv, d)`` cache, or ``max_blocks * block`` positions of the
``(n_blocks, block, nkv, d)`` pool read through the row's block table,
trash entries included. ``n`` is the chunk length ``c`` for every row (the
Pallas kernels' contract: pad columns count too; decode is ``c = 1`` at
``bases = pos``), or per row ``cols[b] <= c``; a row of no column reads
nothing.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/kernels/csrc/kv_probe.cu"
REPLACES = {"kv_probe": "src/repro/kernels/decode_attention.py:146 and "
                        "src/repro/kernels/chunk_attention.py:84 (probe)"}

# kernel launches (plain-version calls excluded)
launch_counts = {name: 0 for name in REPLACES}

IntLike = Union[int, torch.Tensor]


def kv_probe_plain(cache_k: torch.Tensor, cache_v: torch.Tensor,
                   block_tbl: Optional[torch.Tensor], bases: IntLike, c: int,
                   nh: int, window: Optional[int] = None,
                   cols: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: each position's largest |K| / |V| per KV head, the
    rows' pages gathered through the table (``block_tbl`` None: a
    contiguous cache), masked to the readable positions, the maximum taken
    and repeated to the ``nh`` query heads. (B, nh) fp32."""
    nkv = cache_k.shape[2]
    mag = torch.maximum(cache_k.abs().amax(-1), cache_v.abs().amax(-1))
    mag = mag.float()                               # (rows, S or bs, nkv)
    if block_tbl is not None:
        b = block_tbl.shape[0]
        mag = mag[block_tbl.long()].reshape(b, -1, nkv)
    b, cap = mag.shape[0], mag.shape[1]
    bases = torch.as_tensor(bases, device=mag.device).long().expand(b)
    n = torch.full_like(bases, c) if cols is None else \
        torch.clamp(cols.long(), max=c)
    t = torch.arange(cap, device=mag.device)[None, :]
    readable = (t <= (bases + n - 1)[:, None]) & (n > 0)[:, None]
    if window is not None:
        readable &= t > (bases - window)[:, None]
    worst = torch.where(readable[..., None], mag, torch.zeros_like(mag))
    return worst.amax(1).repeat_interleave(nh // nkv, dim=1)


def kv_probe(cache_k: torch.Tensor, cache_v: torch.Tensor,
             block_tbl: Optional[torch.Tensor], bases: IntLike, c: int,
             nh: int, window: Optional[int] = None,
             cols: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel launch, CUDA tensors only: the (B, nh) fp32 probe. ``bases``
    a scalar or (B,); ``cols`` None or a (B,) int32 of at most ``c``."""
    name = "kv_probe"
    paged = block_tbl is not None
    tensors = (cache_k, cache_v) + ((block_tbl,) if paged else ())
    _build.refuse_grad(name, cache_k, cache_v, missing=_build.SERVING)
    _build.require_cuda(name, *tensors)
    _build.expect(cache_k.ndim == 4 and cache_v.shape == cache_k.shape
                  and cache_k.dtype == cache_v.dtype
                  and cache_k.dtype in _build.DTYPES
                  and cache_k.shape[3] in _build.HEAD_DIMS
                  and nh % cache_k.shape[2] == 0 and c >= 0,
                  f"{name}: unsupported K/V {tuple(cache_k.shape)} "
                  f"{cache_k.dtype}, nh={nh}, c={c}")
    _build.expect(cache_k.data_ptr() % 16 == 0
                  and cache_v.data_ptr() % 16 == 0,
                  f"{name}: K/V must be 16-byte aligned")
    rows, s, nkv, d = cache_k.shape
    if paged:
        _build.expect(block_tbl.dtype == torch.int32 and block_tbl.ndim == 2,
                      f"{name}: block_tbl must be (B, max_blocks) int32")
        b, mb = block_tbl.shape
        bs, cap = s, block_tbl.shape[1] * s
    else:
        b, mb, bs, cap = rows, 0, 0, s
    bases = _build.row_vector(bases, b, cache_k.device)
    if cols is not None:
        _build.require_cuda(name, cols)
        _build.expect(cols.dtype == torch.int32 and cols.shape == (b,),
                      f"{name}: cols must be ({b},) int32")
    out = torch.empty((b, nh), dtype=torch.float32, device=cache_k.device)
    if b == 0 or c == 0:
        return out.zero_()              # no column: nothing is readable
    rc = _build.load().rt_kv_probe(
        cache_k.data_ptr(), cache_v.data_ptr(),
        block_tbl.data_ptr() if paged else None, bases.data_ptr(),
        cols.data_ptr() if cols is not None else None, out.data_ptr(), b,
        nh, nkv, d, bs, mb, cap, c, window or 0,
        int(cache_k.dtype == torch.bfloat16), _build.stream_ptr(out.device))
    _build.check(rc, name)
    launch_counts[name] += 1
    return out
