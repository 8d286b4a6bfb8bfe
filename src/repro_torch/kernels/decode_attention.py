"""Paged GQA decode attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
``decode_attention_paged`` (``_dec_paged_kernel``); the kernel source is
``csrc/decode_attention.cu``, whose header note says what bounds it on the
card and what its design does about that. ``kernels/ops.py`` routes a CUDA
tensor here and a CPU tensor to the plain version.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from repro_torch.kernels import _build
from repro_torch.models import attention as _attn

SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:168"

launch_count = 0          # kernel launches (plain-version calls excluded)
SPLIT = 256               # keys per CTA (split-KV); see the .cu header note


def decode_attention_paged_plain(q: torch.Tensor, cache_k: torch.Tensor,
                                 cache_v: torch.Tensor,
                                 block_tbl: torch.Tensor,
                                 pos: Union[int, torch.Tensor],
                                 window: Optional[int] = None
                                 ) -> torch.Tensor:
    """Plain version: gather the pages, mask, softmax (the oracle in
    ``models/attention.py``)."""
    return _attn.decode_attention_paged(q, cache_k, cache_v, block_tbl, pos,
                                        window=window)


def decode_attention_paged(q: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, block_tbl: torch.Tensor,
                           pos: Union[int, torch.Tensor],
                           window: Optional[int] = None) -> torch.Tensor:
    """Kernel launch. q: (B,1,nh,d); cache_k/v: (n_blocks, block, nkv, d)
    pool; block_tbl: (B, max_blocks) int32; pos scalar or (B,), position
    of the current (already written) token. CUDA tensors only."""
    global launch_count
    name = "decode_attention_paged"
    _build.require_cuda(name, q, cache_k, cache_v, block_tbl)
    _build.expect(q.ndim == 4 and q.shape[1] == 1, f"{name}: q must be "
                  f"(B,1,nh,d), got {tuple(q.shape)}")
    b, _, nh, d = q.shape
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
    pos = _build.row_vector(pos, b, q.device)
    out = torch.empty_like(q)
    if b == 0:
        return out
    mb = block_tbl.shape[1]
    nsplit = max(1, -(-min(mb * bs, window or mb * bs) // SPLIT))
    # per-split partials (unnormalised acc, then max and denominator)
    part_acc = torch.empty((b, nh, nsplit, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, nh, nsplit, 2), dtype=torch.float32,
                          device=q.device)
    lib = _build.load()
    rc = lib.rt_decode_attention_paged(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        block_tbl.data_ptr(), pos.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), b, nh, nkv, d, bs, mb,
        window or 0, SPLIT, nsplit, 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    _build.check(rc, name)
    launch_count += 1
    return out
