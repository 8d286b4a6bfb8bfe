"""GQA decode attention, paged and contiguous: the CUDA kernels' wrappers
and their plain PyTorch versions.

Replaces the Pallas TPU kernels of ``repro/kernels/decode_attention.py``:
``decode_attention_paged`` (``_dec_paged_kernel``) against a block pool
through per-row tables, and ``decode_attention`` (``_dec_kernel``) against a
contiguous ``(B, S, nkv, d)`` cache. Both kernels live in
``csrc/decode_attention.cu``, whose header note says what bounds them on the
card and what the design does about that; bf16 decode of either layout with
up to 16 query heads per KV head runs the tensor-core body of
``csrc/decode_sm90.cuh``. ``kernels/ops.py`` routes a CUDA tensor here and a
CPU tensor to the plain versions. With ``probe=True`` the paged wrapper
and its plain version also return the KV sanitizer's (B, nh) probe
(``kernels/kv_probe.py``), as the Pallas kernel does.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import kv_probe as _kvp
from repro_torch.models import attention as _attn

SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"
REPLACES = {
    "decode_attention_paged": "src/repro/kernels/decode_attention.py:168",
    "decode_attention": "src/repro/kernels/decode_attention.py:71"}

# kernel launches per kernel (plain-version calls excluded)
launch_counts = {name: 0 for name in REPLACES}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _plan(b: int, nh: int, nkv: int, keys: int, window: int, bf16: bool,
          sms: int) -> Tuple[int, int]:
    """(split, nsplit) from ``rt_decode_plan``, the C side that also picks
    the body they size."""
    out = (ctypes.c_int * 2)()
    rc = _build.load().rt_decode_plan(b, nh, nkv, keys, window, int(bf16),
                                      sms, out)
    _build.check(rc, "rt_decode_plan")
    return out[0], out[1]


def _check_q(name: str, q: torch.Tensor, cache_k: torch.Tensor,
             cache_v: torch.Tensor) -> None:
    _build.expect(q.ndim == 4 and q.shape[1] == 1, f"{name}: q must be "
                  f"(B,1,nh,d), got {tuple(q.shape)}")
    _build.expect_attention(name, q, cache_k, cache_v)


def _partials(q: torch.Tensor, nkv: int, keys: int,
              window: Optional[int]):
    """Split size and count for rows of ``keys`` keys, and per-split
    scratch: the unnormalised accumulators (B, nh, nsplit, d) and (max,
    denominator) pairs (B, nh, nsplit, 2)."""
    b, _, nh, d = q.shape
    bf16 = q.dtype == torch.bfloat16
    split, nsplit = _plan(b, nh, nkv, keys, window or 0, bf16,
                          _sm_count(q.device.index))
    part_acc = torch.empty((b, nh, nsplit, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, nh, nsplit, 2), dtype=torch.float32,
                          device=q.device)
    return split, nsplit, part_acc, part_ml


def decode_attention_paged_plain(q: torch.Tensor, cache_k: torch.Tensor,
                                 cache_v: torch.Tensor,
                                 block_tbl: torch.Tensor,
                                 pos: Union[int, torch.Tensor],
                                 window: Optional[int] = None,
                                 probe: bool = False):
    """Plain version: gather the pages, mask, softmax (the oracle in
    ``models/attention.py``); with ``probe``, (out, the probe's plain
    version)."""
    out = _attn.decode_attention_paged(q, cache_k, cache_v, block_tbl, pos,
                                       window=window)
    if not probe:
        return out
    return out, _kvp.kv_probe_plain(cache_k, cache_v, block_tbl, pos, 1,
                                    q.shape[2], window=window)


def decode_attention_paged(q: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, block_tbl: torch.Tensor,
                           pos: Union[int, torch.Tensor],
                           window: Optional[int] = None, probe: bool = False):
    """Kernel launch. q: (B,1,nh,d); cache_k/v: (n_blocks, block, nkv, d)
    pool; block_tbl: (B, max_blocks) int32; pos scalar or (B,), position
    of the current (already written) token. CUDA tensors only. With
    ``probe``, returns (out, the (B, nh) probe), the probe a second
    launch."""
    name = "decode_attention_paged"
    _build.require_cuda(name, q, cache_k, cache_v, block_tbl)
    _check_q(name, q, cache_k, cache_v)
    b, _, nh, d = q.shape
    _, bs, nkv, _ = cache_k.shape
    _build.expect(block_tbl.dtype == torch.int32 and block_tbl.ndim == 2
                  and block_tbl.shape[0] == b, f"{name}: block_tbl must "
                  f"be ({b}, max_blocks) int32")
    pos = _build.row_vector(pos, b, q.device)
    out = torch.empty_like(q)
    if b > 0:
        mb = block_tbl.shape[1]
        split, nsplit, part_acc, part_ml = _partials(q, nkv, mb * bs, window)
        rc = _build.load().rt_decode_attention_paged(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            block_tbl.data_ptr(), pos.data_ptr(), out.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(), b, nh, nkv, d, bs, mb,
            window or 0, split, nsplit, 1.0 / math.sqrt(d),
            int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
        _build.check(rc, name)
        launch_counts[name] += 1
    if not probe:
        return out
    return out, _kvp.kv_probe(cache_k, cache_v, block_tbl, pos, 1, nh,
                              window=window)


def decode_attention_plain(q: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor,
                           pos: Union[int, torch.Tensor],
                           window: Optional[int] = None) -> torch.Tensor:
    """Plain version: mask the linear cache by position, softmax (the
    oracle in ``models/attention.py``)."""
    return _attn.decode_attention(q, cache_k, cache_v, pos, window=window)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: Union[int, torch.Tensor],
                     window: Optional[int] = None) -> torch.Tensor:
    """Kernel launch. q: (B,1,nh,d); cache_k/v: (B, S, nkv, d) contiguous,
    any S; pos scalar or (B,), position of the current (already written)
    token; a row whose pos is past the cache end reads the whole cache.
    CUDA tensors only."""
    name = "decode_attention"
    _build.require_cuda(name, q, cache_k, cache_v)
    _check_q(name, q, cache_k, cache_v)
    b, _, nh, d = q.shape
    _, s, nkv, _ = cache_k.shape
    _build.expect(cache_k.shape[0] == b and b * s < 2 ** 31,
                  f"{name}: cache {tuple(cache_k.shape)} for q batch {b} "
                  f"(batch must match; B * S rows must fit an int32)")
    pos = _build.row_vector(pos, b, q.device)
    out = torch.empty_like(q)
    if b == 0:
        return out
    split, nsplit, part_acc, part_ml = _partials(q, nkv, s, window)
    lib = _build.load()
    rc = lib.rt_decode_attention(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), b, nh, nkv,
        d, s, window or 0, split, nsplit, 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    _build.check(rc, name)
    launch_counts[name] += 1
    return out
