"""GQA decode attention, paged and contiguous: the CUDA kernels' wrappers
and their plain PyTorch versions.

Replaces the Pallas TPU kernels of ``repro/kernels/decode_attention.py``:
``decode_attention_paged`` (``_dec_paged_kernel``) against a block pool
through per-row tables, and ``decode_attention`` (``_dec_kernel``) against a
contiguous ``(B, S, nkv, d)`` cache, which can also return each row's
log-sum-exp beside an fp32 output (``lse=``), the partial that a cache cut
by sequence over ranks merges. Both kernels live in
``csrc/decode_attention.cu``, whose header note says what bounds them on the
card and what the design does about that; bf16 decode of either layout with
up to 16 query heads per KV head runs the tensor-core body of
``csrc/decode_sm90.cuh``. The contiguous kernel also reads an fp8 cache
(``float8_e4m3fn`` / ``float8_e5m2``, the reference's ``kv_cache_dtype``)
as it is stored, upcast exactly on load, and counts its launches by the
cache's dtype (``launches_by_cache_dtype``). ``kernels/ops.py`` routes a
CUDA tensor here and a CPU tensor to the plain versions. With
``probe=True`` the paged wrapper and its plain version also return the KV
sanitizer's (B, nh) probe (``kernels/kv_probe.py``), as the Pallas kernel
does.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple, Union

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
# decode_attention's launches by the cache's dtype ("bfloat16",
# "float8_e4m3fn", ...)
launches_by_cache_dtype: Dict[str, int] = {}
# of decode_attention's launches, those with the log-sum-exp output
lse_launches = [0]


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
             cache_v: torch.Tensor, fp8_kv: bool = False) -> None:
    _build.expect(q.ndim == 4 and q.shape[1] == 1, f"{name}: q must be "
                  f"(B,1,nh,d), got {tuple(q.shape)}")
    _build.expect_attention(name, q, cache_k, cache_v, fp8_kv=fp8_kv)


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
    _build.refuse_grad(name, q, cache_k, cache_v, missing=_build.SERVING)
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
                           window: Optional[int] = None,
                           lse: Optional[torch.Tensor] = None):
    """Plain version: mask the linear cache by position, softmax (the
    oracle in ``models/attention.py``). With ``lse`` (a (B, nh) fp32
    tensor), as the kernel: (out in fp32, ``lse`` filled with each row's
    natural log-sum-exp of its visible scores), a row that sees no key
    giving 0 and -inf."""
    if lse is None:
        return _attn.decode_attention(q, cache_k, cache_v, pos,
                                      window=window)
    o, m = _attn.decode_attention_lse(q, cache_k, cache_v, pos,
                                      window=window)
    lse.copy_(m)
    return o, lse


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: Union[int, torch.Tensor],
                     window: Optional[int] = None,
                     lse: Optional[torch.Tensor] = None):
    """Kernel launch. q: (B,1,nh,d); cache_k/v: (B, S, nkv, d) contiguous,
    any S, in q's dtype or one fp8 dtype (read as stored, upcast exactly
    on load); pos scalar or (B,), position of the current (already
    written) token; a row whose pos is past the cache end reads the whole
    cache. CUDA tensors only.

    With ``lse`` (a (B, nh) fp32 tensor) the kernel also stores each row's
    natural log-sum-exp of its visible scores there (-inf where it sees
    none, and then its output is 0), writes the output in fp32 and returns
    (out, lse): the partial of one slice of a cache cut by sequence, which
    ``models.attention.merge_partials`` merges over the slices. The kernel
    takes no offset: a slice holding positions [off, off + S) is read at
    the local position ``pos - off``, so a row whose position lies before
    the slice (negative) sees nothing, one past its end sees all of it,
    and a window counts back from the shifted position as it does from the
    global one."""
    name = "decode_attention"
    _build.refuse_grad(name, q, cache_k, cache_v, missing=_build.SERVING)
    _build.require_cuda(name, q, cache_k, cache_v)
    _check_q(name, q, cache_k, cache_v, fp8_kv=True)
    b, _, nh, d = q.shape
    _, s, nkv, _ = cache_k.shape
    _build.expect(cache_k.shape[0] == b and b * s < 2 ** 31,
                  f"{name}: cache {tuple(cache_k.shape)} for q batch {b} "
                  f"(batch must match; B * S rows must fit an int32)")
    # the kernel copies K/V rows in 16-byte pieces (8 at an fp8 d of 120)
    _build.expect(cache_k.data_ptr() % 16 == 0
                  and cache_v.data_ptr() % 16 == 0,
                  f"{name}: K/V must start 16-byte aligned")
    if lse is not None:
        _build.require_cuda(name, q, lse)
        _build.expect(lse.dtype == torch.float32
                      and tuple(lse.shape) == (b, nh),
                      f"{name}: lse must be fp32 ({b}, {nh})")
    pos = _build.row_vector(pos, b, q.device)
    out = torch.empty(q.shape, device=q.device,
                      dtype=q.dtype if lse is None else torch.float32)
    if b == 0:
        return out if lse is None else (out, lse)
    split, nsplit, part_acc, part_ml = _partials(q, nkv, s, window)
    lib = _build.load()
    rc = lib.rt_decode_attention(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        None if lse is None else lse.data_ptr(), b, nh, nkv, d, s,
        window or 0, split, nsplit, 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16),
        _build.KV_FORMATS.get(cache_k.dtype, 0), _build.stream_ptr(q.device))
    _build.check(rc, name)
    launch_counts[name] += 1
    key = str(cache_k.dtype).removeprefix("torch.")
    launches_by_cache_dtype[key] = launches_by_cache_dtype.get(key, 0) + 1
    if lse is not None:
        lse_launches[0] += 1
        return out, lse
    return out
