"""Full-sequence (prefill) flash attention: the CUDA kernel's wrapper and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
``flash_attention`` (``_fa_kernel``); the kernel source is
``csrc/flash_attention.cu``. The JAX wrapper's ``sq % block_q == 0``
requirement does not carry over: the kernel masks ragged ``Sq``/``Sk``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.models import attention as _attn

SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:77"

launch_count = 0          # kernel launches (plain-version calls excluded)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """Plain version: the ``models/attention.py`` prefill oracle."""
    return _attn.prefill_attention(q, k, v, causal=causal, window=window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    """Kernel launch. q: (B,Sq,nh,d), k/v: (B,Sk,nkv,d) -> (B,Sq,nh,d).
    CUDA tensors only."""
    global launch_count
    name = "flash_attention"
    _build.require_cuda(name, q, k, v)
    _build.expect(q.ndim == 4 and k.ndim == 4 and v.shape == k.shape,
                  f"{name}: q (B,Sq,nh,d) and k/v (B,Sk,nkv,d) expected")
    b, sq, nh, d = q.shape
    _, sk, nkv, dk = k.shape
    _build.expect(q.dtype in _build.DTYPES and k.dtype == q.dtype
                  and v.dtype == q.dtype,
                  f"{name}: q, k, v must share fp32 or bf16")
    _build.expect(k.shape[0] == b and dk == d and d in _build.HEAD_DIMS
                  and nh % nkv == 0,
                  f"{name}: unsupported shapes q={tuple(q.shape)} "
                  f"k={tuple(k.shape)}")
    out = torch.empty_like(q)
    if b == 0 or sq == 0:
        return out
    lib = _build.load()
    rc = lib.rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk,
        nh, nkv, d, int(causal), window or 0, 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    _build.check(rc, name)
    launch_count += 1
    return out
