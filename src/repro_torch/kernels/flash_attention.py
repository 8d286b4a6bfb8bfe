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
REPLACES = {"flash_attention": "src/repro/kernels/flash_attention.py:77"}

# kernel launches (plain-version calls excluded)
launch_counts = {"flash_attention": 0}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """Plain version: the ``models/attention.py`` SDPA under the kernel's
    own mask. As ``_fa_kernel`` (and the CUDA kernel), query i sees key j
    when ``j <= i`` under ``causal`` and ``j > i - window`` whenever a window
    is given; the model oracle ``prefill_attention`` drops the window
    without ``causal``, the kernels do not."""
    sq, sk = q.shape[1], k.shape[1]
    mask = None
    if causal:
        mask = _attn.causal_mask(sq, sk, 0, window, q.device)
    elif window is not None:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        mask = (kpos > qpos - window)[None, None, None]
    return _attn.sdpa(q, k, v, mask)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    """Kernel launch. q: (B,Sq,nh,d), k/v: (B,Sk,nkv,d) -> (B,Sq,nh,d).
    CUDA tensors only."""
    name = "flash_attention"
    _build.require_cuda(name, q, k, v)
    _build.expect_attention(name, q, k, v)
    b, sq, nh, d = q.shape
    _, sk, nkv, _ = k.shape
    _build.expect(k.shape[0] == b, f"{name}: k/v batch {k.shape[0]} != "
                  f"q batch {b}")
    out = torch.empty_like(q)
    if b == 0 or sq == 0:
        return out
    lib = _build.load()
    rc = lib.rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk,
        nh, nkv, d, int(causal), window or 0, 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    _build.check(rc, name)
    launch_counts[name] += 1
    return out
