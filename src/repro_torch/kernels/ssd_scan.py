"""Mamba2 SSD chunked scan: the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py`` ``ssd_scan``
(``_ssd_kernel``); the kernel source is ``csrc/ssd_scan.cu``, whose header
note says what bounds it on the card and what its design does about that;
bf16 runs the tensor-core body of ``csrc/ssd_sm90.cuh``.
The plain version ``ssd_scan_plain`` is the port of the reference's
chunked algorithm ``repro/models/ssm.py`` ``ssd_chunked``;
``ssd_scan_sequential`` is the O(S) recurrence the chunked algorithm is
checked against (``repro/kernels/ref.py`` ``ssd_scan_sequential_ref``).

Shapes, as in the reference: x (B,S,nh,hd), dt (B,S,nh) fp32 (after
softplus, > 0), a (nh,) fp32 (< 0), b/c (B,S,N) (one group shared by every
head), optional h0 (B,nh,hd,N) fp32. Returns y (B,S,nh,hd) in x's dtype
and the final state (B,nh,hd,N) fp32. The kernel masks the ragged tail of
S itself (a step past S acts as dt = 0, an exact no-op for the state):
there is no padding copy.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
REPLACES = {"ssd_scan": "src/repro/kernels/ssd_scan.py:69"}

# kernel launches (plain-version calls excluded)
launch_counts = {"ssd_scan": 0}
MAX_CHUNK = 128           # chunk length Q the kernel takes (shared memory)
MAX_STATE = 256           # state width N the kernel takes


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, chunk: int = 128,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan in plain PyTorch (the reference's ``ssd_chunked``):
    within a chunk the masked quadratic form ``(C B^T) * exp(l_i - l_j)``
    applied to ``x * dt``, across chunks the (hd, N) state recurrence."""
    bsz, s, nh, hd = x.shape
    n = b.shape[-1]
    pad = (-s) % chunk
    if pad:
        # zero-pad the tail: dt=0 => decay exp(0)=1 and no state update, so
        # padded steps are exact no-ops for the carried state
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    h = (torch.zeros((bsz, nh, hd, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    ys = []
    for k in range(nc):
        sl = slice(k * chunk, (k + 1) * chunk)
        xk, dtk = x[:, sl].float(), dt[:, sl].float()
        bk, ck = b[:, sl].float(), c[:, sl].float()
        # log-decay within the chunk: l_t = sum_{u<=t} dt_u * a
        l = torch.cumsum(dtk * a, dim=1)                       # (B,Q,nh)
        li, lj = l[:, :, None, :], l[:, None, :, :]
        decay = torch.where(mask, torch.exp(li - lj),
                            torch.zeros((), device=x.device))  # (B,i,j,nh)
        cb = torch.einsum("bin,bjn->bij", ck, bk)
        m = cb[..., None] * decay
        xdt = xk * dtk[..., None]                              # (B,j,nh,hd)
        y_intra = torch.einsum("bijh,bjhd->bihd", m, xdt)
        # inter-chunk: contribution of the carried state
        y_inter = torch.einsum("bin,bhdn,bih->bihd", ck, h,
                               torch.exp(l))
        l_last = l[:, -1:, :]
        w = torch.exp(l_last - l)                              # (B,Q,nh)
        hb = torch.einsum("bjn,bjhd,bjh->bhdn", bk, xdt, w)
        h = h * torch.exp(l_last[:, 0, :])[:, :, None, None] + hb
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.cat(ys, dim=1)[:, :s]
    return y, h


def ssd_scan_sequential(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, c: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(S) recurrence, one ``ssd_step`` per position: the independent
    second oracle the chunked algorithm is held against."""
    # imported here: models/ssm.py imports the kernels
    from repro_torch.models.ssm import ssd_step
    bsz, s, nh, hd = x.shape
    h = torch.zeros((bsz, nh, hd, b.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(s):
        y, h = ssd_step(x[:, t], dt[:, t], a, b[:, t], c[:, t], h)
        ys.append(y)
    return torch.stack(ys, dim=1), h


def _row_strides(t: torch.Tensor, name: str, what: str):
    """Element strides of every axis but the last, which must be unit: the
    kernel reads views (the model's x, B and C are slices of one conv
    output) without a copy."""
    _build.expect(t.stride(-1) == 1, f"ssd_scan: {name} needs a unit-stride "
                  f"last axis ({what})")
    return list(t.stride()[:-1])


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int = 128,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel launch (CUDA tensors only). Same arguments and results as
    ``ssd_scan_plain``."""
    name = "ssd_scan"
    _build.expect(x.ndim == 4 and dt.ndim == 3 and a.ndim == 1
                  and b.ndim == 3 and c.shape == b.shape,
                  f"{name}: bad ranks x={tuple(x.shape)} dt={tuple(dt.shape)}"
                  f" a={tuple(a.shape)} b={tuple(b.shape)} "
                  f"c={tuple(c.shape)}")
    bsz, s, nh, hd = x.shape
    n = b.shape[-1]
    _build.expect(tuple(dt.shape) == (bsz, s, nh) and a.shape[0] == nh
                  and tuple(b.shape[:2]) == (bsz, s),
                  f"{name}: shapes disagree x={tuple(x.shape)} "
                  f"dt={tuple(dt.shape)} a={tuple(a.shape)} "
                  f"b={tuple(b.shape)}")
    _build.expect(1 <= chunk <= MAX_CHUNK and 1 <= n <= MAX_STATE,
                  f"{name}: chunk {chunk} (<= {MAX_CHUNK}) or state {n} "
                  f"(<= {MAX_STATE}) out of range")
    _build.expect(x.dtype in _build.DTYPES and b.dtype == x.dtype
                  and c.dtype == x.dtype, f"{name}: x, b and c must share "
                  f"fp32 or bf16")
    _build.expect(dt.dtype == torch.float32 and a.dtype == torch.float32,
                  f"{name}: dt and a must be fp32")
    tensors = [x, dt, a, b, c] + ([h0] if h0 is not None else [])
    dev = x.device
    for t in tensors:
        _build.expect(t.is_cuda and t.device == dev,
                      f"{name}: every tensor must be on the same CUDA device")
    _build.expect(a.is_contiguous(), f"{name}: a must be contiguous")
    if h0 is not None:
        _build.expect(tuple(h0.shape) == (bsz, nh, hd, n)
                      and h0.dtype == torch.float32 and h0.is_contiguous(),
                      f"{name}: h0 must be a contiguous fp32 "
                      f"({bsz},{nh},{hd},{n})")
    strides = (_row_strides(x, "x", "head dim") + _row_strides(dt, "dt",
                                                               "heads")
               + _row_strides(b, "b", "state") + _row_strides(c, "c",
                                                              "state"))
    y = torch.empty((bsz, s, nh, hd), dtype=x.dtype, device=dev)
    h = torch.empty((bsz, nh, hd, n), dtype=torch.float32, device=dev)
    if bsz == 0 or nh == 0 or hd == 0:
        return y, h
    nc = max(1, math.ceil(s / chunk))
    # C B^T of every chunk, shared by all heads: (B, n_chunks, Q, Q) fp32
    cb = torch.empty((bsz, nc, chunk, chunk), dtype=torch.float32,
                     device=dev)
    lib = _build.load()
    rc = lib.rt_ssd_scan(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), h0.data_ptr() if h0 is not None else None,
        y.data_ptr(), h.data_ptr(), cb.data_ptr(), bsz, s, nh, hd, n, chunk,
        *strides, int(x.dtype == torch.bfloat16), _build.stream_ptr(dev))
    _build.check(rc, name)
    launch_counts[name] += 1
    return y, h
