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

The backward (``csrc/ssd_scan_bwd.cu``) has no Pallas counterpart: the JAX
package trains with ``use_pallas=False`` and lets XLA differentiate the
jnp ``ssd_chunked``. ``SsdScanFn`` runs the forward kernel, which also
stores the state each chunk starts from, and the backward kernel on the
output gradients, so a Mamba2 layer on the card trains through
hand-written kernels both ways. bf16 inputs under the forward's route
rule run the backward's tensor-core body (``csrc/ssd_bwd_sm90.cuh``),
everything else its CUDA-core body; ``bwd_plan`` says which.
``ssd_scan_bwd_plain`` is the backward written out as a reverse walk over
the chunks: the specification the kernel mirrors.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
BWD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu"
# the backward's bodies, as rt_ssd_scan_bwd_plan numbers them
BWD_BODIES = ("cuda-core", "tensor-core")
REPLACES = {"ssd_scan": "src/repro/kernels/ssd_scan.py:69",
            # no Pallas kernel: XLA's gradient of the jnp scan
            "ssd_scan_bwd": "src/repro/models/ssm.py:70 (XLA's gradient of "
                            "ssd_chunked; no Pallas kernel)"}

# kernel launches (plain-version calls excluded); the backward counts one
# per backward pass, whatever the number of launches inside it
launch_counts = {"ssd_scan": 0, "ssd_scan_bwd": 0}
# the forward's bodies, as rt_ssd_scan reports the one each launch took,
# and its launches by body (``reset_bodies`` zeroes them)
FWD_BODIES = ("cuda-core", "tensor-core")
body_counts = dict.fromkeys(FWD_BODIES, 0)
MAX_CHUNK = 128           # chunk length Q the kernel takes (shared memory)
MAX_STATE = 256           # state width N the kernel takes
MAX_BWD_HEAD_DIM = 64     # head dim the backward kernel takes (shared memory)


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


def _padded(chunk: int, *ts: torch.Tensor) -> list:
    """fp32 copies of (B, S, ...) tensors, S zero-padded to whole chunks."""
    pad = (-ts[0].shape[1]) % chunk
    return [F.pad(t.float(), (0, 0) * (t.ndim - 2) + (0, pad)) for t in ts]


def ssd_states_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, chunk: int = 128,
                     h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The state each chunk starts from, (B, n_chunks, nh, hd, N) fp32: the
    plain version of the forward kernel's ``states`` output (the first is
    h0, or zero)."""
    bsz, _, nh, hd = x.shape
    xf, dtf, bf = _padded(chunk, x, dt, b)
    af = a.float()
    h = (torch.zeros((bsz, nh, hd, b.shape[-1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    out = []
    for k in range(0, xf.shape[1], chunk):
        out.append(h)
        sl = slice(k, k + chunk)
        l = torch.cumsum(dtf[:, sl] * af, dim=1)               # (B,Q,nh)
        w = torch.exp(l[:, -1:] - l)
        xdt = xf[:, sl] * dtf[:, sl, :, None]
        h = (h * torch.exp(l[:, -1])[:, :, None, None]
             + torch.einsum("bjn,bjhd,bjh->bhdn", bf[:, sl], xdt, w))
    return torch.stack(out, dim=1)


def ssd_scan_bwd_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, chunk: int,
                       h0: Optional[torch.Tensor], dy: torch.Tensor,
                       dh_final: Optional[torch.Tensor]
                       ) -> Tuple[torch.Tensor, ...]:
    """The scan's backward written out in fp32: ``(dx, ddt, da, db, dc,
    dh0)`` of ``ssd_scan_plain`` at the output gradients ``dy`` and
    ``dh_final`` (None: zero), dx / db / dc in the inputs' dtype, the rest
    fp32 (dh0 None without ``h0``).

    A forward walk keeps each chunk's entry state ``h_in``
    (``ssd_states_plain``); the reverse walk carries ``dH``, the gradient
    of the chunk's exit state (first ``dh_final``). Per chunk and head,
    with l = cumsum(dt a), xdt = x dt,
    E_ij = exp(l_i - l_j) [j <= i], M_ij = (C_i . B_j) E_ij and
    w_j = exp(l_last - l_j):

      dxdt_j = sum_i M_ij dy_i + w_j dH B_j
      dh_in  = exp(l_last) dH + sum_i exp(l_i) dy_i (x) C_i
      dC_i   = sum_h [sum_j E_ij (dy_i . xdt_j) B_j + exp(l_i) h_in^T dy_i]
      dB_j   = sum_h [sum_i E_ij (dy_i . xdt_j) C_i + w_j dH^T xdt_j]
      dl_i   = sum_j T_ij - sum_k T_ki + exp(l_i) dy_i . (h_in C_i) - W_i,
               T_ij = M_ij (dy_i . xdt_j), W_j = w_j xdt_j . (dH B_j),
               and on the last row + exp(l_last) <dH, h_in> + sum_j W_j

    and g, the reverse cumsum of dl, is the gradient of dt a: ddt = g a +
    sum_d dxdt x, da = sum g dt, dx = dxdt dt. Every exponent is a
    difference <= 0. Positions past S act as dt = 0 and are cut off."""
    bsz, s, nh, hd = x.shape
    n = b.shape[-1]
    xf, dtf, bf, cf, dyf = _padded(chunk, x, dt, b, c, dy)
    af = a.float()
    nc = xf.shape[1] // chunk
    dev = x.device
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=dev))[None, :, :, None]
    sl = [slice(k * chunk, (k + 1) * chunk) for k in range(nc)]
    h_in = ssd_states_plain(x, dt, a, b, c, chunk, h0).unbind(1)
    dxdt_all = torch.zeros_like(xf)
    ddt_all = torch.zeros_like(dtf)
    db_all, dc_all = torch.zeros_like(bf), torch.zeros_like(cf)
    da = torch.zeros_like(af)
    dh = (torch.zeros((bsz, nh, hd, n), dtype=torch.float32, device=dev)
          if dh_final is None else dh_final.float())
    for k in reversed(range(nc)):
        xk, dtk, bk, ck, dyk = (t[:, sl[k]] for t in (xf, dtf, bf, cf, dyf))
        hk = h_in[k]
        l = torch.cumsum(dtk * af, dim=1)                       # (B,Q,nh)
        l_last = l[:, -1]                                       # (B,nh)
        el, w = torch.exp(l), torch.exp(l_last[:, None] - l)
        diff = l[:, :, None, :] - l[:, None, :, :]              # (B,i,j,nh)
        e = torch.exp(torch.where(mask, diff, torch.full_like(diff,
                                                              -math.inf)))
        cb = torch.einsum("bin,bjn->bij", ck, bk)
        m = cb[..., None] * e
        xdt = xk * dtk[..., None]                               # (B,Q,nh,hd)
        p = torch.einsum("bihd,bjhd->bijh", dyk, xdt)           # dy_i.xdt_j
        et = e * p
        dhb = torch.einsum("bhdn,bjn->bjhd", dh, bk)            # dH B_j
        dxdt = (torch.einsum("bijh,bihd->bjhd", m, dyk)
                + w[..., None] * dhb)
        dc_all[:, sl[k]] = (torch.einsum("bijh,bjn->bin", et, bk)
                            + torch.einsum("bih,bhdn,bihd->bin", el, hk,
                                           dyk))
        db_all[:, sl[k]] = (torch.einsum("bijh,bin->bjn", et, ck)
                            + torch.einsum("bjh,bhdn,bjhd->bjn", w, dh,
                                           xdt))
        t = cb[..., None] * et
        wj = w * torch.einsum("bjhd,bjhd->bjh", xdt, dhb)
        dl = (t.sum(2) - t.sum(1) - wj
              + el * torch.einsum("bihd,bhdn,bin->bih", dyk, hk, ck))
        dl[:, -1] += (torch.exp(l_last) * torch.einsum("bhdn,bhdn->bh", dh,
                                                       hk) + wj.sum(1))
        g = torch.flip(torch.cumsum(torch.flip(dl, (1,)), dim=1), (1,))
        ddt_all[:, sl[k]] = g * af + torch.einsum("bjhd,bjhd->bjh", dxdt, xk)
        da = da + torch.einsum("bjh,bjh->h", g, dtk)
        dxdt_all[:, sl[k]] = dxdt
        dh = (torch.exp(l_last)[:, :, None, None] * dh
              + torch.einsum("bih,bihd,bin->bhdn", el, dyk, ck))
    dx = (dxdt_all * dtf[..., None])[:, :s].to(x.dtype)
    return (dx, ddt_all[:, :s], da, db_all[:, :s].to(b.dtype),
            dc_all[:, :s].to(c.dtype), None if h0 is None else dh)


def _row_strides(t: torch.Tensor, name: str, what: str):
    """Element strides of every axis but the last, which must be unit: the
    kernel reads views (the model's x, B and C are slices of one conv
    output) without a copy."""
    _build.expect(t.stride(-1) == 1, f"ssd_scan: {name} needs a unit-stride "
                  f"last axis ({what})")
    return list(t.stride()[:-1])


def _check_inputs(name: str, x, dt, a, b, c, chunk: int) -> list:
    """Ranks, shapes, dtypes, devices and strides the kernels take; returns
    the element strides of x, dt, b and c."""
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
    for t in (x, dt, a, b, c):
        _build.expect(t.is_cuda and t.device == x.device,
                      f"{name}: every tensor must be on the same CUDA device")
    _build.expect(a.is_contiguous(), f"{name}: a must be contiguous")
    return (_row_strides(x, "x", "head dim") + _row_strides(dt, "dt", "heads")
            + _row_strides(b, "b", "state") + _row_strides(c, "c", "state"))


def _check_state(name: str, t: Optional[torch.Tensor], what: str,
                 shape: tuple, dev) -> None:
    if t is not None:
        _build.expect(t.is_cuda and t.device == dev,
                      f"{name}: every tensor must be on the same CUDA device")
        _build.expect(tuple(t.shape) == shape and t.dtype == torch.float32
                      and t.is_contiguous(),
                      f"{name}: {what} must be a contiguous fp32 {shape}")


def reset_bodies() -> None:
    for k in body_counts:
        body_counts[k] = 0


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int = 128,
             h0: Optional[torch.Tensor] = None,
             states: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel launch (CUDA tensors only). Same arguments and results as
    ``ssd_scan_plain``; with ``states`` (a contiguous fp32 (B, n_chunks,
    nh, hd, N)) the kernel also stores there the state each chunk starts
    from, which the backward walks. Gradients go through ``SsdScanFn``
    (``ops.ssd_scan`` picks it); called here directly with an input that
    requires grad, it raises."""
    name = "ssd_scan"
    _build.refuse_grad(name, x, dt, a, b, c, h0, missing="use SsdScanFn")
    strides = _check_inputs(name, x, dt, a, b, c, chunk)
    bsz, s, nh, hd = x.shape
    n = b.shape[-1]
    dev = x.device
    nc = max(1, math.ceil(s / chunk))
    _check_state(name, h0, "h0", (bsz, nh, hd, n), dev)
    _check_state(name, states, "states", (bsz, nc, nh, hd, n), dev)
    y = torch.empty((bsz, s, nh, hd), dtype=x.dtype, device=dev)
    h = torch.empty((bsz, nh, hd, n), dtype=torch.float32, device=dev)
    if bsz == 0 or nh == 0 or hd == 0:
        return y, h
    # C B^T of every chunk, shared by all heads: (B, n_chunks, Q, Q) fp32
    cb = torch.empty((bsz, nc, chunk, chunk), dtype=torch.float32,
                     device=dev)
    lib = _build.load()
    body = ctypes.c_int(0)
    rc = lib.rt_ssd_scan(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), h0.data_ptr() if h0 is not None else None,
        y.data_ptr(), h.data_ptr(), cb.data_ptr(),
        states.data_ptr() if states is not None else None, bsz, s, nh, hd,
        n, chunk, *strides, int(x.dtype == torch.bfloat16),
        ctypes.byref(body), _build.stream_ptr(dev))
    _build.check(rc, name)
    launch_counts[name] += 1
    body_counts[FWD_BODIES[body.value]] += 1
    return y, h


@functools.lru_cache(maxsize=1024)
def _bwd_plan(bsz: int, s: int, nh: int, hd: int, n: int, chunk: int,
              aligned: bool, strides: Tuple[int, ...], bf16: bool,
              device: int) -> Tuple[int, int, int]:
    """``rt_ssd_scan_bwd_plan``'s (body index, heads per CTA, scratch
    floats): the C side whose choice the launch makes too, from the
    device's SM count (``device`` keys the cache)."""
    out = (ctypes.c_longlong * 3)()
    rc = _build.load().rt_ssd_scan_bwd_plan(
        int(aligned), bsz, s, nh, hd, n, chunk, *strides, int(bf16), out)
    _build.check(rc, "rt_ssd_scan_bwd_plan")
    return out[0], out[1], out[2]


def bwd_plan(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             chunk: int) -> Tuple[str, int, int]:
    """``(body, heads per CTA, scratch floats)`` of a backward launch on
    these x, B and C (CUDA tensors). The body is ``"tensor-core"`` for
    bf16 under the forward's route rule (head dim and state width
    multiples of 8, 16-byte aligned rows and strides), else
    ``"cuda-core"``; the tensor-core body's heads per CTA come from the
    card's SM count."""
    bsz, s, nh, hd = x.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, b, c))
    strides = (*x.stride()[:3], *b.stride()[:2], *c.stride()[:2])
    body, group, work = _bwd_plan(
        bsz, s, nh, hd, b.shape[-1], chunk, aligned, strides,
        x.dtype == torch.bfloat16, x.device.index or 0)
    return BWD_BODIES[body], group, work


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it whose data starts on 16 bytes: the
    tensor-core body copies dy and the states in 16-byte pieces."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, chunk: int,
                 states: torch.Tensor, dy: torch.Tensor,
                 dh_final: Optional[torch.Tensor] = None,
                 want_dh0: bool = False) -> Tuple[torch.Tensor, ...]:
    """Kernel launch of the backward (CUDA tensors only): ``(dx, ddt, da,
    db, dc, dh0)`` as ``ssd_scan_bwd_plain`` returns them, from the
    forward's inputs (the same strided views the forward takes), the
    chunk entry ``states`` the forward stored, a contiguous ``dy`` in x's
    dtype and ``dh_final`` (None: zero); dh0 only with ``want_dh0``, else
    None. Head dims up to ``MAX_BWD_HEAD_DIM``; ``bwd_plan`` names the
    body it takes."""
    name = "ssd_scan_bwd"
    strides = _check_inputs(name, x, dt, a, b, c, chunk)
    bsz, s, nh, hd = x.shape
    n = b.shape[-1]
    dev = x.device
    _build.expect(hd <= MAX_BWD_HEAD_DIM, f"{name}: head dim {hd} > "
                  f"{MAX_BWD_HEAD_DIM}")
    nc = max(1, math.ceil(s / chunk))
    _check_state(name, states, "states", (bsz, nc, nh, hd, n), dev)
    _check_state(name, dh_final, "dh_final", (bsz, nh, hd, n), dev)
    _build.expect(dy.is_cuda and dy.device == dev,
                  f"{name}: every tensor must be on the same CUDA device")
    _build.expect(dy.shape == x.shape and dy.dtype == x.dtype
                  and dy.is_contiguous(), f"{name}: dy must be a contiguous "
                  f"{tuple(x.shape)} {x.dtype}")
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty(x.shape, dtype=x.dtype, device=dev)
    db = torch.empty(b.shape, dtype=x.dtype, device=dev)
    dc = torch.empty(c.shape, dtype=x.dtype, device=dev)
    ddt = torch.empty((bsz, s, nh), **f32)
    dh0 = torch.empty((bsz, nh, hd, n), **f32) if want_dh0 else None
    if min(bsz, s, nh, hd) == 0:
        return (dx.zero_(), ddt.zero_(), torch.zeros(nh, **f32), db.zero_(),
                dc.zero_(), None if dh0 is None else dh0.zero_())
    body, _, nwork = bwd_plan(x, b, c, chunk)
    if body == "tensor-core":
        dy, states = _aligned16(dy), _aligned16(states)
    # scratch of the body (tensor-core: dH per chunk and the head groups'
    # dB / dC shares); da per (row, chunk, head), summed here
    work = torch.empty(nwork, **f32)
    pda = torch.empty((bsz, nc, nh), **f32)
    lib = _build.load()
    rc = lib.rt_ssd_scan_bwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), dy.data_ptr(), states.data_ptr(),
        dh_final.data_ptr() if dh_final is not None else None,
        dx.data_ptr(), ddt.data_ptr(), db.data_ptr(), dc.data_ptr(),
        dh0.data_ptr() if dh0 is not None else None, pda.data_ptr(),
        work.data_ptr(), bsz, s, nh, hd, n, chunk, *strides,
        int(x.dtype == torch.bfloat16), _build.stream_ptr(dev))
    _build.check(rc, name)
    launch_counts[name] += 1
    return dx, ddt, pda.sum((0, 1)), db, dc, dh0


class SsdScanFn(torch.autograd.Function):
    """The SSD scan with a gradient, on the card: the forward kernel with
    the chunk entry states, the backward kernel on the output gradients.
    ``apply(x, dt, a, b, c, chunk, h0)`` -> (y, final state); the final
    state's gradient may be None (``LM.loss`` discards the state), as may
    ``h0``. dx, db and dc come back in the inputs' dtype, ddt, da and dh0
    in fp32."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk: int, h0):
        bsz, s, nh, hd = x.shape
        # from the shapes alone, so a checkpointed layer's recompute saves
        # a tensor of the same shape
        states = torch.empty((bsz, max(1, math.ceil(s / chunk)), nh, hd,
                              b.shape[-1]), dtype=torch.float32,
                             device=x.device)
        y, h = ssd_scan(x, dt, a, b, c, chunk=chunk, h0=h0, states=states)
        ctx.save_for_backward(x, dt, a, b, c, states)
        ctx.chunk, ctx.has_h0 = chunk, h0 is not None
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, a, b, c, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dx, ddt, da, db, dc, dh0 = ssd_scan_bwd(
            x, dt, a, b, c, ctx.chunk, states, dy,
            None if dh is None else dh.contiguous(), want_dh0=ctx.has_h0)
        return dx, ddt, da, db, dc, None, dh0
