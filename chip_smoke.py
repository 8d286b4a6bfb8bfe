#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one NVIDIA card.

    python3 chip_smoke.py                  # all phases, one card
    python3 chip_smoke.py --cpu-rehearsal  # tiny CPU rehearsal, no card

Phases, in order; any failure exits non-zero and nothing is caught:

1. device: require CUDA; print the card, its count and the nvidia-smi name
   and power limit; turn TF32 off for matmuls and cuDNN (fp32 stays fp32);
2. build the hand-written kernels (``src/repro_torch/kernels/csrc``) with
   nvcc and print the build seconds, the ptxas register report and every
   function that spills;
3. kernels vs plain on the card: each of the seven kernels against its
   plain PyTorch version evaluated in fp32 on the same input values (the
   bf16 plain version's own error is logged beside it), at the shapes
   each serving path of phase 5 gives it and at small ragged shapes, in
   bf16
   (atol=5e-3, rtol=2e-2) and fp32 (atol=rtol=1e-4: the kernel sums in
   another order than the plain version's einsum); GQA and MHA, SWA,
   scalar and per-row positions / bases, ragged chunk, sequence and cache
   lengths, dead decode rows, zamba2's head dim 80, the bf16 prefill
   body's tiling edges (g = 1, 4, 8; query tiles of 128 / g cut short;
   key tiles that wrap the ring; pool blocks of 24 tokens; windows
   shorter than a tile; every head dim); the bf16 contiguous decode
   body's edges (positions at a split's first and last key and the key
   after, windows shorter than a tile and across splits, S not a multiple
   of the tile, B = 1, g = 1 / 4 / 8 / 16 at every head dim); the same
   body through the block table (paged decode: block, tile and split
   edges, pool blocks of 16 and 24, windows shorter than a block, g = 1 /
   3 / 4 / 6 / 7 / 8 / 12 / 16 at every head dim); g = 3 / 6 / 7 / 12
   for flash, both chunk kernels and contig decode; the SSD scan's y and
   final state, ragged S, S < Q, one and several chunks, Q 8 / 64 / 128,
   N 16 / 64 / 128 / 256, head dims past one 64-wide slice, an initial
   state, one 8192-token row; the KV sanitizer's probe held to its plain
   version exactly (decode and chunk, paged and contiguous, fp32 and
   bf16, SWA, a dead row, poison as the dtype stores it planted where a
   row reads, which must fire, and where none does, which must not). At
   each kernel's main shape it
   times the kernel, the plain version and, as a yardstick the port never
   calls, ``F.scaled_dot_product_attention`` on the gathered /
   head-repeated K/V (none for the SSD scan and the probe: no single
   PyTorch call computes them), each as the mean of 20 eager calls (``ms``,
   ``plain_ms``, ``library_ms``: the rate the host sustains), the kernel
   and SDPA also as the device time per call of a CUDA graph of 20 calls
   (``device_ms``, ``library_device_ms``: no host launch cost), and
   computes the bound (bytes over 3.35 TB/s vs operations over 989
   TFLOP/s bf16; only the keys each row reaches, each byte once);
   flash at the MoE and hybrid prompts, contig decode at d=80 and the SSD
   scan at zamba2's shape are timed too, and the host time of a flash
   call through ctypes, bf16 (tensor-map encodes) against fp32;
4. engine parity, fp32: reduced configs, one init each, the same requests
   through the Engine on the card (kernels) and on the CPU (plain): paged
   bucketed, direct-to-pool chunked and overcommitted (grow + preempt)
   qwen3-32b, and overcommitted with the sanitizer on (the probe on every
   paged decode and chunk; it must launch, preempt and chunk); contig
   bucketed and contig chunked qwen3-32b; phi3.5-moe and
   granite-moe on their auto (contig) layout with more requests than
   slots; mamba2-1.3b and zamba2-2.7b with SSD chunks of 8 (prompts span
   several), more requests than slots and an equal-length pair batched
   into one group. Greedy tokens and counters must match, every kernel
   must have launched (each recurrent scenario its own), and for MoE the
   smallest gap between the k-th and (k+1)-th router probability is logged
   (a routing flip on a near-tie is then told apart from a bug); then
   bf16: a 2-layer, 256-wide dense model with Qwen3-32B's 64/8 heads of
   128, paged and contig, prompts that run flash and chunk prefill, and
   256-wide mamba2 and zamba2 models with SSD heads of 64 and prompts of
   one to six SSD chunks; each one's prefill and first decode logits on
   the card against the same engine in fp32 on the CPU (every run fed the
   fp32 run's tokens), within 3x the bf16 CPU engine's own error; then
   poison planted in a mapped block of a bf16 paged engine on the card
   (KV_POISON as bf16 stores it, 998,244,352): with the sanitizer the
   next decode step, and mid-prefill the next chunk, must raise
   ``KVSanitizerError``; without it nothing may;
5. six serving paths at full width, bf16, random weights from a seeded
   generator on the card, the same traffic (16 requests of 64-2048 prompt
   tokens, some past ``prefill_chunk=512``, 32 new tokens each,
   ``max_len`` 2080, 8 slots); for each, one untimed warm-up pass, then
   ``--repeats`` timed runs (median wall reported), each on a fresh Engine
   with launch counts zeroed just before and read just after, and the
   kernels that path runs must have launched in each run:
   main   Qwen3-32B widths (d_model 5120, 64/8 heads, head dim 128, d_ff
          25600, vocab 151936), depth ``--layers``, paged layout: paged
          decode, paged chunk, flash;
   sanitize main with ``kv_sanitize=True``: the probe after every paged
          decode and chunk call, read once per dispatch;
   contig the same widths and depth on ``kv_layout="contig"`` (the A/B
          baseline of the paged layout): contig decode, contig chunk,
          flash;
   moe    Phi-3.5-MoE widths (d_model 4096, 32/8 heads, head dim 128, 16
          experts top-2, expert d_ff 6400, vocab 32064), depth
          ``--moe-layers``, auto (contig) layout, batch-1 exact-length
          admission: contig decode, flash;
   ssm    mamba2-1.3b at full width and full depth (48 layers, 64 SSD
          heads of 64, state 128), auto (contig) layout, exact-length
          groups: the SSD scan;
   hybrid zamba2-2.7b at full width and full depth (54 Mamba2 layers, 9
          shared-block applications, 32/32 heads of dim 80), auto (contig)
          layout, exact-length groups: the SSD scan, flash, contig decode.
   Each model's params are freed before the next path is built;
6. a JSON line of per-kernel numbers, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``. A ``[time]`` line follows each
   phase.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import chunk_attention as ca  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import kv_probe as kvp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.serving import Engine, ServeRequest  # noqa: E402
from repro_torch.serving.kv_blocks import (KV_POISON,  # noqa: E402
                                           KVSanitizerError)

PEAK_BYTES = 3.35e12          # H100 SXM HBM3, bytes/s (data sheet)
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense FLOP/s
# (atol, rtol) of a kernel against its plain version evaluated in fp32 on
# the same input values. bf16: the kernel rounds P and the output to bf16,
# about one ulp of the element (2^-7 of it, inside rtol) and well under 5e-3
# elsewhere; one key too many or too few moves an element of an n-key row by
# about |v| / n, past the limit in the short rows every causal case has. The
# bf16 plain version is not the yardstick: it rounds the normalised
# probabilities to bf16 and is itself up to ~2e-2 off in rows of a few keys.
# fp32: the kernel sums in another order than the plain version's einsum.
TOL = {torch.bfloat16: (5e-3, 2e-2), torch.float32: (1e-4, 1e-4)}
QWEN = dict(nh=64, nkv=8, d=128)              # Qwen3-32B attention geometry
PHI = dict(nh=32, nkv=8, d=128)               # Phi-3.5-MoE attention geometry
ZAMBA = dict(nh=32, nkv=32, d=80)             # zamba2-2.7b shared attention
HEAD_DIMS = _build.HEAD_DIMS
G_SWEEP = (1, 3, 4, 6, 7, 8, 12, 16)          # query heads per KV head
# groups that do not divide 128 (the prefill body pads its last rows; the
# decode body pads g to 16): (g, KV heads, head dim, window)
V1_CASES = [(3, 4, 32, None), (6, 2, 128, 50), (7, 2, 64, None),
            (12, 2, 80, None), (12, 1, 16, 50)]
GROUP = 4                     # the Engine's prefill_group: rows per prefill
BS = 16                       # the serving paths' KV block size
MAX_LEN = 2080                # 2048-token prompt + 32 new tokens
MOE = "phi3.5-moe-42b-a6.6b"
# serving paths of phase 5: the config, the Engine's layout and the kernels
# the path must launch; a config's depth flag is DEPTH_FLAG[config], and a
# config without one runs at full depth
PATHS = {
    "main": ("qwen3-32b", "auto",
             ("decode_attention_paged", "chunk_attention_paged",
              "flash_attention")),
    "sanitize": ("qwen3-32b", "auto",
                 ("decode_attention_paged", "chunk_attention_paged",
                  "flash_attention", "kv_probe")),
    "contig": ("qwen3-32b", "contig",
               ("decode_attention", "chunk_attention", "flash_attention")),
    "moe": (MOE, "auto", ("decode_attention", "flash_attention")),
    "ssm": ("mamba2-1.3b", "auto", ("ssd_scan",)),
    "hybrid": ("zamba2-2.7b", "auto",
               ("ssd_scan", "flash_attention", "decode_attention")),
}
# Engine keywords a path adds to the shared ones
PATH_KW = {"sanitize": dict(kv_sanitize=True)}
DEPTH_FLAG = {"qwen3-32b": "layers", MOE: "moe_layers"}
ALL_PHASES = ("build", "kernels", "parity") + tuple(PATHS)


def log(msg: str = "") -> None:
    print(msg, flush=True)


# -- phase 1: device -------------------------------------------------------------
def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "smi": smi_line()}
    log(f"[device] {info['kind']} x{info['count']}; nvidia-smi: "
        f"{info['smi']}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log("[device] TF32 off: torch.backends.cuda.matmul.allow_tf32=False, "
        "torch.backends.cudnn.allow_tf32=False")
    return info


# -- phase 2: build --------------------------------------------------------------
def phase_build() -> None:
    t0 = time.perf_counter()
    lib = _build.load()
    dt = time.perf_counter() - t0
    d = _build.build_dir()
    log(f"[build] {'built' if _build.build_info['built'] else 'loaded'} "
        f"{_build.build_info['path']} in {dt:.1f} s; entry points "
        f"{sorted(n for n in _build.SIGNATURES if getattr(lib, n))}")
    logf = d / "build.log"
    if logf.exists():
        spills, fn = 0, ""
        for line in logf.read_text().splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            fn = m.group(1) if m else fn
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill", line)
            if m and (int(m.group(1)) or int(m.group(2))):
                spills += 1
                log(f"[build] SPILL {fn}: {line.strip()}")
            elif ("Used" in line or "warning" in line.lower()
                  or "Performance Loss" in line):
                log(f"[build] {fn}: {line.strip()}")
        log(f"[build] {spills} functions spill")


# -- timing ----------------------------------------------------------------------
_WARM_STREAM = None


def time_ms(fn, iters: int = 20, warmup: int = 3, graph: bool = False
            ) -> float:
    """Mean time of ``fn`` in ms. On the card: CUDA events around
    ``iters`` eager calls (the rate the host sustains, the lower bound of a
    call in the serving loop), or with ``graph`` around one replay of a
    CUDA graph of ``iters`` calls (the device's time per call, without the
    host's launch cost, which exceeds the device time of a decode call).
    Otherwise the host clock around a loop (rehearsal only)."""
    if not graph or not torch.cuda.is_available():
        for _ in range(warmup):
            fn()
        if not torch.cuda.is_available():
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    global _WARM_STREAM
    if _WARM_STREAM is None:
        # one stream for every warm-up: each new stream that runs a cuBLAS
        # call keeps a workspace allocated for the rest of the process
        _WARM_STREAM = torch.cuda.Stream()
    side = _WARM_STREAM
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm up off the capture stream
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_b = nbytes / PEAK_BYTES
    t_o = flops / PEAK_OPS[dtype]
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


# -- phase 3: kernels vs plain ---------------------------------------------------
class Cases:
    """Random inputs on ``device`` from one seeded generator."""

    def __init__(self, device, seed: int = 0):
        self.dev = device
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def randn(self, *shape, dtype):
        return torch.randn(shape, generator=self.gen, device=self.dev,
                           dtype=torch.float32).to(dtype)

    def randint(self, lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=self.gen,
                             device=self.dev, dtype=torch.int32)

    def pool(self, b, mb, bs, nkv, d, dtype):
        n_blocks = 1 + b * mb
        pk = self.randn(n_blocks, bs, nkv, d, dtype=dtype)
        pv = self.randn(n_blocks, bs, nkv, d, dtype=dtype)
        perm = torch.randperm(b * mb, generator=self.gen, device=self.dev)
        tbl = (perm.reshape(b, mb) + 1).to(torch.int32)
        return pk, pv, tbl


def _visible(qpos: np.ndarray, s_virt: int, window) -> tuple:
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros_like(qpos)
    return np.minimum(qpos, s_virt - 1) - lo + 1, lo


def _kv_bytes(lo, hi, nkv, d, esz, tbl=None, bs=0) -> int:
    """Bytes of K/V that rows reaching keys ``lo[r]..hi[r]`` must read, each
    byte once: a contiguous row its own keys; through a block table each
    distinct pool block once, however many rows or table entries point at
    it (dead rows all point at trash block 0), plus the table entries each
    row reads."""
    if tbl is None:
        return int((hi - lo + 1).sum()) * nkv * d * 2 * esz
    ids = [tbl[r, l // bs:h // bs + 1] for r, (l, h) in enumerate(zip(lo, hi))]
    distinct = len(np.unique(np.concatenate(ids)))
    return distinct * bs * nkv * d * 2 * esz + 4 * sum(map(len, ids))


def decode_work(pos, s, nh, nkv, d, window, esz, tbl=None, bs=0):
    """Bytes and operations of one decode call over ``s`` (virtual) keys
    per row; a pool's when ``tbl`` is given, else a contiguous cache's."""
    pos = np.asarray(pos).astype(np.int64)
    b = pos.shape[0]
    vis, lo = _visible(pos, s, window)
    hi = np.minimum(pos, s - 1)
    nbytes = (2 * b * nh * d * esz + _kv_bytes(lo, hi, nkv, d, esz, tbl, bs)
              + 4 * b)
    return nbytes, 4.0 * nh * d * vis.sum()


def chunk_work(bases, b, c, s, nh, nkv, d, window, esz, tbl=None, bs=0):
    """Each row reads its keys from the first query's window start through
    the last query's position, once each."""
    bases = np.broadcast_to(np.asarray(bases), (b,)).astype(np.int64)
    qpos = bases[:, None] + np.arange(c)[None, :]
    vis, _ = _visible(qpos, s, window)
    lo = np.maximum(0, bases - window + 1) if window else np.zeros(b, int)
    hi = np.minimum(bases + c - 1, s - 1)
    nbytes = (2 * b * c * nh * d * esz
              + _kv_bytes(lo, hi, nkv, d, esz, tbl, bs) + 4 * b)
    return nbytes, 4.0 * nh * d * vis.sum()


def flash_work(b, s, nh, nkv, d, window, esz):
    vis, _ = _visible(np.arange(s), s, window)
    nbytes = (2 * b * s * nh * d + 2 * b * s * nkv * d) * esz
    return nbytes, 4.0 * b * nh * d * vis.sum()


def _sdpa_inputs(q, k, v, mask):
    """(B,S,n,d) -> (B,n,S,d) with K/V heads repeated to the query heads."""
    g = q.shape[2] // k.shape[2]
    tr = lambda x: x.transpose(1, 2).contiguous()  # noqa: E731
    return (tr(q), tr(k.repeat_interleave(g, dim=2)),
            tr(v.repeat_interleave(g, dim=2)), mask)


def check(name, out, ref, dtype, label, plain_err: float) -> float:
    err = (out.float() - ref).abs().max().item()
    atol, rtol = TOL[dtype]
    ok = torch.allclose(out.float(), ref, atol=atol, rtol=rtol)
    finite = bool(torch.isfinite(out.float()).all())
    log(f"[kernels] {name:24s} {label:44s} max_abs_err={err:.3e} "
        f"(plain in {str(dtype)[6:]}: {plain_err:.3e}) atol={atol:g} "
        f"rtol={rtol:g} {'ok' if ok and finite else 'FAIL'}")
    if not (ok and finite):
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain "
                         f"version ({label})")
    return err


def in_fp32(fn):
    """``fn`` evaluated in fp32 on the same input values (integer tables
    and positions as they are)."""
    def run(*args, **kw):
        return fn(*(a.float() if torch.is_tensor(a) and a.is_floating_point()
                    else a for a in args), **kw)
    return run


def compare(name, run, plain, cases, keep=()) -> tuple:
    """Each case ``(label, dtype, args, kw)`` through the kernel, held
    against its plain version evaluated in fp32 on the same input values
    (the error of the plain version in the case's dtype is logged beside
    it); returns the first case's args and error (the main shape, which is
    timed with the default keywords) and the args of the cases whose labels
    are in ``keep`` (timed too)."""
    main, kept = None, {}
    for label, dtype, args, kw in cases:
        ref = in_fp32(plain)(*args, **kw).float()
        plain_err = (plain(*args, **kw).float() - ref).abs().max().item()
        err = check(name, run(*args, **kw), ref, dtype, label, plain_err)
        main = main or (args, err)
        if label in keep:
            kept[label] = args
    return main + (kept,)


def time_both(fn) -> tuple:
    """(eager ms, device ms) of ``fn``: see ``time_ms``."""
    return time_ms(fn), time_ms(fn, graph=True)


def fmt_ms(ms, dev_ms) -> str:
    return "none" if ms is None else f"{ms:.4f} ms (device {dev_ms:.4f})"


def time_shape(name, run, args, library, work, shape, kw=None) -> dict:
    """Time the kernel and its library yardstick at one more shape a
    serving path gives it; the bound comes from ``work``."""
    kw = kw or {}
    ms, dev_ms = time_both(lambda: run(*args, **kw))
    lib_ms, lib_dev_ms = (None, None) if library is None else \
        time_both(library)
    b_ms, b_by = bound(*work, torch.bfloat16)
    log(f"[kernels] {name:24s} kernel {ms:.4f} ms (device {dev_ms:.4f})  "
        f"library {fmt_ms(lib_ms, lib_dev_ms)}  bound {b_ms:.4f} ms "
        f"({b_by})  {shape}")
    return dict(shape=shape, ms=ms, device_ms=dev_ms, library_ms=lib_ms,
                library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by)


def measure(name, module, run, plain, args, err, library, work, shape,
            plain_iters: int = 5, kw=None) -> dict:
    """Time the kernel, its plain version and the library yardstick (None:
    there is no library call) on the main case; the bound comes from
    ``work`` (bytes, operations)."""
    kw = kw or {}
    ms, dev_ms = time_both(lambda: run(*args, **kw))
    plain_ms = time_ms(lambda: plain(*args, **kw), iters=plain_iters,
                       warmup=min(3, plain_iters))
    lib_ms, lib_dev_ms = (None, None) if library is None else \
        time_both(library)
    b_ms, b_by = bound(*work, torch.bfloat16)
    return dict(name=name, route="cuda", source=module.SOURCE,
                replaces=module.REPLACES[name], max_abs_err=err, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                library_device_ms=lib_dev_ms, shape=shape)


def kv_inputs(cs, paged, b, s, nkv, d, bs, dtype) -> tuple:
    """K/V of ``b`` rows of ``s`` positions: a shuffled block pool of
    ``bs``-token blocks and its table (``s`` rounded up to whole blocks),
    or a contiguous cache. Returns (the kernel's K/V arguments, s)."""
    if paged:
        pk, pv, tbl = cs.pool(b, -(-s // bs), bs, nkv, d, dtype)
        return (pk, pv, tbl), tbl.shape[1] * bs
    return (cs.randn(b, s, nkv, d, dtype=dtype),
            cs.randn(b, s, nkv, d, dtype=dtype)), s


def dense_kv(kv_args, b) -> tuple:
    """Each row's K/V as (b, s, nkv, d), gathered through the table of a
    pool; for the library yardstick."""
    if len(kv_args) == 2:
        return kv_args
    pk, pv, tbl = kv_args
    return tuple(x[tbl.long()].reshape(b, -1, *x.shape[2:]) for x in (pk, pv))


def _geometry(geo: dict, rehearsal: bool) -> tuple:
    return (4, 2, 16) if rehearsal else (geo["nh"], geo["nkv"], geo["d"])


def kernel_decode(cs, dev, rehearsal, paged: bool) -> dict:
    """Decode attention against 8 rows of ``max_len`` 2080 with ragged
    positions and one dead row (paged: on the trash table; contiguous:
    frozen one past the end of its row, where the kernel clamps its reach).
    Paged (kernel 1) at the main path's Qwen3-32B heads; contiguous (kernel
    4) at Phi-3.5-MoE's 32/8 heads (MoE path, timed), Qwen3-32B's 64/8
    (contig path) and zamba2's 32/32 of dim 80 (hybrid path)."""
    name = "decode_attention_paged" if paged else "decode_attention"
    plain = getattr(da, name + "_plain")
    run = in_fp32(plain) if rehearsal else getattr(da, name)
    bf, f32 = torch.bfloat16, torch.float32
    geos = [QWEN] if paged else [PHI, QWEN, ZAMBA]
    B, S = 8, (64 if rehearsal else MAX_LEN)
    nh, nkv, d = _geometry(geos[0], rehearsal)
    specs = [(bf, (*_geometry(g, rehearsal), B, S, BS), None, True,
              f"main GQA {g['nh']}/{g['nkv']} bf16") for g in geos] + [
        (bf, (nh, nkv, d, B, S, BS), 256, True, "main SWA=256 bf16"),
        (bf, (4, 2, 16, 3, 37, 8), None, True, "GQA 4/2 d16 S=37 bf16"),
        (f32, (4, 2, 16, 3, 37, 8), None, True, "GQA 4/2 d16 S=37 fp32"),
        (f32, (4, 4, 32, 3, 40, 8), 8, False, "MHA d32 SWA=8 scalar pos fp32"),
        (f32, (8, 2, 64, 2, 300, 16), None, True, "GQA 8/2 d64 S=300 fp32"),
        (bf, (4, 4, 80, 3, 37, 8), None, True, "MHA d80 S=37 bf16"),
        (f32, (4, 4, 80, 3, 37, 8), None, True, "MHA d80 S=37 fp32")]
    if paged and not rehearsal:
        # the bf16 body through the block table (kernel 1 runs the contig
        # body's split walk with a paged key policy): positions at 0, at a
        # block's last key and the next (15 / 16, 23 / 24), at a tile's
        # (63 / 64 / 65) and a split's (1535 / 1536, 192-key splits when a
        # row is cut into 9) edges, the row's last key and one past it on
        # the trash table (the frozen dead row: the last row of every
        # case); pool blocks of 16 and 24 (a block straddles a 64-key
        # tile); windows shorter than a block and across splits; B = 1;
        # g = 1 / 3 / 4 / 6 / 7 / 8 / 12 / 16 at every head dim; g = 32
        # (the FP32-pipe body)
        e16 = [0, 15, 16, 63, 64, 65, 1535, 1536, MAX_LEN - 1, MAX_LEN]
        e24 = [0, 23, 24, 63, 64, 1535, 1536, 2087, 2088]   # S = 2088
        specs += [
            (bf, (32, 8, 128, len(e16), MAX_LEN, 16), None, e16,
             "g=4 block/tile/split edges + dead row bf16"),
            (bf, (32, 8, 128, len(e24), MAX_LEN, 24), None, e24,
             "g=4 blocks of 24 edges + dead row bf16"),
            (bf, (32, 8, 128, len(e16), MAX_LEN, 16), 8, e16,
             "g=4 SWA=8 < block bf16"),
            (bf, (32, 8, 128, len(e24), MAX_LEN, 24), 20, e24,
             "g=4 SWA=20 < block of 24 bf16"),
            (bf, (32, 8, 128, len(e16), MAX_LEN, 16), 300, e16,
             "g=4 SWA=300 across splits bf16"),
            (bf, (64, 8, 128, 1, 1000, BS), None, [999],
             "B=1 g=8 S=1000 bf16"),
            (bf, (32, 1, 16, 3, 200, BS), None, True,
             "g=32 d16 (FP32-pipe body) bf16")]
        specs += [
            (bf, (2 * g, 2, dd, 3, 300, (16, 24)[i % 2]), None, True,
             f"g={g} d{dd} blocks of {(16, 24)[i % 2]} bf16")
            for i, (dd, g) in enumerate(
                (dd, g) for dd in HEAD_DIMS for g in G_SWEEP)]
    if not paged and not rehearsal:
        # the bf16 contiguous body's edges: positions at 0, at a split's
        # last key, its first and the key after (64-key splits for short
        # rows; 192-key splits at 1535 / 1536 when a row is cut into 9),
        # the end of the row and the frozen dead row; windows shorter than
        # a tile and across splits; S not a multiple of the 64-key tile;
        # B = 1; g = 1 / 4 / 8 / 16 at every head dim; g = 32 (the
        # FP32-pipe body)
        edge = [0, 63, 64, 65, 1535, 1536, MAX_LEN - 1, MAX_LEN]
        specs += [
            (bf, (32, 8, 128, 8, MAX_LEN, BS), None, edge,
             "g=4 split edges + dead row bf16"),
            (bf, (32, 8, 128, 8, MAX_LEN, BS), 20, edge, "g=4 SWA=20 bf16"),
            (bf, (32, 8, 128, 8, MAX_LEN, BS), 300, edge,
             "g=4 SWA=300 across splits bf16"),
            (bf, (64, 8, 128, 1, 1000, BS), None, [999],
             "B=1 g=8 S=1000 bf16"),
            (bf, (16, 2, 64, 3, 1000, BS), None, [0, 640, 1000],
             "g=8 d64 S=1000 bf16"),
            (bf, (8, 8, 16, 3, 300, BS), None, True, "g=1 d16 bf16"),
            (bf, (16, 4, 32, 3, 300, BS), 40, True, "g=4 d32 SWA=40 bf16"),
            (bf, (32, 32, 80, 4, 700, BS), None, [0, 64, 699, 700],
             "g=1 d80 bf16"),
            (bf, (8, 2, 80, 3, 300, BS), None, True, "g=4 d80 bf16"),
            (bf, (32, 4, 128, 3, 500, BS), None, True, "g=8 d128 bf16"),
            (bf, (32, 2, 64, 3, 500, BS), None, True, "g=16 d64 bf16"),
            (bf, (32, 1, 16, 3, 200, BS), None, True,
             "g=32 d16 (FP32-pipe body) bf16")] + [
            (bf, (g * kv, kv, dd, 3, 400, BS), win, True,
             f"g={g} d{dd}{' SWA=50' if win else ''} bf16")
            for g, kv, dd, win in V1_CASES]

    def cases():
        for dtype, (h, kv, dd, b, s, bs), win, vec, label in specs:
            kvs, s = kv_inputs(cs, paged, b, s, kv, dd, bs, dtype)
            q = cs.randn(b, 1, h, dd, dtype=dtype)
            if isinstance(vec, list):       # explicit positions, row by row
                pos = torch.tensor(vec, dtype=torch.int32, device=dev)
            else:
                pos = cs.randint(0, s, (b,)) if vec else s - 3
            if paged:
                kvs[2][-1] = 0          # a dead row: trash table, frozen pos
            elif vec is True:
                pos[-1] = s             # a dead row, frozen past its row's end
            yield label, dtype, (q, *kvs, pos), dict(window=win)
    zlabel = f"main GQA {ZAMBA['nh']}/{ZAMBA['nkv']} bf16"
    args, err, kept = compare(name, run, plain, cases(),
                              keep=() if paged else (zlabel,))
    row = measure(name, da, run, plain, args, err,
                  *decode_yardstick(args, B, dev, nh, nkv, d, paged))
    if zlabel in kept:                  # the hybrid path's d=80 heads
        z = _geometry(ZAMBA, rehearsal)
        row["timed_shapes"] = [time_shape(
            name, run, kept[zlabel],
            *decode_yardstick(kept[zlabel], B, dev, *z, paged))]
    return row


def decode_yardstick(args, b, dev, nh, nkv, d, paged) -> tuple:
    """SDPA on the gathered K/V with the positions' mask, the bytes and
    operations of the call, and its shape label."""
    q, pos = args[0], args[-1]
    k, v = dense_kv(args[1:-1], b)
    s = k.shape[1]
    mask = (torch.arange(s, device=dev)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    sq, sk, sv, sm = _sdpa_inputs(q, k, v, mask)
    tbl = args[3].cpu().numpy() if paged else None
    work = decode_work(pos.cpu().numpy(), s, nh, nkv, d, None, 2, tbl, BS)
    kv_shape = (f"pool=({args[1].shape[0]},{BS},{nkv},{d}) tbl=({b},"
                f"{tbl.shape[1]})" if paged else f"cache=({b},{s},{nkv},{d})")
    return (lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=sm),
            work, f"q=({b},1,{nh},{d}) {kv_shape} ragged pos, one dead row "
            f"bf16")


def kernel_chunk(cs, dev, rehearsal, paged: bool) -> dict:
    """Chunk attention of Qwen3-32B's 512-token chunk at base 1024 against
    4 rows of ``max_len`` 2080: paged (kernel 2, main path) or contiguous
    (kernel 5, the contig path's transient group cache)."""
    name = "chunk_attention_paged" if paged else "chunk_attention"
    plain = getattr(ca, name + "_plain")
    run = in_fp32(plain) if rehearsal else getattr(ca, name)
    bf, f32 = torch.bfloat16, torch.float32
    nh, nkv, d = _geometry(QWEN, rehearsal)
    B, S, C = (4, 64, 16) if rehearsal else (4, MAX_LEN, 512)
    base = 2 * C
    specs = [
        (bf, (nh, nkv, d, B, C, S, BS), base, None,
         "main GQA scalar base bf16"),
        (bf, (nh, nkv, d, B, C, S, BS), "rows", None,
         "main GQA per-row bases bf16"),
        (bf, (nh, nkv, d, B, 11 if rehearsal else 300, S, BS), "rows", 256,
         "ragged C, SWA=256, per-row bf16"),
        (bf, (4, 2, 16, 2, 13, 37, 8), 20, None, "GQA 4/2 d16 C=13 S=37 bf16"),
        (f32, (4, 2, 16, 2, 13, 37, 8), 20, None,
         "GQA 4/2 d16 C=13 S=37 fp32"),
        (f32, (4, 4, 32, 2, 16, 64, 8), "rows", 8,
         "MHA d32 SWA=8 per-row fp32"),
        (f32, (8, 2, 64, 2, 24, 100, 16), 40, None,
         "GQA 8/2 d64 S=100 fp32")]
    # the bf16 body's tiling edges: 128 / g query positions per CTA (C not
    # a multiple of it), key tiles of 128 that wrap the ring and end mid
    # tile, pool blocks of 24 tokens that straddle a tile, windows shorter
    # than a tile, a row at base 0 (no earlier key), every head dim
    specs += [
        (bf, (16, 2, 128, 2, c, 1100, BS), "rows0", None,
         f"g=8 C={c} base 0 + per-row bf16") for c in (13, 300, 511)] + [
        (bf, (16, 2, 64, 2, 200, 700, 24), "rows0", None,
         "g=8 d64 blocks of 24 straddle tiles bf16"),
        (bf, (16, 2, 128, 2, 300, 900, BS), "rows", 40,
         "g=8 SWA=40 < tile bf16"),
        (bf, (8, 2, 32, 2, 77, 400, BS), "rows0", None, "g=4 d32 bf16"),
        (bf, (4, 4, 80, 2, 150, 500, BS), "rows0", None, "g=1 d80 bf16"),
        (bf, (4, 1, 16, 2, 45, 300, 8), "rows0", 20, "g=4 d16 SWA=20 bf16")]
    specs += [
        (bf, (g * kv, kv, dd, 2, 77, 500, (16, 24)[i % 2]), "rows0", win,
         f"g={g} d{dd} C=77{' SWA=50' if win else ''} bf16")
        for i, (g, kv, dd, win) in enumerate(V1_CASES)]

    def cases():
        for dtype, (h, kv, dd, b, c, s, bs), bases, win, label in specs:
            kvs, s = kv_inputs(cs, paged, b, s, kv, dd, bs, dtype)
            q = cs.randn(b, c, h, dd, dtype=dtype)
            if bases in ("rows", "rows0"):
                zero = bases == "rows0"
                bases = cs.randint(0, s - c + 1, (b,))
                if zero:
                    bases[0] = 0
            yield label, dtype, (q, *kvs, bases), dict(window=win)
    args, err, _ = compare(name, run, plain, cases())
    # timed with the scalar base as a (B,) device tensor: the wrapper would
    # copy a Python int to the card on every call, a copy that waits for
    # the stream and would put the host's time into the kernel's
    args = (*args[:-1], torch.full((B,), base, dtype=torch.int32,
                                   device=dev))
    q = args[0]
    k, v = dense_kv(args[1:-1], B)
    s = k.shape[1]
    qpos = base + torch.arange(C, device=dev)
    mask = (torch.arange(s, device=dev)[None, :] <= qpos[:, None])[None, None]
    sq, sk, sv, sm = _sdpa_inputs(q, k, v, mask)
    tbl = args[3].cpu().numpy() if paged else None
    work = chunk_work(base, B, C, s, nh, nkv, d, None, 2, tbl, BS)
    kv_shape = (f"pool=({args[1].shape[0]},{BS},{nkv},{d})" if paged
                else f"cache=({B},{s},{nkv},{d})")
    return measure(name, ca, run, plain, args, err,
                   lambda: F.scaled_dot_product_attention(sq, sk, sv,
                                                          attn_mask=sm),
                   work, f"q=({B},{C},{nh},{d}) base={base} {kv_shape} bf16",
                   plain_iters=3)


def kernel_flash(cs, dev, rehearsal) -> dict:
    """Causal prefill attention: the dense paths' 4-prompt group at the
    512-token bucket (Qwen3-32B heads, timed), the MoE path's batch-1
    exact-length prompts at Phi-3.5-MoE's 32/8 heads (2048 and 1281
    tokens, the workload's longest two), and the hybrid path's exact-length
    groups of 4 rows at zamba2's 32/32 heads of dim 80 (2048 tokens)."""
    plain = fa.flash_attention_plain
    run = in_fp32(plain) if rehearsal else fa.flash_attention
    bf, f32 = torch.bfloat16, torch.float32
    nh, nkv, d = _geometry(QWEN, rehearsal)
    B, S = (4, 32) if rehearsal else (4, 512)
    n1, n2, n3 = (40, 23, 19) if rehearsal else (2048, 1281, 300)
    specs = [
        (bf, (nh, nkv, d, B, S), True, None, "main GQA causal bf16"),
        (bf, (*_geometry(PHI, rehearsal), 1, n1), True, None,
         f"MoE prompt 32/8 S={n1} bf16"),
        (bf, (*_geometry(PHI, rehearsal), 1, n2), True, None,
         f"MoE prompt 32/8 S={n2} bf16"),
        (bf, (*_geometry(ZAMBA, rehearsal), GROUP, n1), True, None,
         f"zamba2 group 32/32 d80 S={n1} bf16"),
        (bf, (4, 4, 80, 2, 77), True, None, "MHA d80 S=77 bf16"),
        (f32, (4, 4, 80, 2, 77), True, None, "MHA d80 S=77 fp32"),
        (bf, (nh, nkv, d, 2, n3), True, 128, "ragged S, SWA=128 bf16"),
        (bf, (4, 2, 16, 2, 37), True, None, "GQA 4/2 d16 S=37 bf16"),
        (f32, (4, 2, 16, 2, 37), True, None, "GQA 4/2 d16 S=37 fp32"),
        (f32, (4, 4, 32, 2, 40), True, 8, "MHA d32 SWA=8 fp32"),
        (f32, (8, 2, 64, 1, 70), False, None, "GQA 8/2 d64 non-causal fp32")]
    # the bf16 body's tiling edges: 128 / g query positions per CTA (S not
    # a multiple of it), windows shorter than a key tile, every head dim
    specs += [
        (bf, (16, 2, 128, 2, n), True, None, f"g=8 S={n} bf16")
        for n in (13, 300, 511)] + [
        (bf, (16, 2, 64, 1, 700), True, 16, "g=8 d64 SWA=16 bf16"),
        (bf, (8, 8, 64, 2, 400), True, 100, "g=1 d64 SWA=100 bf16"),
        (bf, (8, 2, 32, 2, 333), True, None, "g=4 d32 bf16"),
        (bf, (8, 2, 64, 1, 170), False, 64,
         "g=4 d64 non-causal SWA=64 bf16"),
        (bf, (4, 4, 16, 2, 200), False, None, "g=1 d16 non-causal bf16")]
    specs += [(bf, (g * kv, kv, dd, 2, 300), True, win,
               f"g={g} d{dd} S=300{' SWA=50' if win else ''} bf16")
              for g, kv, dd, win in V1_CASES]

    def cases():
        for dtype, (h, kv, dd, b, s), causal, win, label in specs:
            q = cs.randn(b, s, h, dd, dtype=dtype)
            k = cs.randn(b, s, kv, dd, dtype=dtype)
            v = cs.randn(b, s, kv, dd, dtype=dtype)
            yield label, dtype, (q, k, v), dict(causal=causal, window=win)
    moe, zamba = specs[1][4], specs[3][4]
    args, err, kept = compare("flash_attention", run, plain, cases(),
                              keep=(moe, zamba))
    row = measure("flash_attention", fa, run, plain, args, err,
                  *flash_yardstick(args))
    # the MoE path's batch-1 prompt and the hybrid path's d=80 group
    row["timed_shapes"] = [time_shape("flash_attention", run, kept[k],
                                      *flash_yardstick(kept[k]))
                           for k in (moe, zamba)]
    if not rehearsal:
        row["host_us"] = launch_host_us(cs)
    return row


def launch_host_us(cs, n: int = 500) -> dict:
    """Host microseconds per call of the flash entry point at a tiny
    shape: bf16 (two tensor-map encodes, then the launch) against fp32
    (the launch alone), straight through ctypes."""
    lib = _build.load()
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = cs.randn(1, 16, 8, 128, dtype=dtype)
        k = cs.randn(1, 16, 8, 128, dtype=dtype)
        o = torch.empty_like(q)
        stream = _build.stream_ptr(q.device)
        args = (q.data_ptr(), k.data_ptr(), k.data_ptr(), o.data_ptr(), 1,
                16, 16, 8, 8, 128, 1, 0, 0.088, int(dtype == torch.bfloat16),
                stream)
        lib.rt_flash_attention(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            lib.rt_flash_attention(*args)
        out[str(dtype)[6:]] = (time.perf_counter() - t0) * 1e6 / n
        torch.cuda.synchronize()
    log(f"[kernels] flash_attention host us per call (ctypes, tiny shape): "
        f"bf16 {out['bfloat16']:.2f} (two tensor-map encodes + launch), "
        f"fp32 {out['float32']:.2f} (launch)")
    return out


def flash_yardstick(args) -> tuple:
    """Causal SDPA on head-repeated K/V, the bytes and operations of the
    call, and its shape label."""
    q, k = args[0], args[1]
    (b, s, nh, d), nkv = q.shape, k.shape[2]
    sq, sk, sv, _ = _sdpa_inputs(*args, None)
    return (lambda: F.scaled_dot_product_attention(sq, sk, sv,
                                                   is_causal=True),
            flash_work(b, s, nh, nkv, d, None, 2),
            f"q=({b},{s},{nh},{d}) k/v=({b},{s},{nkv},{d}) causal bf16")


def kernel_probe(cs, dev, rehearsal) -> dict:
    """The KV sanitizer's probe (kernel 7) against its plain version,
    exactly (a maximum of absolute values does not round): decode (one
    column at ``pos``) and chunk (512 columns at base 1024; per-row
    columns, as the engine gives them), paged and contiguous, bf16 and
    fp32, SWA, a dead row on the trash table, poison (as the dtype stores
    it) planted in a block one row reads, and beyond every row's horizon.
    Timed at the sanitize path's paged decode shape (that of kernel 1)."""
    name = "kv_probe"
    plain = kvp.kv_probe_plain
    run = plain if rehearsal else kvp.kv_probe
    bf, f32 = torch.bfloat16, torch.float32
    nh, nkv, d = _geometry(QWEN, rehearsal)
    B, S, C = (4, 64, 16) if rehearsal else (8, MAX_LEN, 512)
    # (dtype, paged, (nh, nkv, d, b, s, bs), columns, window, poison, label)
    specs = [
        (bf, True, (nh, nkv, d, B, S, BS), 1, None, None,
         "main: decode paged, ragged pos, dead row bf16"),
        (bf, True, (nh, nkv, d, 4, S, BS), C, None, None,
         "chunk paged C=512 per-row bases bf16"),
        (bf, True, (nh, nkv, d, 4, S, BS), C, None, "cols",
         "chunk paged per-row columns bf16"),
        (bf, False, (nh, nkv, d, B, S, BS), 1, None, None,
         "decode contig bf16"),
        (bf, False, (nh, nkv, d, 4, S, BS), C, 256, None,
         "chunk contig SWA=256 bf16"),
        (bf, True, (nh, nkv, d, B, S, BS), 1, 100, "hot",
         "decode paged SWA=100 poison read bf16"),
        (bf, True, (nh, nkv, d, B, S, BS), 1, None, "cold",
         "decode paged poison unread bf16"),
        (bf, True, (nh, nkv, d, 4, S, 24), C, None, "hot",
         "chunk paged blocks of 24 poison read bf16"),
        (bf, False, (nh, nkv, d, 4, S, BS), C, None, "cold",
         "chunk contig poison unread bf16"),
        (f32, True, (8, 2, 64, 3, 300, 16), 1, None, "hot",
         "decode paged poison read fp32"),
        (f32, True, (8, 2, 64, 3, 300, 8), 24, 40, "cold",
         "chunk paged SWA=40 poison unread fp32"),
        (f32, False, (4, 4, 80, 3, 300, 16), 13, None, "hot",
         "chunk contig d80 poison read fp32")]
    main = None
    for dtype, paged, (h, kv, dd, b, s, bs), c, win, poison, label in specs:
        kvs, s = kv_inputs(cs, paged, b, s, kv, dd, bs, dtype)
        pk, pv = kvs[0], kvs[1]
        tbl = kvs[2] if paged else None
        # "cold": no row reaches its last block (or last bs positions)
        reach = s - c - bs if poison == "cold" else s - c
        bases = cs.randint(0, reach + 1, (b,))
        if paged:
            tbl[-1] = 0                     # a dead row: trash table
        if c == 1:
            bases[-1] = s                   # frozen one past its last key
        cols = cs.randint(0, c + 1, (b,)) if poison == "cols" else None
        stored = torch.tensor(KV_POISON, dtype=dtype).item()
        if poison == "hot":                 # the position row 0 reads last
            t = bases[0].item() + c - 1
            if paged:
                pv[tbl[0, t // bs].long()] = stored
            else:
                pk[0, t] = -stored
        elif poison == "cold":              # every live row's last block
            if paged:
                pv[tbl[:-1, -1].long()] = stored
            else:
                pk[:b - 1 if c == 1 else b, s - 1] = -stored
        args = (pk, pv, tbl, bases, c, h)
        kw = dict(window=win, cols=cols)
        ref = plain(*args, **kw)
        out = run(*args, **kw)
        exact = out.shape == ref.shape and torch.equal(out, ref)
        top = out.max().item()
        fired = top >= stored
        ok = exact and fired == (poison == "hot")
        log(f"[kernels] {name:24s} {label:44s} exact={exact} max={top:.9g} "
            f"poison as stored={stored:.9g} fired={fired} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: {name} disagrees with its plain "
                             f"version or the poison check ({label})")
        main = main or (args, kw)
    args, kw = main
    pk, tbl, pos = args[0], args[2], args[3]
    work = probe_work(pos.cpu().numpy(), 1, pk.shape[1] * tbl.shape[1], nh,
                      nkv, d, None, 2, tbl.cpu().numpy(), BS)
    return measure(name, kvp, run, plain, args, 0.0, None, work,
                   f"pool=({pk.shape[0]},{BS},{nkv},{d}) tbl=({B},"
                   f"{tbl.shape[1]}) nh={nh} decode (c=1) ragged pos, one "
                   f"dead row bf16", kw=kw)


def probe_work(bases, c, s, nh, nkv, d, window, esz, tbl=None,
               bs=0) -> tuple:
    """Bytes and operations of one probe: the K/V bytes each row may read
    (each distinct block once, and the table entries), the bases and the
    (B, nh) fp32 output; two operations (|x|, max) per byte pair read."""
    bases = np.asarray(bases).astype(np.int64)
    lo = np.maximum(0, bases - window + 1) if window else np.zeros_like(
        bases)
    hi = np.minimum(bases + c - 1, s - 1)
    kv = _kv_bytes(lo, hi, nkv, d, esz, tbl, bs)
    b = len(bases)
    return kv + 4 * b + 4 * b * nh, 2.0 * kv / esz


def ssd_inputs(cs, b, s, nh, hd, n, dtype, init: bool) -> tuple:
    """SSD scan arguments as the model gives them: x, B and C strided views
    of one conv output, dt > 0 and a < 0 in fp32; an initial state when
    ``init``."""
    xbc = cs.randn(b, s, nh * hd + 2 * n, dtype=dtype) * 0.5
    x = xbc[..., :nh * hd].reshape(b, s, nh, hd)
    bm, cm = xbc[..., nh * hd:nh * hd + n], xbc[..., nh * hd + n:]
    dt = cs.randn(b, s, nh, dtype=torch.float32).abs() * 0.1 + 0.01
    a = -cs.randn(nh, dtype=torch.float32).abs() - 0.1
    h0 = (cs.randn(b, nh, hd, n, dtype=torch.float32) * 0.2 if init
          else None)
    return (x, dt, a, bm, cm), h0


def ssd_work(b, s, nh, hd, n, q, esz) -> tuple:
    """Bytes and operations of one SSD scan: x, y, B, C, dt, a and the final
    state moved once each; C B^T once per (row, chunk), shared by the heads
    as the kernel computes it (2 q^2 N), and per (row, head, chunk) the
    masked product, the carried state's contribution and the state update
    (2 q^2 hd + 4 q N hd), q the chunk's real length."""
    qs = [min(q, s - t) for t in range(0, s, q)]
    nbytes = (2 * b * s * nh * hd * esz + 2 * b * s * n * esz
              + 4 * (b * s * nh + nh + b * nh * hd * n))
    flops = sum(b * 2 * c * c * n + b * nh * (2 * c * c * hd + 4 * c * n * hd)
                for c in qs)
    return nbytes, float(flops)


def kernel_ssd(cs, dev, rehearsal) -> dict:
    """The Mamba2 SSD scan (kernel 6): y and the final state, at the shapes
    the ssm path (mamba2-1.3b: 64 heads of 64, N 128) and the hybrid path
    (zamba2-2.7b: 80 heads of 64, N 64) give it — exact-length groups of 4
    rows at the workload's longest prompt (2048, timed for mamba2) and a
    ragged one (1281), Q 128 — and one 2048-token row; and at small ragged
    shapes (S=37 and 100 with Q=64: one chunk and several, B > 1, an
    initial state) in bf16 and fp32."""
    name = "ssd_scan"
    plain = ssd.ssd_scan_plain
    run = in_fp32(plain) if rehearsal else ssd.ssd_scan
    bf, f32 = torch.bfloat16, torch.float32
    # (heads, head dim, state, chunk) of mamba2-1.3b and zamba2-2.7b
    m2 = (8, 16, 16, 16) if rehearsal else (64, 64, 128, 128)
    zb = (8, 16, 16, 16) if rehearsal else (80, 64, 64, 128)
    s1, s2 = (40, 23) if rehearsal else (2048, 1281)
    specs = [
        (bf, (GROUP, s1, *m2), False, f"main mamba2 group S={s1} bf16"),
        (bf, (1, s1, *m2), False, f"mamba2 one row S={s1} bf16"),
        (bf, (GROUP, s1, *zb), False, f"zamba2 group S={s1} bf16"),
        (bf, (GROUP, s2, *zb), False, f"zamba2 group ragged S={s2} bf16"),
        (bf, (2, 37, 4, 16, 16, 64), False, "S=37 Q=64 one chunk bf16"),
        (f32, (2, 37, 4, 16, 16, 64), False, "S=37 Q=64 one chunk fp32"),
        (bf, (3, 100, 4, 32, 32, 64), True, "S=100 Q=64 h0 bf16"),
        (f32, (3, 100, 4, 32, 32, 64), True, "S=100 Q=64 h0 fp32"),
        (f32, (2, 100, 8, 64, 128, 64), False, "N=128 S=100 Q=64 fp32")]
    if not rehearsal:
        # the bf16 tensor-core body's edges: S < Q, S not a multiple of Q,
        # Q 8 / 64 / 128, N 16 / 64 / 128 / 256 (one shared-memory buffer
        # at 256), head dims past one 64-wide slice and below it, an
        # initial state, one long row (64 chunks of carried state), and
        # N = 20 (not a multiple of 8: the FP32-pipe body)
        specs += [
            (bf, (2, 50, 4, 64, 64, 128), False, "S=50 < Q=128 bf16"),
            (bf, (2, 300, 4, 64, 128, 128), True, "S=300 N=128 h0 bf16"),
            (bf, (2, 200, 4, 64, 16, 64), False, "N=16 Q=64 bf16"),
            (bf, (1, 300, 2, 64, 256, 128), True, "N=256 h0 bf16"),
            (bf, (2, 150, 3, 80, 64, 64), True, "hd=80 (64 + 16) h0 bf16"),
            (bf, (2, 45, 4, 64, 64, 8), False, "Q=8 bf16"),
            (bf, (1, 8192, 8, 64, 128, 128), False, "long row S=8192 bf16"),
            (bf, (1, 40, 2, 16, 20, 16), False,
             "N=20 (FP32-pipe body) bf16")]
    main = kept = None
    for dtype, (b, s, nh, hd, n, q), init, label in specs:
        args, h0 = ssd_inputs(cs, b, s, nh, hd, n, dtype, init)
        kw = dict(chunk=q, h0=h0)
        ref = [t.float() for t in in_fp32(plain)(*args, **kw)]
        plain_out = plain(*args, **kw)
        errs = []
        for out, r, p_out, part in zip(run(*args, **kw), ref, plain_out,
                                       ("y", "h")):
            p_err = (p_out.float() - r).abs().max().item()
            errs.append(check(name, out, r, dtype, f"{label} {part}", p_err))
        main = main or (args, kw, max(errs), (b, s, nh, hd, n, q))
        if label == specs[2][3]:        # the hybrid path's zamba2 group
            kept = (args, kw, (b, s, nh, hd, n, q))
    args, kw, err, (b, s, nh, hd, n, q) = main
    row = measure(name, ssd, run, plain, args, err, None,
                  ssd_work(b, s, nh, hd, n, q, 2), ssd_shape(b, s, nh, hd, n,
                                                             q),
                  plain_iters=3, kw=kw)
    args, kw, shp = kept
    row["timed_shapes"] = [time_shape(name, run, args, None,
                                      ssd_work(*shp, 2), ssd_shape(*shp),
                                      kw=kw)]
    return row


def ssd_shape(b, s, nh, hd, n, q) -> str:
    return (f"x=({b},{s},{nh},{hd}) b/c=({b},{s},{n}) Q={q} strided views "
            f"bf16")


def phase_kernels(dev, rehearsal: bool) -> list:
    cs = Cases(dev)
    rows = [kernel_decode(cs, dev, rehearsal, paged=True),
            kernel_chunk(cs, dev, rehearsal, paged=True),
            kernel_flash(cs, dev, rehearsal),
            kernel_decode(cs, dev, rehearsal, paged=False),
            kernel_chunk(cs, dev, rehearsal, paged=False),
            kernel_ssd(cs, dev, rehearsal),
            kernel_probe(cs, dev, rehearsal)]
    for r in rows:
        lib = fmt_ms(r["library_ms"], r["library_device_ms"])
        log(f"[kernels] {r['name']:24s} kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f})  plain "
            f"{r['plain_ms']:.4f} ms  library {lib}  bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})  {r['shape']}")
    return rows


# -- phase 4: engine parity (fp32, card vs CPU) ----------------------------------
def _requests(specs, vocab, seed):
    rng = np.random.RandomState(seed)
    return [ServeRequest(prompt=rng.randint(0, vocab, n).tolist(),
                         max_new_tokens=m) for n, m in specs]


_BUCKETED = [(5, 8), (12, 6), (27, 9), (33, 4), (9, 7)]
_CHUNKED = [(40, 6), (17, 5), (3, 12), (29, 8)]
_MOE = [(5, 8), (12, 6), (27, 9), (9, 7), (20, 5)]
# the first admission on 3 slots groups the two 12-token prompts
_RECURRENT = [(5, 8), (12, 6), (12, 9), (27, 4), (9, 7)]
_SSD = dict(max_batch=3, max_len=64, model_kw={"ssd_chunk": 8})
PARITY = [
    ("bucketed", "qwen3-32b", dict(max_batch=4, max_len=64), _BUCKETED),
    ("chunked", "qwen3-32b", dict(max_batch=4, max_len=64, prefill_chunk=8),
     _CHUNKED),
    ("overcommit", "qwen3-32b",
     dict(max_batch=4, max_len=64, block_size=8, n_blocks=11,
          kv_overcommit=2.5, prefill_chunk=8),
     [(9, 20), (11, 20), (13, 20)]),
    # the sanitizer on (the device probe armed), overcommitted so that it
    # preempts and re-attaches, more requests than slots, chunked prompts
    # admitted into released (poisoned) blocks
    ("sanitized", "qwen3-32b",
     dict(max_batch=4, max_len=64, block_size=8, n_blocks=11,
          kv_overcommit=2.5, prefill_chunk=8, kv_sanitize=True),
     [(9, 20), (11, 20), (13, 20), (30, 6), (5, 9), (41, 4)]),
    ("contig", "qwen3-32b", dict(max_batch=4, max_len=64,
                                 kv_layout="contig"), _BUCKETED),
    ("contig_chunked", "qwen3-32b",
     dict(max_batch=4, max_len=64, kv_layout="contig", prefill_chunk=8),
     _CHUNKED),
    ("moe_phi", MOE, dict(max_batch=2, max_len=64), _MOE),
    ("moe_granite", "granite-moe-3b-a800m", dict(max_batch=2, max_len=64),
     _MOE),
    ("mamba2", "mamba2-1.3b", _SSD, _RECURRENT),
    ("zamba2", "zamba2-2.7b", _SSD, _RECURRENT),
]
# kernels a scenario's card run must launch itself
PARITY_REQUIRED = {"sanitized": ("kv_probe", "decode_attention_paged",
                                 "chunk_attention_paged"),
                   "mamba2": ("ssd_scan",),
                   "zamba2": ("ssd_scan", "flash_attention",
                              "decode_attention")}


class RouterGap:
    """While active, the smallest gap between the k-th and (k+1)-th router
    probability over every token routed (how close a routing flip was)."""

    def __enter__(self):
        self.min = float("inf")
        self._orig = moe_mod.moe_apply

        def tracked(*a, **kw):
            out, probs, idx = self._orig(*a, **kw)
            k = idx.shape[1]
            top = torch.sort(probs, dim=-1, descending=True).values
            self.min = min(self.min, (top[:, k - 1] - top[:, k]).min().item())
            return out, probs, idx
        moe_mod.moe_apply = tracked
        return self

    def __exit__(self, *exc):
        moe_mod.moe_apply = self._orig


def _serve(eng, reqs, timing: dict | None = None) -> None:
    """Admit and step until every request is done. With ``timing``, add
    the host seconds spent in ``admit_many`` and ``step`` and the steps."""
    queue = list(reqs)
    while queue or eng.busy():
        if queue:
            ta = time.perf_counter()
            taken = {id(r) for r in eng.admit_many(queue)}
            queue = [r for r in queue if id(r) not in taken]
            if timing is not None:
                timing["admit_s"] += time.perf_counter() - ta
        ts = time.perf_counter()
        eng.step()
        if timing is not None:
            timing["step_s"] += time.perf_counter() - ts
            timing["steps"] += 1


def phase_engine_parity(dev) -> None:
    params = {}
    ops.reset_launch_counts()
    for name, arch, kw, specs in PARITY:
        cfg = get_config(arch).reduced()            # fp32, 4 layers, d16
        if arch not in params:
            cpu = build_model(cfg, device="cpu").init(seed=0)
            params[arch] = {"cpu": cpu, "dev": _tree_to(cpu, dev)}
        out, gaps = {}, {}
        for where in ("dev", "cpu"):
            eng = Engine(cfg, params[arch][where],
                         device=dev if where == "dev" else "cpu",
                         victim_policy="fewest", **kw)
            reqs = _requests(specs, cfg.vocab, seed=1)
            before = ops.launch_counts()
            with RouterGap() as gap:
                _serve(eng, reqs)
            assert all(r.done for r in reqs), name
            out[where] = ([list(r.generated) for r in reqs],
                          dataclasses.asdict(eng.stats))
            gaps[where] = gap.min
            if where == "dev" and str(dev) != "cpu":
                after = ops.launch_counts()
                idle = [k for k in PARITY_REQUIRED.get(name, ())
                        if after[k] == before[k]]
                if idle:
                    raise SystemExit(f"chip_smoke: {idle} never launched in "
                                     f"the {name} parity run")
        same = out["dev"] == out["cpu"]
        extra = ""
        if cfg.n_experts:
            assert eng._group == 1 and eng.kv_layout == "contig", name
            extra = (f" min_router_gap dev={gaps['dev']:.3e} "
                     f"cpu={gaps['cpu']:.3e}")
        log(f"[engine-parity] {name:14s} {eng.kv_layout:6s} tokens+stats "
            f"identical={same} stats={out['dev'][1]}{extra}")
        if not same:
            raise SystemExit(f"chip_smoke: engine parity failed ({name}): "
                             f"{out}")
        if name == "contig_chunked" and not out["dev"][1]["chunk_scatters"]:
            raise SystemExit("chip_smoke: contig chunked parity ran no "
                             "chunk scatter")
        st = out["dev"][1]
        if name == "sanitized" and not (eng._kv_probe and st["preemptions"]
                                        and st["chunk_direct"]):
            raise SystemExit(f"chip_smoke: the sanitized parity run armed "
                             f"no probe, or did not preempt or chunk: {st}")
        if name in ("mamba2", "zamba2") and not (
                st["prefill_batches"] < st["prefills"]
                and eng.kv_layout == "contig"):
            raise SystemExit(f"chip_smoke: {name} parity formed no group "
                             f"of equal-length prompts: {st}")
    counts = ops.launch_counts()
    log(f"[engine-parity] launches {counts}")
    if str(dev) != "cpu" and not all(counts.values()):
        raise SystemExit(f"chip_smoke: a kernel never launched: {counts}")


# bf16 engine checks. Dense: Qwen3-32B's attention geometry (64/8 heads of
# 128) on a narrow, shallow trunk; prompts below and above prefill_chunk,
# so the bucketed prefill runs flash and the longer prompts chunk prefill.
# Recurrent: mamba2 (8 SSD heads of 64, state 128) and zamba2 (8 SSD heads
# of 64, state 64; the shared block's 32/32 heads of 80) at width 256 and
# two trunk layers (zamba2: four, the shared block after the second and
# fourth), prompts of one to six SSD chunks of 128, so the scan carries its
# state across chunks and ragged tails
BF16_ENGINE = dict(n_layers=2, d_model=256, d_ff=512, n_heads=64,
                   n_kv_heads=8, head_dim=128)
BF16_PROMPTS = [(37, 2), (150, 2), (211, 2), (300, 2), (517, 2), (700, 2)]
BF16_KW = dict(max_batch=4, max_len=768, prefill_chunk=256, block_size=16,
               victim_policy="fewest")
BF16_RECURRENT = {
    "mamba2-1.3b": dict(n_layers=2, d_model=256, ssm_head_dim=64,
                        ssm_state=128),
    "zamba2-2.7b": dict(n_layers=4, d_model=256, d_ff=512, n_heads=32,
                        n_kv_heads=32, head_dim=80, ssm_head_dim=64,
                        ssm_state=64),
}


class TeacherForced:
    """While active, every greedy sample of ``model`` returns the next of
    ``tokens`` (recorded from a reference run when ``tokens`` is None) and
    records the logits it was given: prefill logits whole, decode logits of
    the live slots only. ``decodes`` bounds the decode steps recorded."""

    def __init__(self, eng, tokens=None, decodes: int = 1):
        self.eng, self.tokens, self.decodes = eng, tokens, decodes
        self.logits, self.sampled = [], []

    def __enter__(self):
        model, eng = self.eng.model, self.eng
        orig_sample, orig_decode = model.sample_greedy, model.decode_step
        self._orig = (orig_sample, orig_decode)
        state = {"decode": False, "n_dec": 0}

        def decode_step(*a, **kw):
            state["decode"] = True
            return orig_decode(*a, **kw)

        def sample(logits):
            out = orig_sample(logits)
            if self.tokens is not None:
                out = self.tokens[len(self.sampled)].to(out.device)
            self.sampled.append(out.cpu())
            if state["decode"]:
                state["n_dec"] += 1
                live = [i for i, r in enumerate(eng.slots) if r is not None]
                if state["n_dec"] <= self.decodes:
                    self.logits.append(logits[live].float().cpu())
            else:
                self.logits.append(logits.float().cpu())
            state["decode"] = False
            return out
        model.sample_greedy, model.decode_step = sample, decode_step
        return self

    def __exit__(self, *exc):
        self.eng.model.sample_greedy, self.eng.model.decode_step = self._orig


def phase_engine_bf16(dev) -> None:
    """bf16 serving on the card against the same engine in fp32 on the CPU:
    the prefill logits and the first decode step's, with every run fed the
    fp32 run's tokens. The dense model paged and contig (flash and chunked
    prefill), then mamba2 and zamba2 (the SSD scan, and zamba2's flash and
    contiguous decode). The bf16 plain engine on the CPU is run the same
    way; its error sets the tolerance."""
    base = dataclasses.replace(get_config("qwen3-32b").reduced(),
                               **BF16_ENGINE)
    for layout in ("paged", "contig"):
        need = ("flash_attention", "chunk_attention_paged"
                if layout == "paged" else "chunk_attention")
        _bf16_engine_check(dev, layout, base, dict(
            BF16_KW, kv_layout="auto" if layout == "paged" else layout),
            need, layout)
    for arch, widths in BF16_RECURRENT.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), **widths)
        _bf16_engine_check(dev, arch.split("-")[0], cfg, dict(BF16_KW),
                           PARITY_REQUIRED[arch.split("-")[0]], "contig")


def _bf16_engine_check(dev, tag, base, kw, need, layout) -> None:
    cfg16 = dataclasses.replace(base, dtype="bfloat16")
    cfg32 = dataclasses.replace(base, dtype="float32")
    p16 = build_model(cfg16, device="cpu").init(seed=0)
    p32 = _tree_map(p16, lambda t: t.float())
    runs = {}
    for name, cfg, params, where in (
            ("cpu_fp32", cfg32, p32, "cpu"), ("cpu_bf16", cfg16, p16, "cpu"),
            ("card_bf16", cfg16, _tree_to(p16, dev), dev)):
        eng = Engine(cfg, params, device=where, **kw)
        ref = runs.get("cpu_fp32")
        reqs = _requests(BF16_PROMPTS, cfg.vocab, seed=2)
        before = ops.launch_counts()
        with TeacherForced(eng, ref.sampled if ref else None) as tf:
            _serve(eng, reqs)
        runs[name] = tf
        if str(where) != "cpu":
            after = ops.launch_counts()
            ran = {k: after[k] - before[k] for k in after
                   if after[k] != before[k]}
            if not all(ran.get(k) for k in need):
                raise SystemExit(f"chip_smoke: bf16 {tag} engine check "
                                 f"launched {ran}, needs {need}")
        assert eng.kv_layout == layout, (eng.kv_layout, layout)
    ref = runs["cpu_fp32"].logits
    scale = max(t.abs().max().item() for t in ref)

    def err(run):
        got = runs[run].logits
        assert [t.shape for t in got] == [t.shape for t in ref], run
        return max((a - b).abs().max().item() for a, b in zip(got, ref))
    cpu_err, card_err = err("cpu_bf16"), err("card_bf16")
    # tolerance: the bf16 plain engine's own error against fp32, three
    # times over. The card rounds the same values to bf16 at other places
    # (cuBLAS's bf16 GEMMs accumulate in another order, the attention
    # kernels round P to bf16 once per key tile, the SSD scan rounds M, x dt
    # and the state to bf16 as tensor-core operands), each of the same size
    # as the plain engine's roundings; a kernel that drops or adds keys or
    # positions moves the logits by a whole attention or SSD output, far
    # past it.
    tol = 3 * cpu_err
    ok = card_err <= tol and all(
        bool(torch.isfinite(t).all()) for t in runs["card_bf16"].logits)
    log(f"[engine-bf16] {tag:7s} {len(ref)} logits calls (prefill + "
        f"first decode), |logits| <= {scale:.3f}: card bf16 max_abs_err="
        f"{card_err:.3e}, cpu bf16 (plain) {cpu_err:.3e}, tol 3x cpu "
        f"= {tol:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: bf16 {tag} engine logits off the "
                         f"fp32 CPU engine ({card_err:.3e} > {tol:.3e})")


def phase_poison_bf16(dev) -> None:
    """The probe in a bf16 pool on the card, where KV_POISON is stored as
    998,244,352 (below the reference's threshold): poison planted in a
    mapped block of a sanitized paged engine (Qwen3-32B heads, two layers)
    raises ``KVSanitizerError`` at the next decode step and, mid-prefill,
    at the next chunk; the same plant without the sanitizer raises
    nothing."""
    cfg = dataclasses.replace(get_config("qwen3-32b").reduced(),
                              **BF16_ENGINE, dtype="bfloat16")
    params = _tree_to(build_model(cfg, device="cpu").init(seed=0), dev)
    stored = torch.tensor(KV_POISON, dtype=torch.bfloat16).item()
    for where, chunk in (("decode", 0), ("chunk", 16)):
        for sanitize in (True, False):
            eng = Engine(cfg, params, device=dev, max_batch=2, max_len=64,
                         block_size=16, prefill_chunk=chunk,
                         kv_sanitize=sanitize, victim_policy="fewest")
            req = ServeRequest(prompt=list(range(1, 41 if chunk else 21)),
                               max_new_tokens=8)
            assert eng.admit(req)
            eng.step()
            if chunk:
                assert not req.generated, "the prompt should be mid-prefill"
                slot = eng._pending[0].members[0].slot
            else:
                slot = next(i for i, r in enumerate(eng.slots) if r is req)
            eng.cache["k"][:, int(eng.bm.table[slot, 0])] = KV_POISON
            raised = None
            try:
                eng.step()
            except KVSanitizerError as e:
                raised = str(e)
            ok = (raised is not None) == sanitize
            log(f"[engine-poison] bf16 {where:6s} sanitize={sanitize!s:5s} "
                f"probe armed={eng._kv_probe} poison as stored={stored:.9g}"
                f" raised={raised!r} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"chip_smoke: bf16 poison plant at the "
                                 f"{where} step with sanitize={sanitize}: "
                                 f"raised={raised!r}")


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# -- phase 5: full-width serving paths -------------------------------------------
def path_workload(path: str, depth: int, seed: int, rehearsal: bool):
    """A serving path's config, Engine keywords, a maker of its requests,
    the new tokens per request and the kernels it must launch.

    Every path serves the same traffic (prompt lengths and new tokens from
    ``seed``; prompt tokens from the config's vocab), and its optional
    profile serves exactly this traffic too."""
    arch, layout, required = PATHS[path]
    if rehearsal:
        cfg = get_config(arch).reduced()
        n_req, lo, hi, chunk, max_len, new = 6, 4, 40, 8, 64, 4
    else:
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        n_req, lo, hi, chunk, max_len, new = 16, 64, 2048, 512, MAX_LEN, 32
    eng_kw = dict(max_batch=8, max_len=max_len, prefill_chunk=chunk,
                  block_size=16, victim_policy="fewest", kv_layout=layout,
                  **PATH_KW.get(path, {}))
    rng = np.random.RandomState(seed)
    lens = rng.randint(lo, hi + 1, n_req)
    # both admission paths run (MoE admits exact length, never chunked):
    # three prompts past prefill_chunk, three within it
    lens[:3] = [hi, (hi + chunk) // 2 + 1, chunk + 1]
    lens[3:6] = rng.randint(lo, chunk + 1, 3)
    prompts = [rng.randint(0, cfg.vocab, int(n)).tolist() for n in lens]

    def make_requests():
        return [ServeRequest(prompt=list(p), max_new_tokens=new)
                for p in prompts]
    return cfg, eng_kw, make_requests, new, required


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _timed_run(cfg, params, dev, eng_kw, reqs, new, required) -> dict:
    """Serve ``reqs`` on a fresh Engine; launch counts are zeroed just
    before and read just after. Fails unless every request finished with
    its token count and finite logits, and every kernel in ``required``
    launched."""
    eng = Engine(cfg, params, device=dev, **eng_kw)
    finite = []
    logits_fn = eng.model.logits

    def checked_logits(p, x):
        out = logits_fn(p, x)
        finite.append(torch.isfinite(out).all())
        return out
    eng.model.logits = checked_logits
    timing = dict(admit_s=0.0, step_s=0.0, steps=0)
    ops.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    _serve(eng, reqs, timing)
    _sync(dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    all_finite = bool(torch.stack(finite).all())
    done = all(r.done and len(r.generated) == new for r in reqs)
    if not (done and all_finite):
        raise SystemExit(f"chip_smoke: {cfg.name} path did not finish every "
                         f"request with finite logits")
    missing = [k for k in required if not counts[k]]
    if dev.type == "cuda" and missing:
        raise SystemExit(f"chip_smoke: {missing} never launched on the "
                         f"{cfg.name} path: {counts}")
    return dict(timing, wall=wall, counts=counts, layout=eng.kv_layout,
                stats=dataclasses.asdict(eng.stats),
                tokens=[list(r.generated) for r in reqs])


def phase_path(dev, path: str, depth: int, seed: int, rehearsal: bool,
               repeats: int, profile_dir: Path | None = None) -> dict:
    cfg, eng_kw, make_requests, new, required = path_workload(
        path, depth, seed, rehearsal)
    tag = f"[{path}]"
    model = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(seed=seed)
    warm = Engine(cfg, params, device=dev, **eng_kw)
    _sync(dev)
    param_gb = model.param_count() * model.dtype.itemsize / 1e9
    cache = {k: t for k, t in warm.cache.items() if k != "pos"}
    cache_gb = sum(t.numel() * t.element_size() for t in cache.values()) / 1e9
    log(f"{tag} {cfg.name} widths, {cfg.n_layers} of "
        f"{get_config(cfg.name).n_layers} layers, "
        f"{model.param_count() / 1e9:.3f} B params ({param_gb:.3f} GB "
        f"{cfg.dtype}), {warm.kv_layout} cache {sorted(cache)} "
        f"{cache_gb:.3f} GB, init {time.perf_counter() - t0:.1f} s")
    # warm-up: one untimed pass of the same traffic, so the timed runs do
    # not pay for first-use cuBLAS setup, allocator growth or first launches
    t0 = time.perf_counter()
    _serve(warm, make_requests())
    del warm, cache
    _sync(dev)
    log(f"{tag} warm-up pass (untimed workload) "
        f"{time.perf_counter() - t0:.3f} s")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    runs = []
    for i in range(repeats):
        reqs = make_requests()
        r = _timed_run(cfg, params, dev, eng_kw, reqs, new, required)
        runs.append(r)
        st = r["stats"]
        step_tokens = st["tokens_out"] - st["prefills"]
        log(f"{tag} run {i}: wall_s={r['wall']:.3f} "
            f"admit_s={r['admit_s']:.3f} step_s={r['step_s']:.3f} "
            f"steps={r['steps']} out_tok_per_s={st['tokens_out'] / r['wall']:.2f}"
            f" step_tok_per_s={step_tokens / max(r['step_s'], 1e-9):.2f}")
    lens = np.array([len(p.prompt) for p in make_requests()])
    st = runs[0]["stats"]
    walls = sorted(r["wall"] for r in runs)
    wall = float(np.median(walls))
    log(f"{tag} requests={len(lens)} prompt_tokens={int(lens.sum())} "
        f"(min {int(lens.min())}, max {int(lens.max())}) "
        f"tokens_out={st['tokens_out']} per run; {repeats} warm runs, "
        f"wall_s median={wall:.3f} min={walls[0]:.3f} max={walls[-1]:.3f}")
    log(f"{tag} out_tok_per_s median={st['tokens_out'] / wall:.2f} "
        f"(step_tok_per_s: tokens emitted by step() over the time spent "
        f"in step())")
    if dev.type == "cuda":
        log(f"{tag} peak_mem_GB="
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    log(f"{tag} stats {st}")
    log(f"{tag} launches per run {[r['counts'] for r in runs]} "
        f"required={list(required)} all_finite=True all_done=True")
    if profile_dir is not None:
        phase_profile(path, cfg, params, dev, eng_kw, make_requests(), wall,
                      profile_dir)
    del params, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return runs[0]["counts"], runs[0]["tokens"]


def check_sanitize_tokens(tokens: dict) -> None:
    """The sanitizer's poison writes and probes are output-neutral: the
    sanitize path (main's model, params and traffic) emits main's greedy
    tokens."""
    if "main" in tokens and "sanitize" in tokens:
        same = tokens["sanitize"] == tokens["main"]
        log(f"[sanitize] greedy tokens identical to main's: {same}")
        if not same:
            raise SystemExit("chip_smoke: the sanitize path's tokens differ "
                             "from the main path's")


# -- optional: profiler breakdown of each path -----------------------------------
KERNEL_NAMES = ("decode_split_kernel", "decode_combine_kernel",
                "decode_sm90_kernel", "dec::combine_kernel", "chunk_kernel",
                "flash_kernel")
SSD_KERNEL_NAMES = ("ssd_cb_kernel", "ssd_scan_kernel", "ssd::scan_kernel")


def _category(name: str) -> str:
    if "probe_kernel" in name:
        return "kv probe (port kernel)"
    if any(k in name for k in KERNEL_NAMES):
        return "attention (port kernels)"
    if any(k in name for k in SSD_KERNEL_NAMES):
        return "ssd scan (port kernel)"
    low = name.lower()
    if any(k in low for k in ("gemm", "cutlass", "xmma", "gemv", "nvjet")):
        return "matmul (cuBLAS)"
    if "index" in low or "scatter" in low or "gather" in low:
        return "index / scatter / gather"
    if "memcpy" in low or "memset" in low:
        return "memcpy / memset"
    return "other elementwise / reduction"


def phase_profile(path, cfg, params, dev, eng_kw, reqs,
                  unprofiled_wall: float, out_dir: Path) -> None:
    """Serve a path's traffic once more (after its warm-up and timed runs)
    under torch.profiler; print the device time by category and the
    device's idle share against both the profiled wall and the path's
    median unprofiled wall (opt-in: ``--profile``)."""
    from torch.profiler import ProfilerActivity, profile
    eng = Engine(cfg, params, device=dev, **eng_kw)
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _serve(eng, reqs)
        _sync(dev)
        wall = time.perf_counter() - t0
    cats: dict = {}
    ports: dict = {}                # port kernel -> (device us, launches)
    for evt in prof.key_averages():
        # device-side kernel / memcpy rows only: an aten:: op's "self CUDA"
        # time is its kernels' time again
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dt = getattr(evt, "self_device_time_total", None)
        if dt is None:
            dt = evt.self_cuda_time_total
        cat = _category(evt.key)
        cats[cat] = cats.get(cat, 0) + dt
        if "port kernel" in cat:
            t, n = ports.get(evt.key, (0, 0))
            ports[evt.key] = (t + dt, n + evt.count)
    busy = sum(cats.values()) / 1e6
    tag = f"[profile:{path}]"
    for name, (t, n) in sorted(ports.items(), key=lambda kv: -kv[1][0]):
        log(f"{tag} port kernel {t / 1e3:9.1f} ms {n:5d} launches "
            f"{t / max(n, 1):8.1f} us each  {name[:70]}")
    log(f"{tag} profiled wall_s={wall:.3f} device_busy_s={busy:.3f} "
        f"idle_share={max(0.0, 1 - busy / wall):.3f}; against the median "
        f"unprofiled warm wall_s={unprofiled_wall:.3f}: "
        f"idle_share={max(0.0, 1 - busy / unprofiled_wall):.3f}")
    for c, t in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f"{tag} {c:32s} {t / 1e3:10.1f} ms  {t / 1e6 / busy:.3f}")
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=25)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"profile_table_{path}.txt").write_text(table)
    log(f"{tag} top kernels in {out_dir / f'profile_table_{path}.txt'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=8,
                    help="depth of the full-width Qwen3-32B model on the "
                         "paged main and contig paths (phase 5)")
    ap.add_argument("--moe-layers", type=int, default=8,
                    help="depth of the full-width Phi-3.5-MoE model on the "
                         "MoE path (phase 5)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the phases that need no card on the CPU at a "
                         "tiny size with the plain versions; never prints "
                         "the ok line")
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma list of phases after 'device'; the serving "
                         "paths run in the order given (a partial run "
                         "never prints the ok line)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed runs of each serving path after its warm-up "
                         "pass (phase 5); the median wall is reported")
    ap.add_argument("--profile", type=Path, default=None, metavar="DIR",
                    help="after each serving path's timed runs, serve its "
                         "traffic once more under torch.profiler and write "
                         "the kernel table to DIR (off by default)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    unknown = phases - set(ALL_PHASES)
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {sorted(unknown)}")
    depth = {p: getattr(args, DEPTH_FLAG[PATHS[p][0]])
             if PATHS[p][0] in DEPTH_FLAG else None for p in PATHS}
    # serving paths run in the order --phases names them
    paths = [p for p in args.phases.split(",") if p in PATHS]
    if args.cpu_rehearsal:
        dev = torch.device("cpu")
        log("[rehearsal] CPU, plain versions, tiny sizes; no ok line")
        if "kernels" in phases:
            phase_kernels(dev, rehearsal=True)
        if "parity" in phases:
            phase_engine_parity(dev)
            phase_engine_bf16(dev)
            phase_poison_bf16(dev)
        tokens = {p: phase_path(dev, p, depth[p], args.seed,
                                rehearsal=True, repeats=args.repeats)[1]
                  for p in paths}
        check_sanitize_tokens(tokens)
        log("[rehearsal] done")
        return 0
    t0 = time.perf_counter()

    def done(phase: str) -> None:
        log(f"[time] {phase} done, {time.perf_counter() - t0:.1f} s since "
            f"start")
    info = phase_device()
    dev = torch.device("cuda", 0)
    rows = []
    counts = {}
    if "build" in phases:
        phase_build()
        done("build")
    if "kernels" in phases:
        rows = phase_kernels(dev, rehearsal=False)
        done("kernels")
    if "parity" in phases:
        phase_engine_parity(dev)
        phase_engine_bf16(dev)
        phase_poison_bf16(dev)
        done("parity")
    tokens = {}
    for p in paths:
        counts[p], tokens[p] = phase_path(dev, p, depth[p], args.seed,
                                          rehearsal=False,
                                          repeats=args.repeats,
                                          profile_dir=args.profile)
        done(p)
    check_sanitize_tokens(tokens)
    if phases != set(ALL_PHASES):
        log("[partial] phases run: " + ",".join(sorted(phases)))
        return 0
    for r in rows:
        # launches: each path's first timed run, summed over the paths
        r["launches_by_path"] = {p: c[r["name"]] for p, c in counts.items()
                                 if c[r["name"]]}
        r["launches"] = sum(r["launches_by_path"].values())
    keys = ["name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library_device_ms",
            "shape", "timed_shapes", "host_us"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
