#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card.

    python3 chip_smoke.py                  # all phases, one card
    python3 chip_smoke.py --cpu-rehearsal  # tiny CPU rehearsal, no card

Phases, in order; any failure exits non-zero and nothing is caught:

1. device: require CUDA; print the card, its count and the nvidia-smi name
   and power limit; turn TF32 off for matmuls and cuDNN (fp32 stays fp32);
2. build the hand-written kernels (``src/repro_torch/kernels/csrc``) with
   nvcc and print the build seconds and the ptxas register report;
3. kernels vs plain on the card: each kernel against its plain PyTorch
   version on identical inputs, at the Qwen3-32B main-path shapes in bf16
   (atol=rtol=2e-2) and at small fp32 shapes (atol=rtol=1e-4: the kernel
   sums in another order than the plain version's einsum); GQA and MHA,
   SWA, scalar and per-row bases, ragged chunk / sequence lengths. At the
   main shapes it times the kernel, the plain version and, as a yardstick
   the port never calls, ``F.scaled_dot_product_attention`` on the
   gathered / repeated K/V, and computes the bound (bytes over 3.35 TB/s
   vs operations over 989 TFLOP/s bf16; only the blocks each row reaches);
4. engine parity, fp32: reduced qwen3-32b, one init, the same requests
   through the Engine on the card (kernels) and on the CPU (plain):
   bucketed prefill, direct-to-pool chunked prefill, and an overcommitted
   pool that grows and preempts; greedy tokens and counters must match and
   every kernel must have launched;
5. the main path at full width, bf16: Qwen3-32B's widths (d_model 5120,
   64/8 heads, head dim 128, d_ff 25600, vocab 151936) with depth cut to
   ``--layers``, random weights from a seeded generator on the card; 16
   requests of 64-2048 prompt tokens (some past ``prefill_chunk=512``),
   32 new tokens each; one untimed warm-up pass of that traffic, then
   ``--repeats`` timed runs (median wall reported), each on a fresh
   Engine with launch counts zeroed just before and read just after, and
   every kernel must have launched in each;
6. a JSON line of per-kernel numbers, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import Engine, ServeRequest  # noqa: E402

PEAK_BYTES = 3.35e12          # H100 SXM HBM3, bytes/s (data sheet)
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense FLOP/s
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
QWEN = dict(nh=64, nkv=8, d=128, bs=16)       # Qwen3-32B attention geometry
MAX_LEN = 2080                # 2048-token prompt + 32 new tokens


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
    _build.load()
    dt = time.perf_counter() - t0
    d = _build.build_dir()
    log(f"[build] {'built' if _build.build_info['built'] else 'loaded'} "
        f"{_build.build_info['path']} in {dt:.1f} s")
    logf = d / "build.log"
    if logf.exists():
        for line in logf.read_text().splitlines():
            if "Used" in line or "spill" in line and "0 bytes" not in line:
                log("[build] " + line.strip())


# -- timing ----------------------------------------------------------------------
def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` in ms: CUDA events on the card, the host clock
    around a synchronised loop otherwise (rehearsal only)."""
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


def _visible(qpos: np.ndarray, s_virt: int, window) -> np.ndarray:
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros_like(qpos)
    return np.minimum(qpos, s_virt - 1) - lo + 1, lo


def _pool_bytes(tbl, lo, hi, bs, nkv, d, esz) -> int:
    """Bytes of the block pool and table that rows reaching keys
    ``lo[r]..hi[r]`` must read: each distinct pool block once (K and V),
    however many rows or table entries point at it (dead rows all point at
    trash block 0), plus the table entries each row reads."""
    ids = [tbl[r, l // bs:h // bs + 1] for r, (l, h) in enumerate(zip(lo, hi))]
    distinct = len(np.unique(np.concatenate(ids)))
    return distinct * bs * nkv * d * 2 * esz + 4 * sum(map(len, ids))


def decode_work(tbl, pos, nh, nkv, d, bs, window, esz):
    b, mb = tbl.shape
    pos = np.broadcast_to(np.asarray(pos), (b,)).astype(np.int64)
    vis, lo = _visible(pos, mb * bs, window)
    hi = np.minimum(pos, mb * bs - 1)
    nbytes = (2 * b * nh * d * esz + _pool_bytes(tbl, lo, hi, bs, nkv, d, esz)
              + 4 * b)
    return nbytes, 4.0 * nh * d * vis.sum()


def chunk_work(tbl, bases, c, nh, nkv, d, bs, window, esz):
    b, mb = tbl.shape
    bases = np.broadcast_to(np.asarray(bases), (b,)).astype(np.int64)
    qpos = bases[:, None] + np.arange(c)[None, :]
    vis, _ = _visible(qpos, mb * bs, window)
    lo = np.maximum(0, bases - window + 1) if window else np.zeros(b, int)
    hi = np.minimum(bases + c - 1, mb * bs - 1)
    nbytes = (2 * b * c * nh * d * esz
              + _pool_bytes(tbl, lo, hi, bs, nkv, d, esz) + 4 * b)
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


def check(name, out, ref, dtype, label) -> float:
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[dtype]
    ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
    finite = bool(torch.isfinite(out.float()).all())
    log(f"[kernels] {name:24s} {label:44s} max_abs_err={err:.3e} "
        f"tol={tol:g} {'ok' if ok and finite else 'FAIL'}")
    if not (ok and finite):
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain "
                         f"version ({label})")
    return err


def phase_kernels(dev, rehearsal: bool) -> list:
    cs = Cases(dev)
    bf, f32 = torch.bfloat16, torch.float32
    nh, nkv, d, bs = QWEN["nh"], QWEN["nkv"], QWEN["d"], QWEN["bs"]
    if rehearsal:       # CPU: tiny geometry, plain vs plain
        nh, nkv, d, bs = 4, 2, 16, 8
    mb = -(-MAX_LEN // bs) if not rehearsal else 8
    run_dec = (da.decode_attention_paged_plain if rehearsal
               else da.decode_attention_paged)
    run_chk = (ca.chunk_attention_paged_plain if rehearsal
               else ca.chunk_attention_paged)
    run_fa = fa.flash_attention_plain if rehearsal else fa.flash_attention
    rows = []

    # ---- decode_attention_paged -------------------------------------------
    B = 8
    s_virt = mb * bs
    for dtype, (h, kv, dd, b_, mb_, bs_), win, label in [
            (bf, (nh, nkv, d, B, mb, bs), None, "main GQA bf16"),
            (bf, (nh, nkv, d, B, mb, bs), 256, "main SWA=256 bf16"),
            (f32, (4, 2, 16, 3, 6, 8), None, "GQA 4/2 d16 fp32"),
            (f32, (4, 4, 32, 3, 6, 8), 8, "MHA d32 SWA=8 fp32"),
            (f32, (8, 2, 64, 2, 5, 16), None, "GQA 8/2 d64 fp32")]:
        pk, pv, tbl = cs.pool(b_, mb_, bs_, kv, dd, dtype)
        q = cs.randn(b_, 1, h, dd, dtype=dtype)
        pos = cs.randint(0, mb_ * bs_, (b_,))
        tbl[-1] = 0                 # a dead row: trash table, frozen pos
        args = (q, pk, pv, tbl, pos)
        out = run_dec(*args, window=win)
        ref = da.decode_attention_paged_plain(*args, window=win)
        err = check("decode_attention_paged", out, ref, dtype, label)
        if label == "main GQA bf16":
            main = (args, err)
    (q, pk, pv, tbl, pos), err = main
    ms = time_ms(lambda: run_dec(q, pk, pv, tbl, pos))
    plain_ms = time_ms(lambda: da.decode_attention_paged_plain(
        q, pk, pv, tbl, pos), iters=5)
    gk, gv = (x[tbl.long()].reshape(B, s_virt, nkv, d) for x in (pk, pv))
    mask = (torch.arange(s_virt, device=dev)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    sq, sk, sv, sm = _sdpa_inputs(q, gk, gv, mask)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=sm))
    nb, fl = decode_work(tbl.cpu().numpy(), pos.cpu().numpy(), nh, nkv, d,
                         bs, None, 2)
    b_ms, b_by = bound(nb, fl, bf)
    rows.append(dict(
        name="decode_attention_paged", route="cuda", source=da.SOURCE,
        replaces=da.REPLACES, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape=f"q=({B},1,{nh},{d}) pool=({pk.shape[0]},{bs},{nkv},{d}) "
              f"tbl=({B},{mb}) bf16"))

    # ---- chunk_attention_paged --------------------------------------------
    B, C = 4, (512 if not rehearsal else 16)
    base_main = 2 * C
    for dtype, (h, kv, dd, b_, c_, mb_, bs_), bases, win, label in [
            (bf, (nh, nkv, d, B, C, mb, bs), base_main, None,
             "main GQA scalar base bf16"),
            (bf, (nh, nkv, d, B, C, mb, bs), "rows", None,
             "main GQA per-row bases bf16"),
            (bf, (nh, nkv, d, B, 300 if not rehearsal else 11, mb, bs),
             "rows", 256, "ragged C, SWA=256, per-row bf16"),
            (f32, (4, 2, 16, 2, 13, 8, 8), 20, None,
             "GQA 4/2 d16 ragged C=13 fp32"),
            (f32, (4, 4, 32, 2, 16, 8, 8), "rows", 8,
             "MHA d32 SWA=8 per-row fp32"),
            (f32, (8, 2, 64, 2, 24, 6, 16), 40, None, "GQA 8/2 d64 fp32")]:
        pk, pv, tbl = cs.pool(b_, mb_, bs_, kv, dd, dtype)
        q = cs.randn(b_, c_, h, dd, dtype=dtype)
        if bases == "rows":
            bases = cs.randint(0, mb_ * bs_ - c_ + 1, (b_,))
        args = (q, pk, pv, tbl, bases)
        out = run_chk(*args, window=win)
        ref = ca.chunk_attention_paged_plain(*args, window=win)
        err = check("chunk_attention_paged", out, ref, dtype, label)
        if label == "main GQA scalar base bf16":
            main = (args, err)
    (q, pk, pv, tbl, bases), err = main
    ms = time_ms(lambda: run_chk(q, pk, pv, tbl, bases))
    plain_ms = time_ms(lambda: ca.chunk_attention_paged_plain(
        q, pk, pv, tbl, bases), iters=3, warmup=1)
    gk, gv = (x[tbl.long()].reshape(B, s_virt, nkv, d) for x in (pk, pv))
    qpos = base_main + torch.arange(C, device=dev)
    mask = (torch.arange(s_virt, device=dev)[None, :]
            <= qpos[:, None])[None, None]
    sq, sk, sv, sm = _sdpa_inputs(q, gk, gv, mask)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=sm))
    nb, fl = chunk_work(tbl.cpu().numpy(), base_main, C, nh, nkv, d, bs,
                        None, 2)
    b_ms, b_by = bound(nb, fl, bf)
    rows.append(dict(
        name="chunk_attention_paged", route="cuda", source=ca.SOURCE,
        replaces=ca.REPLACES, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape=f"q=({B},{C},{nh},{d}) base={base_main} "
              f"pool=({pk.shape[0]},{bs},{nkv},{d}) bf16"))

    # ---- flash_attention --------------------------------------------------
    B, S = 4, (512 if not rehearsal else 32)
    for dtype, (h, kv, dd, b_, s_), causal, win, label in [
            (bf, (nh, nkv, d, B, S), True, None, "main GQA causal bf16"),
            (bf, (nh, nkv, d, 2, 300 if not rehearsal else 19), True, 128,
             "ragged S, SWA=128 bf16"),
            (f32, (4, 2, 16, 2, 37), True, None, "GQA 4/2 d16 S=37 fp32"),
            (f32, (4, 4, 32, 2, 40), True, 8, "MHA d32 SWA=8 fp32"),
            (f32, (8, 2, 64, 1, 70), False, None,
             "GQA 8/2 d64 non-causal fp32")]:
        q = cs.randn(b_, s_, h, dd, dtype=dtype)
        k = cs.randn(b_, s_, kv, dd, dtype=dtype)
        v = cs.randn(b_, s_, kv, dd, dtype=dtype)
        out = run_fa(q, k, v, causal=causal, window=win)
        ref = fa.flash_attention_plain(q, k, v, causal=causal, window=win)
        err = check("flash_attention", out, ref, dtype, label)
        if label == "main GQA causal bf16":
            main = ((q, k, v), err)
    (q, k, v), err = main
    ms = time_ms(lambda: run_fa(q, k, v))
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v), iters=5)
    sq, sk, sv, _ = _sdpa_inputs(q, k, v, None)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        sq, sk, sv, is_causal=True))
    nb, fl = flash_work(B, S, nh, nkv, d, None, 2)
    b_ms, b_by = bound(nb, fl, bf)
    rows.append(dict(
        name="flash_attention", route="cuda", source=fa.SOURCE,
        replaces=fa.REPLACES, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape=f"q=({B},{S},{nh},{d}) k/v=({B},{S},{nkv},{d}) causal bf16"))
    for r in rows:
        log(f"[kernels] {r['name']:24s} kernel {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  sdpa {r['library_ms']:.4f} ms  bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})  {r['shape']}")
    return rows


# -- phase 4: engine parity (fp32, card vs CPU) ----------------------------------
def _requests(specs, vocab, seed):
    rng = np.random.RandomState(seed)
    return [ServeRequest(prompt=rng.randint(0, vocab, n).tolist(),
                         max_new_tokens=m) for n, m in specs]


PARITY = [
    ("bucketed", dict(max_batch=4, max_len=64),
     [(5, 8), (12, 6), (27, 9), (33, 4), (9, 7)]),
    ("chunked", dict(max_batch=4, max_len=64, prefill_chunk=8),
     [(40, 6), (17, 5), (3, 12), (29, 8)]),
    ("overcommit", dict(max_batch=4, max_len=64, block_size=8, n_blocks=11,
                        kv_overcommit=2.5, prefill_chunk=8),
     [(9, 20), (11, 20), (13, 20)]),
]


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
    cfg = get_config("qwen3-32b").reduced()          # fp32, 4 layers, d16
    cpu_params = build_model(cfg, device="cpu").init(seed=0)
    dev_params = _tree_to(cpu_params, dev)
    ops.reset_launch_counts()
    for name, kw, specs in PARITY:
        out = {}
        for where, params in (("dev", dev_params), ("cpu", cpu_params)):
            eng = Engine(cfg, params, device=dev if where == "dev" else "cpu",
                         victim_policy="fewest", **kw)
            reqs = _requests(specs, cfg.vocab, seed=1)
            _serve(eng, reqs)
            assert all(r.done for r in reqs), name
            out[where] = ([list(r.generated) for r in reqs],
                          dataclasses.asdict(eng.stats))
        same = out["dev"] == out["cpu"]
        log(f"[engine-parity] {name:10s} tokens+stats identical={same} "
            f"stats={out['dev'][1]}")
        if not same:
            raise SystemExit(f"chip_smoke: engine parity failed ({name}): "
                             f"{out}")
    counts = ops.launch_counts()
    log(f"[engine-parity] launches {counts}")
    if str(dev) != "cpu" and not all(counts.values()):
        raise SystemExit(f"chip_smoke: a kernel never launched: {counts}")


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# -- phase 5: full width main path -----------------------------------------------
def main_workload(layers: int, seed: int, rehearsal: bool):
    """The main path's config, Engine keywords and a maker of its requests.

    Phase 5 and its optional profile serve exactly this traffic."""
    if rehearsal:
        cfg = get_config("qwen3-32b").reduced()
        n_req, lo, hi, chunk, max_len, new = 6, 4, 40, 8, 64, 4
    else:
        cfg = dataclasses.replace(get_config("qwen3-32b"), n_layers=layers)
        n_req, lo, hi, chunk, max_len, new = 16, 64, 2048, 512, MAX_LEN, 32
    eng_kw = dict(max_batch=8, max_len=max_len, prefill_chunk=chunk,
                  block_size=16, victim_policy="fewest")
    rng = np.random.RandomState(seed)
    lens = rng.randint(lo, hi + 1, n_req)
    # both admission paths run: three prompts past prefill_chunk (chunked,
    # direct to the pool), three within it (bucketed flash prefill)
    lens[:3] = [hi, (hi + chunk) // 2 + 1, chunk + 1]
    lens[3:6] = rng.randint(lo, chunk + 1, 3)
    prompts = [rng.randint(0, cfg.vocab, int(n)).tolist() for n in lens]

    def make_requests():
        return [ServeRequest(prompt=list(p), max_new_tokens=new)
                for p in prompts]
    return cfg, eng_kw, make_requests, new


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _timed_run(cfg, params, dev, eng_kw, reqs, new) -> dict:
    """Serve ``reqs`` on a fresh Engine; launch counts are zeroed just
    before and read just after. Fails unless every request finished with
    its token count and finite logits."""
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
        raise SystemExit("chip_smoke: main path did not finish every "
                         "request with finite logits")
    if dev.type == "cuda" and not all(counts.values()):
        raise SystemExit(f"chip_smoke: a kernel never launched on the main "
                         f"path: {counts}")
    return dict(timing, wall=wall, counts=counts,
                stats=dataclasses.asdict(eng.stats))


def phase_main_path(dev, layers: int, seed: int, rehearsal: bool,
                    repeats: int, profile_dir: Path | None = None) -> dict:
    cfg, eng_kw, make_requests, new = main_workload(layers, seed, rehearsal)
    model = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(seed=seed)
    warm = Engine(cfg, params, device=dev, **eng_kw)
    _sync(dev)
    pool = warm.cache["k"]
    log(f"[main] {cfg.name} widths, {cfg.n_layers} layers, "
        f"{model.param_count() / 1e9:.3f} B params ({cfg.dtype}), pool "
        f"{2 * pool.numel() * pool.element_size() / 1e9:.3f} GB, init "
        f"{time.perf_counter() - t0:.1f} s")
    # warm-up: one untimed pass of the same traffic, so the timed runs do
    # not pay for first-use cuBLAS setup, allocator growth or first launches
    t0 = time.perf_counter()
    _serve(warm, make_requests())
    del warm, pool
    _sync(dev)
    log(f"[main] warm-up pass (untimed workload) {time.perf_counter() - t0:.3f}"
        f" s")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    runs = []
    for i in range(repeats):
        reqs = make_requests()
        r = _timed_run(cfg, params, dev, eng_kw, reqs, new)
        runs.append(r)
        st = r["stats"]
        step_tokens = st["tokens_out"] - st["prefills"]
        log(f"[main] run {i}: wall_s={r['wall']:.3f} "
            f"admit_s={r['admit_s']:.3f} step_s={r['step_s']:.3f} "
            f"steps={r['steps']} out_tok_per_s={st['tokens_out'] / r['wall']:.2f}"
            f" step_tok_per_s={step_tokens / max(r['step_s'], 1e-9):.2f}")
    lens = np.array([len(p.prompt) for p in make_requests()])
    st = runs[0]["stats"]
    walls = sorted(r["wall"] for r in runs)
    wall = float(np.median(walls))
    log(f"[main] requests={len(lens)} prompt_tokens={int(lens.sum())} "
        f"(min {int(lens.min())}, max {int(lens.max())}) "
        f"tokens_out={st['tokens_out']} per run; {repeats} warm runs, "
        f"wall_s median={wall:.3f} min={walls[0]:.3f} max={walls[-1]:.3f}")
    log(f"[main] out_tok_per_s median={st['tokens_out'] / wall:.2f} "
        f"(step_tok_per_s: tokens emitted by step() over the time spent "
        f"in step())")
    if dev.type == "cuda":
        log(f"[main] peak_mem_GB="
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    log(f"[main] stats {st}")
    counts = runs[0]["counts"]
    log(f"[main] launches per run {[r['counts'] for r in runs]} "
        f"all_finite=True all_done=True")
    if profile_dir is not None:
        phase_profile(cfg, params, dev, eng_kw, make_requests(), wall,
                      profile_dir)
    return counts


# -- optional: profiler breakdown of the main path ------------------------------
KERNEL_NAMES = ("decode_split_kernel", "decode_combine_kernel",
                "chunk_paged_kernel", "flash_kernel")


def _category(name: str) -> str:
    if any(k in name for k in KERNEL_NAMES):
        return "attention (port kernels)"
    low = name.lower()
    if any(k in low for k in ("gemm", "cutlass", "xmma", "gemv", "nvjet")):
        return "matmul (cuBLAS)"
    if "index" in low or "scatter" in low or "gather" in low:
        return "index / scatter / gather"
    if "memcpy" in low or "memset" in low:
        return "memcpy / memset"
    return "other elementwise / reduction"


def phase_profile(cfg, params, dev, eng_kw, reqs, unprofiled_wall: float,
                  out_dir: Path) -> None:
    """Serve the main-path traffic once more (after phase 5's warm-up and
    timed runs) under torch.profiler; print the device time by category and
    the device's idle share against both the profiled wall and phase 5's
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
    for evt in prof.key_averages():
        # device-side kernel / memcpy rows only: an aten:: op's "self CUDA"
        # time is its kernels' time again
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dt = getattr(evt, "self_device_time_total", None)
        if dt is None:
            dt = evt.self_cuda_time_total
        cats[_category(evt.key)] = cats.get(_category(evt.key), 0) + dt
    busy = sum(cats.values()) / 1e6
    log(f"[profile] profiled wall_s={wall:.3f} device_busy_s={busy:.3f} "
        f"idle_share={max(0.0, 1 - busy / wall):.3f}; against the median "
        f"unprofiled warm wall_s={unprofiled_wall:.3f}: "
        f"idle_share={max(0.0, 1 - busy / unprofiled_wall):.3f}")
    for c, t in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f"[profile] {c:32s} {t / 1e3:10.1f} ms  {t / 1e6 / busy:.3f}")
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=25)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "profile_table.txt").write_text(table)
    log(f"[profile] top kernels in {out_dir / 'profile_table.txt'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=8,
                    help="depth of the full-width model (phase 5)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the phases that need no card on the CPU at a "
                         "tiny size with the plain versions; never prints "
                         "the ok line")
    ap.add_argument("--phases", default="build,kernels,parity,main",
                    help="comma list of phases after 'device' (a partial "
                         "run never prints the ok line)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed runs of the main path after its warm-up "
                         "pass (phase 5); the median wall is reported")
    ap.add_argument("--profile", type=Path, default=None, metavar="DIR",
                    help="after phase 5's timed runs, serve its traffic "
                         "once more under torch.profiler and write the "
                         "kernel table to DIR (off by default)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if args.cpu_rehearsal:
        dev = torch.device("cpu")
        log("[rehearsal] CPU, plain versions, tiny sizes; no ok line")
        if "kernels" in phases:
            phase_kernels(dev, rehearsal=True)
        if "parity" in phases:
            phase_engine_parity(dev)
        if "main" in phases:
            phase_main_path(dev, args.layers, args.seed, rehearsal=True,
                            repeats=args.repeats)
        log("[rehearsal] done")
        return 0
    info = phase_device()
    dev = torch.device("cuda", 0)
    rows = []
    counts = {}
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        rows = phase_kernels(dev, rehearsal=False)
    if "parity" in phases:
        phase_engine_parity(dev)
    if "main" in phases:
        counts = phase_main_path(dev, args.layers, args.seed,
                                 rehearsal=False, repeats=args.repeats,
                                 profile_dir=args.profile)
    if phases != {"build", "kernels", "parity", "main"}:
        log("[partial] phases run: " + ",".join(sorted(phases)))
        return 0
    for r in rows:
        r["launches"] = counts[r["name"]]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
