"""Pipeline-parallel serving across stages: the paper's data plane (port of
``repro/launch/pipeline.py``).

The paper's core mechanism is PP across heterogeneous instances with an
**uneven layer partition** chosen by the estimator the placement optimizer
uses (§2.3, §4.2). ``pp_layer_split`` computes that partition;
``build_pp_serve_step`` runs the reference's GPipe-style microbatched decode
tick: ``m + n_stages - 1`` ticks, stage ``s`` running microbatch ``t - s``
when it is valid, the hidden state hopping to the next stage.

Layouts are the reference's, so the tests compare them leaf for leaf:
``pack_pp_params`` pads each stage's layer stack to ``lmax = max(split)``
((L, ...) -> (n_stages, lmax, ...), plus a ``pp_mask`` (n_stages, lmax)),
and the cache is ``{"k", "v": (n_stages, lmax, M, mb, S, nkv, hd), "pos":
scalar}``. Where the reference runs every padded layer and masks it to
identity, a stage here runs only its own ``split[s]`` layers, so padded
layers cost nothing and their cache slots stay as given. Each layer is
``LM._dense_layer_decode``, the unsplit decode's own body, so a stage does
exactly the unsplit model's arithmetic (the contiguous ``decode_attention``
kernel on the card).

Where the reference's stages are pods joined by ``ppermute``, a stage here
is a device: ``devices`` defaults to one card for every stage, and a hop
is ``.to(devices[s + 1], non_blocking=True)`` (a no-op on one card). With
stages on separate cards (``place_pp``), CUDA's asynchrony overlaps them.

Supported families: dense / moe / vlm decode on full-attention caches (no
sliding window, no encoder-decoder), as in the reference. With
``kv_cache_dtype`` the K/V cache is fp8 (``float8_e4m3fn`` /
``float8_e5m2``), as the reference's PP step keeps it: each layer writes
its token through ``common.astype`` and the contiguous decode kernel
reads the fp8 cache as stored.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import FP8_DTYPES
from repro_torch.models.transformer import LM


def pp_supported(cfg: ArchConfig) -> bool:
    return (cfg.family in ("dense", "moe", "vlm") and cfg.swa_window is None
            and not cfg.is_encdec)


# ---------------------------------------------------------------------------
# layer split (uneven, estimator-driven)
# ---------------------------------------------------------------------------
def pp_layer_split(cfg: ArchConfig, n_stages: int,
                   pod_flops: Optional[Sequence[float]] = None,
                   s_in: int = 32768, s_out: int = 1,
                   batch: int = 128) -> List[int]:
    """Balance per-stage decode latency across (possibly heterogeneous)
    pods. ``pod_flops`` are relative effective FLOP/s per pod (None =>
    homogeneous => near-even split)."""
    from repro_torch.core.roofline import layer_latency
    from repro_torch.hw.profiles import TPU_V5E, effective
    # TPU_V5E is the reference's planning base profile, kept so that the
    # split equals the reference's: only the ratios ``pod_flops`` matter to
    # the partition. It is not a measurement of the card this runs on.
    spec = cfg.to_modelspec()
    n = spec.n_layers
    if pod_flops is None:
        pod_flops = [1.0] * n_stages
    devs = [dataclasses.replace(effective(TPU_V5E),
                                flops_bf16=effective(TPU_V5E).flops_bf16 * f,
                                mem_bw=effective(TPU_V5E).mem_bw * f)
            for f in pod_flops]
    lat = [[layer_latency(spec.layers[i], d, "decode", batch, s_in, s_out,
                          16, spec.dtype_bytes) for i in range(n)]
           for d in devs]
    prefix = [[0.0] * (n + 1) for _ in range(n_stages)]
    for s in range(n_stages):
        for i in range(n):
            prefix[s][i + 1] = prefix[s][i] + lat[s][i]
    INF = math.inf
    dp = [[INF] * (n + 1) for _ in range(n_stages + 1)]
    cut = [[0] * (n + 1) for _ in range(n_stages + 1)]
    dp[0][0] = 0.0
    for s in range(1, n_stages + 1):
        for i in range(s, n + 1):
            for j in range(s - 1, i):
                seg = prefix[s - 1][i] - prefix[s - 1][j]
                v = max(dp[s - 1][j], seg)
                if v < dp[s][i]:
                    dp[s][i], cut[s][i] = v, j
    split, i = [], n
    for s in range(n_stages, 0, -1):
        j = cut[s][i]
        split.append(i - j)
        i = j
    return list(reversed(split))


# ---------------------------------------------------------------------------
# parameter packing and placement
# ---------------------------------------------------------------------------
def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _leaf_device(tree) -> torch.device:
    return next(iter(_leaves(tree))).device


def pack_pp_params(params: Dict, split: Sequence[int]) -> Dict:
    """Pad each stage's layers to ``lmax``: every ``layers`` leaf (L, ...)
    -> (n_stages, lmax, ...), zero-padded, plus ``pp_mask`` (n_stages,
    lmax) bool; the other entries are shared."""
    lmax = max(split)
    offs = [sum(split[:s]) for s in range(len(split))]

    def pack(leaf):
        out = leaf.new_zeros((len(split), lmax) + tuple(leaf.shape[1:]))
        for s, n in enumerate(split):
            out[s, :n] = leaf[offs[s]:offs[s] + n]
        return out

    out = dict(params)
    out["layers"] = _tree_map(params["layers"], pack)
    mask = torch.zeros((len(split), lmax), dtype=torch.bool,
                       device=_leaf_device(params["layers"]))
    for s, n in enumerate(split):
        mask[s, :n] = True
    out["pp_mask"] = mask
    return out


def place_pp(params: Dict, cache: Dict, devices: Sequence[DeviceLike]
             ) -> Tuple[Dict, Dict]:
    """Stage ``s`` of a packed tree and of its cache on ``devices[s]``: each
    ``layers`` leaf and ``k`` / ``v`` become a list of per-stage tensors
    (stage ``s``'s slice, on its device), which the step indexes as it
    indexes the stacked layout. The embedding and the head stay where they
    are: stage 0 embeds, and the last stage's hidden state goes to the
    head's device for the logits."""
    devs = [resolve_device(d) for d in devices]

    def per_stage(leaf):
        return [leaf[s].to(d) for s, d in enumerate(devs)]
    params = dict(params, layers=_tree_map(params["layers"], per_stage))
    cache = dict(cache, k=per_stage(cache["k"]), v=per_stage(cache["v"]))
    return params, cache


# ---------------------------------------------------------------------------
# the PP serve step
# ---------------------------------------------------------------------------
def build_pp_serve_step(cfg: ArchConfig, shape: ShapeSpec, n_stages: int, *,
                        devices: Optional[Sequence[DeviceLike]] = None,
                        n_microbatches: Optional[int] = None,
                        pod_flops: Optional[Sequence[float]] = None,
                        kv_cache_dtype: Optional[str] = None
                        ) -> Tuple[Callable, Dict]:
    """``(serve_step, meta)``: ``serve_step(params, cache, tokens)`` -> (the
    next greedy tokens (b, 1) int32, ``cache``) for the ``pack_pp_params``
    tree and the PP cache; it writes each stage's K/V in place and
    advances ``cache["pos"]`` (the reference's scalar) by one. ``meta``
    holds ``pp_split``, ``n_microbatches``, ``devices``, ``model``, the
    ``LM`` whose ``logits`` the last stage calls, and ``kv_dtype``, the K/V
    cache's dtype (``kv_cache_dtype``'s fp8 dtype, else the model's); the
    step raises on a cache of another dtype. ``devices`` defaults to the
    card, once per stage; without a card the build raises unless the
    caller passes CPU devices."""
    if not pp_supported(cfg):
        raise ValueError(f"PP serve unsupported for {cfg.name}")
    split = pp_layer_split(cfg, n_stages, pod_flops=pod_flops,
                           s_in=shape.seq_len, batch=shape.global_batch)
    b = shape.global_batch
    m = n_microbatches or (min(2 * n_stages, b) if b >= 2 * n_stages else 1)
    if b % m:
        raise ValueError(f"{b} rows are not {m} equal microbatches")
    mb = b // m
    devs = [resolve_device(d) for d in (devices or [None] * n_stages)]
    if len(devs) != n_stages:
        raise ValueError(f"{len(devs)} devices for {n_stages} stages")
    model = LM(cfg, device=devs[-1])
    kv_dt = FP8_DTYPES[kv_cache_dtype] if kv_cache_dtype else model.dtype
    last = n_stages - 1

    def serve_step(params: Dict, cache: Dict, tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict]:
        ck, cv = cache["k"], cache["v"]
        for got in {t.dtype for t in (*ck, *cv)}:
            if got != kv_dt:
                raise ValueError(f"PP serve_step: a {got} K/V cache, the "
                                 f"step was built for {kv_dt}")
        # each stage's own layers, padded ones left out
        stage_p = [[_tree_map(params["layers"], lambda a: a[s][j])
                    for j in range(split[s])] for s in range(n_stages)]
        # the kernels take per-row positions: the scalar, once per stage
        pos = [cache["pos"].to(d, torch.int32).reshape(1).expand(mb)
               .contiguous() for d in devs]
        tokens_m = tokens.reshape(m, mb, 1)
        outs = [None] * m
        recv: Dict[int, torch.Tensor] = {}
        for t in range(m + n_stages - 1):
            sent: Dict[int, torch.Tensor] = {}
            for s in range(n_stages):
                i = t - s
                if not 0 <= i < m:
                    continue
                x = model.embed(params, tokens_m[i]) if s == 0 else recv[s]
                for j, p in enumerate(stage_p[s]):
                    x = model._dense_layer_decode(p, x, pos[s], ck[s][j, i],
                                                  cv[s][j, i])
                if s < last:
                    sent[s + 1] = x.to(devs[s + 1], non_blocking=True)
                    continue
                head = params["final_norm"]
                x = model.norm(x.to(_leaf_device(head)), head)
                outs[i] = model.sample_greedy(model.logits(params, x))
            recv = sent
        cache["pos"] = cache["pos"] + 1
        nxt = torch.cat(outs).to(tokens.device, torch.int32)
        return nxt.reshape(b, 1), cache

    meta = {"pp_split": split, "n_microbatches": m, "devices": devs,
            "model": model, "kv_dtype": kv_dt}
    return serve_step, meta
