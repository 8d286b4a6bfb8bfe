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
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.steps import BuiltStep, build_rules
from repro_torch.models.api import TensorSpec
from repro_torch.models.common import FP8_DTYPES, ParamDef, init_params
from repro_torch.models.transformer import LM
from repro_torch.sharding import rules as R


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
def build_pp_serve_step(cfg: ArchConfig, shape: ShapeSpec,
                        stages: Union[int, Mesh], rules: Optional[Dict] = None,
                        n_microbatches: Optional[int] = None,
                        pod_flops: Optional[Sequence[float]] = None,
                        kv_cache_dtype: Optional[str] = None, *,
                        devices: Optional[Sequence[DeviceLike]] = None,
                        device: DeviceLike = None):
    """The PP serve step, built in one of two ways, told apart by the type
    of ``stages``:

      * an int, the number of stages: every stage in this process
        (``devices``, one per stage; module docstring). Returns ``(step,
        meta)`` (``_in_process_step``).
      * a ``launch/mesh.py`` ``Mesh`` with a ``pod`` axis, as the
        reference's ``build_pp_serve_step(cfg, shape, mesh, rules, ...)``
        takes it: THIS rank's stage on ``device`` (``rules`` the
        ``build_rules`` table). Returns a ``BuiltStep``
        (``_rank_step``); ``build_step(serve_pp=True)`` calls it.
    """
    if isinstance(stages, int):
        if rules is not None or device is not None:
            raise TypeError("the in-process PP step takes n_stages and "
                            "devices, not rules or device")
        return _in_process_step(cfg, shape, stages, devices, n_microbatches,
                                pod_flops, kv_cache_dtype)
    if devices is not None:
        raise TypeError("a rank's PP step runs on one device: pass device")
    return _rank_step(cfg, shape, stages, rules, n_microbatches, pod_flops,
                      kv_cache_dtype, device)


def _plan(cfg: ArchConfig, shape: ShapeSpec, n_stages: int,
          n_microbatches: Optional[int],
          pod_flops: Optional[Sequence[float]]) -> Tuple[List[int], int]:
    """(the layer split, the microbatch count) by the reference's rules;
    raises for an unsupported family or uneven microbatches."""
    if not pp_supported(cfg):
        raise ValueError(f"PP serve unsupported for {cfg.name}")
    split = pp_layer_split(cfg, n_stages, pod_flops=pod_flops,
                           s_in=shape.seq_len, batch=shape.global_batch)
    b = shape.global_batch
    m = n_microbatches or (min(2 * n_stages, b) if b >= 2 * n_stages else 1)
    if b % m:
        raise ValueError(f"{b} rows are not {m} equal microbatches")
    return split, m


def _in_process_step(cfg: ArchConfig, shape: ShapeSpec, n_stages: int,
                     devices: Optional[Sequence[DeviceLike]],
                     n_microbatches: Optional[int],
                     pod_flops: Optional[Sequence[float]],
                     kv_cache_dtype: Optional[str]) -> Tuple[Callable, Dict]:
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
    split, m = _plan(cfg, shape, n_stages, n_microbatches, pod_flops)
    b = shape.global_batch
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


# ---------------------------------------------------------------------------
# the rank-side PP serve step: one rank per stage
# ---------------------------------------------------------------------------
def _held(cfg: ArchConfig, stage: int, n_stages: int) -> Tuple[str, ...]:
    """The top-level params a stage holds: its layers; the first stage the
    embedding; the last the final norm and the head (the embedding too
    where the head is tied to it)."""
    keys = ["layers"]
    if stage == 0 or (stage == n_stages - 1 and cfg.tie_embeddings):
        keys.append("embed")
    if stage == n_stages - 1:
        keys.append("final_norm")
        if not cfg.tie_embeddings:
            keys.append("lm_head")
    return tuple(keys)


def _as_tensor(a) -> torch.Tensor:
    """A tensor, or a numpy array (a bf16 one too) as a CPU tensor."""
    if torch.is_tensor(a):
        return a
    from repro_torch.models.convert import _to_tensor
    return _to_tensor(a, torch.device("cpu"))


class PPBuiltStep(BuiltStep):
    """A rank's PP serve step (``_rank_step``): ``init_params``,
    ``shard_params`` and ``shard_cache`` give the rank its stage's part,
    cut over ``model`` and its rows over ``data``."""

    def _stage_leaf(self, top: str, d: ParamDef, full,
                    packed: bool = False) -> Optional[torch.Tensor]:
        """This rank's part of one full leaf (None for a leaf its stage
        does not hold) on its device: the stage's layers of an unsplit
        (L, ...) or packed (n_stages, lmax, ...) ``layers`` leaf, then the
        tensor-parallel cut; never a view of the full leaf, so that it can
        be freed. ``full``: a tensor or a numpy array."""
        meta = self.meta
        if top not in meta["held"]:
            return None
        if top == "layers":
            stage, off = meta["stage"], meta["layer_offset"]
            n = meta["pp_split"][stage]
            full = full[stage, :n] if packed else full[off:off + n]
        t = self.model._local_leaf(d, _as_tensor(full))
        if t.untyped_storage().nbytes() != t.numel() * t.element_size():
            t = t.clone()
        return t.to(self.model.device)

    def _walk(self, fn) -> Dict:
        """``fn(top, def, path)`` over the model's schema, in the unsplit
        init's (sorted) leaf order, the held leaves kept."""
        def walk(node, top, path):
            if isinstance(node, ParamDef):
                return fn(top, node, path)
            out = {k: walk(node[k], top or k, path + (k,))
                   for k in sorted(node)}
            return {k: v for k, v in out.items() if v is not None} or None
        return walk(self.model._schema, None, ())

    def init_params(self, seed: int = 0) -> Dict:
        """This rank's local params with the unsplit ``init(seed)``'s
        numbers, drawn on its device leaf by leaf (one full leaf alive at a
        time): never a whole model per rank."""
        model = self.model
        gen = torch.Generator(device=model.device).manual_seed(seed)
        return self._walk(lambda top, d, path: self._stage_leaf(
            top, d, _draw(d, gen, model.dtype, model.device)))

    def shard_params(self, full: Dict) -> Dict:
        """This rank's local params (on its device) from the unsplit tree
        (``layers`` leaves (L, ...)) or from the reference's packed tree
        (``pack_pp_params``: (n_stages, lmax, ...) and ``pp_mask``); leaves
        may be tensors or numpy arrays."""
        packed = "pp_mask" in full

        def leaf(top, d, path):
            if top not in self.meta["held"]:
                return None
            a = full
            for k in path:
                a = a[k]
            return self._stage_leaf(top, d, a, packed)
        return self._walk(leaf)

    def shard_cache(self, full: Dict) -> Dict:
        """This rank's cache, {"k", "v": (split[stage], m, mb_local, S,
        nkv_local, hd), "pos": scalar int32} (cut by sequence inside the
        stage: (..., S_local, nkv, hd)), on its device, from the
        reference's PP cache ({"k", "v": (n_stages, lmax, m, mb, S, nkv,
        hd), "pos": scalar}) or from an unsplit contiguous cache ({"k",
        "v": (L, b, S, nkv, hd), "pos": (b,) or scalar}, the rows in
        microbatch order, every row at one position). Tensors or numpy
        arrays; an fp8 cache is cut as its bytes and keeps its dtype."""
        meta = self.meta
        stage, m = meta["stage"], meta["n_microbatches"]
        n, off = meta["pp_split"][stage], meta["layer_offset"]
        rows = meta["rows"]
        out = {}
        for key in ("k", "v"):
            t = _as_tensor(full[key])
            dt = t.dtype
            if dt in FP8_DTYPES.values():
                t = t.view(torch.uint8)
            if t.ndim == 7:
                t = t[stage, :n]
            elif t.ndim == 5:
                t = t[off:off + n].reshape((n, m, -1) + tuple(t.shape[2:]))
            else:
                raise ValueError(f"shard_cache: cache[{key!r}] of shape "
                                 f"{tuple(t.shape)} is neither the PP "
                                 f"layout (7 dims) nor contiguous (5)")
            t = self.model.cache_part(t[:, :, rows], 3, 4)
            out[key] = t.contiguous().view(dt).to(self.model.device)
        pos = _as_tensor(full["pos"]).reshape(-1)
        if bool((pos != pos[0]).any()):
            raise ValueError("shard_cache: the PP step takes one position "
                             "for every row")
        out["pos"] = pos[0].to(self.model.device, torch.int32)
        return out


def _draw(d: ParamDef, gen: torch.Generator, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    """One leaf as the unsplit init draws it."""
    return init_params({"x": d}, gen, dtype, device)["x"]


def _rank_step(cfg: ArchConfig, shape: ShapeSpec, mesh: Mesh,
               rules: Optional[Dict], n_microbatches: Optional[int],
               pod_flops: Optional[Sequence[float]],
               kv_cache_dtype: Optional[str],
               device: DeviceLike) -> PPBuiltStep:
    """This rank's stage of the reference's PP serve step
    (``repro/launch/pipeline.py``'s ``build_pp_serve_step``): stage =
    the rank's ``pod`` coordinate, tensor parallel over ``model`` and
    serving its rows of every microbatch over ``data``.

    ``fn(params, cache, tokens)`` takes the rank's params and cache
    (``PPBuiltStep``) and the whole batch's tokens (b, 1), and returns
    the whole batch's next greedy tokens (b, 1) int32 on every rank and
    the cache, written in place, ``pos`` advanced by one. The stage works
    microbatch ``i`` at tick ``stage + i`` of the reference's ``m +
    n_stages - 1``: stage 0 embeds its tokens, any other receives the
    hidden state (mb_local, 1, d_model) from the rank of ``pod = stage -
    1`` with its data and model coordinates; it runs its ``split[stage]``
    layers (``LM._dense_layer_decode``: the contiguous decode kernel on
    the card, at the local head counts) and sends the result on to ``pod
    = stage + 1``, where the last stage runs the final norm, the logits
    and the greedy token instead. ``valid(s, t) == valid(s + 1, t + 1)``,
    so each of the ``m * (n_stages - 1)`` sends a step meets a receive.
    The receives are posted when the step starts and the sends do not
    block the next tick (``isend`` / ``irecv``, tag = microbatch).

    The transport is chosen by the world's backend: nccl sends the device
    tensor; gloo, whose send and receive take CPU tensors only, stages a
    CUDA hop through a host buffer (a CPU rank sends its tensor). A hop
    that fails raises (``Work.wait``); nothing falls back.

    Tokens: the last stage fills a zero (m, mb) int32 buffer at its rows,
    and one all_reduce over ``pod`` (and ``data`` where the rows are split
    over it: the ``("pod", "data")`` group) gives every rank the batch
    (the reference's ``psum`` over ``pod`` and its gather of the rows).
    ``meta["hops"]`` counts this rank's sends, receives and bytes sent;
    ``last_logits`` are the last stage's logits of the last step ((m *
    mb_local, 1, Vpad), microbatch order; None on the other stages).
    ``kv_cache_dtype`` stores the cache in fp8 as the in-process step does
    (``store_cache``); a cache of another dtype raises. Weights stay in
    the model's dtype (the reference's ``build_step`` hands its PP step
    no ``weight_dtype``)."""
    if "pod" not in mesh.shape:
        raise ValueError(f"the rank-side PP step needs a mesh with a pod "
                         f"axis, not {dict(mesh.shape)}")
    n_stages, stage = mesh.shape["pod"], mesh.coords["pod"]
    split, m = _plan(cfg, shape, n_stages, n_microbatches, pod_flops)
    b, s_max = shape.global_batch, shape.seq_len
    mb = b // m
    if rules is None:
        rules = build_rules(cfg, mesh, False, step=shape.step, shape=shape)
    rules = dict(rules)
    rules["pp_stage"] = ("pod",)
    rules["batch"] = ("data",)              # pod is used by PP, not DP
    # the cache is cut by sequence inside a stage where ``cache_seq``
    # takes ``model``; ``seq`` has nothing to cut at one token a row
    sharder = R.Sharder(mesh=mesh, rules=rules)
    lo, hi = sharder.local_range(("batch",), (mb,), 0)
    bspec = sharder.spec(("batch",), (mb,))[0]
    batch_axes = bspec if sharder.size(bspec) > 1 else None
    dev = resolve_device(device)
    model = LM(cfg, device=dev, sharder=sharder, batch_axes=batch_axes)
    kv_dt = FP8_DTYPES[kv_cache_dtype] if kv_cache_dtype else model.dtype
    n, last = split[stage], n_stages - 1
    kv_local = (n, m, hi - lo, model.seq_slice(s_max)[1],
                model.kv_heads_of(s_max), cfg.hd)
    model.kv_lengths = {"k": s_max, "v": s_max}
    tok_axes = ("pod",) + R.as_axes(batch_axes)
    hops = {"sends": 0, "recvs": 0, "bytes": 0}
    h_shape = (hi - lo, 1, cfg.d_model)

    def transport() -> torch.device:
        """Where a hop's buffer lives: the host for gloo on the card."""
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("the rank-side PP step needs an initialised "
                               "torch.distributed world (launch/mesh.py)")
        if dist.get_backend() == "gloo" and dev.type == "cuda":
            return torch.device("cpu")
        return dev

    def serve_step(params: Dict, cache: Dict, tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict]:
        import torch.distributed as dist
        ck, cv = cache["k"], cache["v"]
        for key, t in (("k", ck), ("v", cv)):
            if t.dtype != kv_dt or tuple(t.shape) != kv_local:
                raise ValueError(f"PP serve_step: cache[{key!r}] is "
                                 f"{t.dtype} {tuple(t.shape)}, the rank's "
                                 f"step was built for {kv_dt} {kv_local} "
                                 f"(PPBuiltStep.shard_cache / store_cache)")
        where = transport() if n_stages > 1 else dev
        layers = [_tree_map(params["layers"], lambda a: a[j])
                  for j in range(n)]
        pos = cache["pos"].to(dev, torch.int32).reshape(1).expand(
            hi - lo).contiguous()
        tokens_m = tokens.to(dev).reshape(m, mb, 1)[:, lo:hi]
        recvs = []
        if stage > 0:
            src = mesh.rank_at(pod=stage - 1)
            for i in range(m):
                buf = torch.empty(h_shape, dtype=model.dtype, device=where)
                recvs.append((dist.irecv(buf, src, tag=i), buf))
        sends, logits = [], []
        outs = torch.zeros((m, mb), dtype=torch.int32, device=dev)
        for i in range(m):                   # tick stage + i
            if stage == 0:
                x = model.embed(params, tokens_m[i])
            else:
                work, buf = recvs[i]
                work.wait()
                x = buf.to(dev)
                hops["recvs"] += 1
            for j, p in enumerate(layers):
                x = model._dense_layer_decode(p, x, pos, ck[j, i], cv[j, i])
            if stage < last:
                buf = x.to(where).contiguous()
                sends.append((dist.isend(buf, mesh.rank_at(pod=stage + 1),
                                         tag=i), buf))
                hops["sends"] += 1
                hops["bytes"] += buf.numel() * buf.element_size()
                continue
            lg = model.logits(params, model.norm(x, params["final_norm"]))
            logits.append(lg)
            outs[i, lo:hi] = model.sample_greedy(lg)[:, 0].to(torch.int32)
        for work, _ in sends:
            work.wait()
        built.last_logits = torch.cat(logits) if logits else None
        outs = sharder.reduce(outs, tok_axes)
        cache["pos"] = cache["pos"] + 1
        return outs.reshape(b, 1), cache

    lmax = max(split)
    full = model.param_shapes()
    packed = dict(full, layers=_tree_map(
        full["layers"], lambda s: (n_stages, lmax) + tuple(s[1:])),
        pp_mask=(n_stages, lmax))
    kv_spec = TensorSpec((n_stages, lmax, m, mb, s_max, cfg.n_kv_heads,
                          cfg.hd), kv_dt)
    held = _held(cfg, stage, n_stages)
    local = {k: v for k, v in model.local_param_shapes().items()
             if k in held}
    local["layers"] = _tree_map(local["layers"],
                                lambda s: (n,) + tuple(s[1:]))
    meta = {"rules": rules, "model": model, "sharder": sharder,
            "rows": slice(lo, hi), "batch_axes": batch_axes,
            "pp_split": split, "n_microbatches": m, "stage": stage,
            "layer_offset": sum(split[:stage]), "held": held, "hops": hops,
            "kv_cache_dtype": FP8_DTYPES[kv_cache_dtype]
            if kv_cache_dtype else None, "weight_dtype": None}
    built = PPBuiltStep(
        fn=serve_step,
        args_shapes=(packed, {"k": kv_spec, "v": kv_spec,
                              "pos": TensorSpec((), torch.int32)},
                     TensorSpec((b, 1), torch.int32)),
        in_shardings=(local, {"k": kv_local, "v": kv_local, "pos": ()},
                      (b, 1)),
        meta=meta)
    return built
