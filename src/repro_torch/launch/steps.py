"""Step builders over a mesh of ranks (port of ``repro/launch/steps.py``).

``build_step(cfg, shape, mesh)`` gives THIS rank its part of a serving
cell:

  * ``prefill_step(params, inputs)``   -> (greedy tokens (B,), cache)
  * ``serve_step(params, cache, tokens)`` -> (greedy tokens (B, 1), cache)

``params`` and the cache are the rank's local shards (``BuiltStep``'s
``init_params`` / ``shard_params`` / ``shard_cache`` make them, or the
prefill step the cache); ``inputs``
and ``tokens`` are the whole batch, of which each rank serves the rows
the ``batch`` rule gives it (split over ``data``), and the full tokens
come back on every rank (the rows gathered by one all_reduce of a
zero-filled buffer). The model runs Megatron-style tensor parallelism over
``model`` (``models/transformer.py``), decided by the reference's rule
tables through ``build_rules``, a copy of the reference's.

The KV cache follows the reference's ``cache_seq`` rule. A prefill step's
cache, and a serve step's wherever the KV heads do not divide ``model``,
is cut by sequence over ``model``: each rank holds every KV head of its
slice of the positions (``resolve`` gives ``cache_seq`` the axis before
``kv_heads``). The prefill reaches it by one all_to_all of the K/V heads
it projected (or by slicing, where every rank projects every KV head); a
serve step on such a cache writes each token on the rank that holds its
position, gathers the query heads, runs the decode kernel with its
log-sum-exp output on the rank's slice and merges the slices' fp32
partials (``TensorParallel._split_attention``). Where the KV heads divide
``model`` the serve step lays the cache out by heads, and
``BuiltStep.store_cache`` moves a prefill's cache there (one all_to_all
a leaf). A leaf whose length the axes do not divide stays whole, as
``resolve`` keeps it (``TensorParallel.seq_cuts``); a serve step decides
the cut of the encoder-decoder's cross cache for ``shape.seq_len``
encoder frames, the length the reference's ``input_specs`` gives it.

The prefill step follows the ``seq`` rule, which ``build_rules`` sets for
a prefill whose residual stream passes ~1 GB a chip (or ``extra_rules``
sets): its activations are cut by sequence over ``model``, Megatron-style
(``models/transformer.py``): each block gathers the whole sequence, runs
at its local heads or columns, and reduce-scatters its row-parallel
partials into the rank's slice. At a serve step's one token ``resolve``
drops the rule. ``extra_rules`` go on top of ``build_rules`` for every
step, as in the reference; a train step follows an ``extra_rules``
``seq`` too, each collective with its backward.

Every family runs: dense, VLM, MoE, the SSM and hybrid (the Mamba2 mixer
split by whole SSD heads) and the encoder-decoder. The counterpart of
``lower_step`` is ``launch/op_costs.py``'s trace of a rank's step on
fake tensors in a fake world (``launch/dryrun.py``).

A ``train_step`` shape gives THIS rank's train step
(``launch/train_mesh.py``), ``fn(state, batch) -> (state, metrics)``: FSDP
over ``data`` and tensor parallelism over ``model`` under
``build_rules(train=True)``. The rank holds its FSDP shard of ``params``,
``m`` and ``v`` (``TrainBuiltStep.init_state`` / ``shard_state`` /
``gather_state``); each microbatch (or, with ``gather_weights_once``,
each step) gathers the shards over ``data`` into the tensor-parallel
layout the serving steps run (the reference's ``gathered_rules``), takes
the rank's rows of the whole batch it is given, and sums the gradients
over the batch axes in fp32 before they are cut back to the shard and
rounded. A checkpoint saved from one mesh restores onto another through
``train/checkpoint.restore_checkpoint(shardings=built.state_shardings())``
(the elastic path, ``train/elastic.py``).

``serve_pp=True`` on a mesh with a ``pod`` axis builds the serve step as
the reference does, pipeline parallel over ``pod``: each rank is one
stage (its ``pod`` coordinate) holding only its layers of the
estimator's uneven split, tensor parallel over ``model`` inside the
stage and serving its rows of each microbatch over ``data``
(``launch/pipeline.py``, ``build_pp_serve_step`` with a mesh). The hidden
state hops between the stages' ranks by ``isend`` / ``irecv``: over
nccl device to device, over gloo through a host buffer (gloo sends CPU
tensors only). The families the reference's PP step refuses (recurrent
state, sliding windows, the encoder-decoder) raise ``ValueError``.
``weight_dtype`` and ``kv_cache_dtype`` reach the serve step only, as in
the reference: a prefill step's params and cache stay in the model's
dtype.

``kv_cache_dtype`` (``"float8_e4m3fn"`` / ``"float8_e5m2"``) stores the
serve step's cache in fp8 by the reference's rule (every leaf of the
model's dtype with five or more dimensions, its ``maybe_q``), written by
``common.astype`` and read by the contiguous decode kernel as stored.
``BuiltStep.store_cache`` stores a prefilled cache so. Where the
reference's serve step cannot run on such a cache, the build refuses,
naming the reference's failing line: the encoder-decoder, and a model
whose recurrent state the rule would quantize (fp32 Mamba2 / Zamba2).

``serve_generate`` is a rank-side runner for ``launch.mesh.run_ranks``: a
prefill and greedy serve steps, their tokens, logits and cache
(``serving_steps`` builds a rank's steps and params for callers that
drive the steps themselves). With ``serve_pp`` it drives the PP step
from a given cache instead of a prefill (neither package has a PP
prefill).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.api import TensorSpec, build_model, input_specs
from repro_torch.models.common import FP8_DTYPES, astype
from repro_torch.models.transformer import KV_KEYS, LM, cache_seq_axes
from repro_torch.sharding import rules as R


def build_rules(cfg: ArchConfig, mesh: Any, train: bool,
                step: str = "", shape: Optional[ShapeSpec] = None) -> Dict:
    multipod = "pod" in mesh.shape
    if train:
        rules = dict(R.TRAIN_RULES_MULTIPOD if multipod else R.TRAIN_RULES)
    else:
        rules = dict(R.INFER_RULES_MULTIPOD if multipod else R.INFER_RULES)
    model_size = mesh.shape["model"]
    # Sequence-parallel KV cache: (a) mandatory fallback when KV heads do
    # not divide the model axis; (b) always for prefill — the cache is
    # write-only there, so sequence sharding halves peak memory without
    # introducing softmax-side collectives.
    if not train and cfg.n_kv_heads and (
            cfg.n_kv_heads % model_size != 0 or step == "prefill_step"):
        rules["cache_seq"] = ("model",)
    # Sequence-sharded activations for big prefills: when the per-chip
    # residual stream exceeds ~1GB, shard the seq axis over model too.
    if step == "prefill_step" and shape is not None:
        data_size = mesh.shape.get("data", 1)
        act_gb = (shape.global_batch * shape.seq_len * cfg.d_model * 2
                  / max(1, data_size) / 1e9)
        if act_gb > 1.0 and shape.seq_len % model_size == 0:
            rules["seq"] = ("model",)
    return rules


def n_chips(mesh: Any) -> int:
    n = 1
    for v in mesh.shape.values():
        n *= v
    return n


def _quantized(dtype: torch.dtype, ndim: int, model_dtype: torch.dtype
               ) -> bool:
    """The reference's ``maybe_q``: a cache leaf ``kv_cache_dtype`` stores
    in fp8."""
    return dtype == model_dtype and ndim >= 5


@dataclasses.dataclass
class BuiltStep:
    fn: Callable                   # the step (positional args)
    args_shapes: Tuple[Any, ...]   # global TensorSpec trees per argument
    in_shardings: Tuple[Any, ...]  # this rank's local shapes per argument
    meta: Dict[str, Any]           # rules, model, sharder, rows
    last_logits: Optional[torch.Tensor] = None  # behind the last tokens

    @property
    def model(self):
        return self.meta["model"]

    def _store(self, params: Dict) -> Dict:
        """Weights in the storage dtype ``weight_dtype`` asks for."""
        qdt = self.meta.get("weight_dtype")
        if qdt is None:
            return params

        def walk(node):
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            if node.ndim >= 2 and node.dtype == self.model.dtype:
                return astype(node, qdt)
            return node
        return walk(params)

    def store_cache(self, cache: Dict) -> Dict:
        """A cache in the model's dtype (a prefill's, or this rank's
        ``shard_cache``) as the serve step takes it: a prefill's K/V cut
        by sequence moved into the serve step's layout by heads, where
        that is the serve step's (one all_to_all over ``model`` a leaf);
        then, with ``kv_cache_dtype``, every leaf the reference's rule
        names cast to it by ``astype`` (its ``maybe_q`` applied to the
        values), the rest as they are."""
        cache = self._serve_layout(cache)
        kdt = self.meta.get("kv_cache_dtype")
        if kdt is None:
            return cache
        return {k: astype(v, kdt)
                if _quantized(v.dtype, v.ndim, self.model.dtype) else v
                for k, v in cache.items()}

    def _serve_layout(self, cache: Dict) -> Dict:
        """``cache`` with every K/V leaf in the prefill step's layout (cut
        by sequence over ``meta["prefill_seq"]``) laid out by heads where
        the serve step's differs; leaves already holding the serve step's
        heads (a leaf the prefill kept whole, whatever its positions) stay
        as they are."""
        ax = self.meta.get("prefill_seq")
        if ax is None or self.model._seq_ax is not None:
            return cache
        want, sh = self.in_shardings[1], self.meta["sharder"]
        return {k: sh.all_to_all(v, ax, 3, 2)
                if k in KV_KEYS and v.shape[3] != want[k][3] else v
                for k, v in cache.items()}

    def shard_cache(self, full: Dict) -> Dict:
        """This rank's part of a full contiguous cache (its rows; its KV
        heads, or its slice of the positions where the cache is cut by
        sequence)."""
        return self.model.shard_cache(full, self.meta["rows"])

    def init_params(self, seed: int = 0) -> Dict:
        """This rank's local params, the unsplit ``init(seed)``'s numbers."""
        return self._store(self.model.init(seed=seed))

    def shard_params(self, full: Dict) -> Dict:
        """This rank's local params from the full tree (on its device)."""
        return self._store(self.model.shard_params(full))


def _row_inputs(inputs: Dict, rows: slice) -> Dict:
    """This rank's rows of a batch of inputs (M-RoPE positions carry the
    batch on their second axis)."""
    out = {}
    for k, v in inputs.items():
        if k == "positions" and v.ndim == 3:
            out[k] = v[:, rows]
        else:
            out[k] = v[rows]
    return out


def build_step(cfg: ArchConfig, shape: ShapeSpec, mesh: Any,
               serve_pp: bool = False, kv_cache_dtype: Optional[str] = None,
               weight_dtype: Optional[str] = None,
               n_microbatches: Optional[int] = None,
               extra_rules: Optional[Dict] = None,
               gather_weights_once: bool = False,
               remat_policy: Optional[str] = None,
               opt_cfg: Any = None,
               device: DeviceLike = None) -> BuiltStep:
    """This rank's prefill or serve step of ``(cfg, shape)`` on ``mesh``
    (the reference's ``build_step`` for its serving cells). ``device``:
    the rank's device (default: the card). ``weight_dtype``
    (``"float8_e4m3fn"`` / ``"float8_e5m2"``) stores a serve step's
    matrices in fp8, upcast each step; ``kv_cache_dtype`` stores its
    cache in fp8 (module docstring). The prefill step ignores both, as the
    reference's does. ``serve_pp`` on a mesh with a ``pod`` axis makes the
    serve step this rank's stage of the pipeline-parallel step
    (``launch/pipeline.py``'s ``build_pp_serve_step``, a
    ``PPBuiltStep``), which takes ``kv_cache_dtype`` and, as the
    reference's, no ``weight_dtype``.

    ``extra_rules`` go on top of ``build_rules``' rules for every step
    (``meta["rules"]``), as in the reference.

    A ``train_step`` shape gives this rank's train step
    (``launch/train_mesh.py``'s ``TrainBuiltStep``): the rules of
    ``build_rules(train=True)`` with ``extra_rules`` on top (a ``seq``
    that resolves to the model axis cuts each microbatch's activations
    by sequence, forward and backward, as the reference's GSPMD does),
    ``n_microbatches`` by default the reference's
    ``choose_microbatches`` over the mesh's chips, ``gather_weights_once``
    gathering the FSDP shards once a step instead of once a microbatch,
    ``remat_policy`` None or ``"save_block_out"`` (ignored by the
    encoder-decoder, as in the reference), ``opt_cfg`` the AdamW settings
    (default the reference's ``AdamWConfig()``, which its ``build_step``
    always uses). The serving steps take none of these five."""
    train = shape.step == "train_step"
    rules = build_rules(cfg, mesh, train, step=shape.step, shape=shape)
    rules.update(extra_rules or {})
    if train:
        from repro_torch.launch.train_mesh import build_train_step
        return build_train_step(cfg, shape, mesh, rules,
                                n_microbatches=n_microbatches,
                                gather_weights_once=gather_weights_once,
                                remat_policy=remat_policy, opt_cfg=opt_cfg,
                                device=device)
    if serve_pp and "pod" in mesh.shape and shape.step == "serve_step":
        from repro_torch.launch.pipeline import build_pp_serve_step
        return build_pp_serve_step(cfg, shape, mesh, rules,
                                   kv_cache_dtype=kv_cache_dtype,
                                   device=device)
    sharder = R.Sharder(mesh=mesh, rules=rules)
    b = shape.global_batch
    lo, hi = sharder.local_range(("batch",), (b,), 0)
    rows = slice(lo, hi)
    bspec = sharder.spec(("batch",), (b,))[0]
    batch_axes = bspec if sharder.size(bspec) > 1 else None
    dev = resolve_device(device)
    model = build_model(cfg, device=dev, sharder=sharder,
                        batch_axes=batch_axes)
    specs = input_specs(cfg, shape)
    lm = isinstance(model, LM)
    pshapes = model.local_param_shapes()
    meta = {"rules": rules, "model": model, "sharder": sharder,
            "rows": rows, "batch_axes": batch_axes}

    def gather_rows(tok: torch.Tensor) -> torch.Tensor:
        """The full batch's tokens from this rank's rows."""
        if batch_axes is None:
            return tok
        full = tok.new_zeros((b,) + tuple(tok.shape[1:]))
        full[rows] = tok
        return sharder.reduce(full, batch_axes)

    if shape.step == "prefill_step":
        ring = {"ring": True} if lm else {}

        def prefill_step(params, inputs):
            logits, cache = model.prefill(params, _row_inputs(inputs, rows),
                                          max_len=shape.seq_len, **ring)
            built.last_logits = logits
            tok = model.sample_greedy(logits).to(torch.int32)
            return gather_rows(tok), cache

        built = BuiltStep(
            fn=prefill_step, args_shapes=(model.param_shapes(), specs),
            in_shardings=(pshapes, {k: v.shape for k, v in specs.items()}),
            meta=meta)
        return built

    # serve_step
    qdt = FP8_DTYPES[weight_dtype] if weight_dtype else None
    meta["weight_dtype"] = qdt
    # this rank's cache layout, read from the meta device
    meta_model = build_model(cfg, device="meta", sharder=sharder,
                             batch_axes=batch_axes)
    kw = {"s_enc": shape.seq_len} if cfg.is_encdec else {"ring": True}
    local_cache = meta_model.init_cache(hi - lo, shape.seq_len, **kw)
    model.kv_lengths = dict(meta_model.kv_lengths)
    kdt = _kv_cache_dtype(cfg, kv_cache_dtype, local_cache, model.dtype)
    meta["kv_cache_dtype"] = kdt
    # the prefill step's cache layout, which ``store_cache`` moves from
    meta["prefill_seq"] = cache_seq_axes(cfg, R.Sharder(
        mesh=mesh, rules=dict(build_rules(cfg, mesh, False,
                                          step="prefill_step"),
                              **(extra_rules or {}))))
    cache_dtypes = {k: kdt if kdt is not None and _quantized(
        v.dtype, v.ndim, model.dtype) else v.dtype
        for k, v in local_cache.items()}

    def serve_step(params, cache, tokens):
        if qdt is not None:
            params = _upcast(params, qdt, model.dtype)
        for k, v in cache.items():
            if v.dtype != cache_dtypes.get(k, v.dtype):
                raise ValueError(f"serve_step: cache[{k!r}] is {v.dtype}, "
                                 f"the step was built for "
                                 f"{cache_dtypes[k]} (BuiltStep."
                                 f"store_cache stores a prefilled cache)")
            # the K/V layout: heads (every leaf), positions (the self
            # caches; a cross cache holds the encoder's frames)
            want = local_cache[k].shape if k in KV_KEYS else None
            if want is not None and (v.shape[3] != want[3] or (
                    k not in ("ck", "cv") and v.shape[2] != want[2])):
                raise ValueError(f"serve_step: cache[{k!r}] is "
                                 f"{tuple(v.shape)}, the step was built "
                                 f"for {tuple(want)} (BuiltStep."
                                 f"store_cache lays a prefill's cache out "
                                 f"for it)")
        logits, cache = model.decode_step(params, cache, tokens[rows])
        built.last_logits = logits
        nxt = model.sample_greedy(logits).to(torch.int32)
        return gather_rows(nxt), cache

    cache_specs = {k: TensorSpec(v.shape, cache_dtypes[k])
                   for k, v in specs["cache"].items()}
    built = BuiltStep(
        fn=serve_step, args_shapes=(model.param_shapes(), cache_specs,
                                    specs["tokens"]),
        in_shardings=(pshapes, {k: tuple(v.shape)
                                for k, v in local_cache.items()},
                      specs["tokens"].shape),
        meta=meta)
    return built


def _kv_cache_dtype(cfg: ArchConfig, name: Optional[str], cache: Dict,
                    model_dtype: torch.dtype) -> Optional[torch.dtype]:
    """The fp8 dtype ``kv_cache_dtype`` names, or None; refuses where the
    reference's serve step cannot run on the cache its rule quantizes."""
    if not name:
        return None
    if cfg.is_encdec:
        raise NotImplementedError(
            f"kv_cache_dtype={name!r} on the encoder-decoder {cfg.name}: "
            f"the reference's serve step fails there (its cross-attention "
            f"runs sdpa on the fp8 ck / cv, src/repro/models/encdec.py:333, "
            f"TypePromotionError)")
    if "ssd" in cache and _quantized(cache["ssd"].dtype, cache["ssd"].ndim,
                                     model_dtype):
        raise NotImplementedError(
            f"kv_cache_dtype={name!r} on {cfg.name} in {cfg.dtype}: the "
            f"reference's rule quantizes the fp32 SSD state, and its serve "
            f"step fails on it (src/repro/models/ssm.py:143, "
            f"TypePromotionError)")
    return FP8_DTYPES[name]


def _upcast(params: Dict, qdt: torch.dtype, dtype: torch.dtype) -> Dict:
    if isinstance(params, dict):
        return {k: _upcast(v, qdt, dtype) for k, v in params.items()}
    return params.to(dtype) if params.dtype == qdt else params


# ---------------------------------------------------------------------------
# rank-side runner
# ---------------------------------------------------------------------------
def serving_steps(mesh: Any, device: torch.device, cfg: ArchConfig,
                  batch: int, max_len: int, params: Optional[Dict] = None,
                  seed: int = 0, kv_cache_dtype: Optional[str] = None,
                  serve_pp: bool = False,
                  pod_flops: Optional[Sequence[float]] = None,
                  extra_rules: Optional[Dict] = None
                  ) -> Tuple[Optional[BuiltStep], BuiltStep, Dict]:
    """This rank's prefill and serve steps for ``batch`` rows and a cache
    of ``max_len`` positions (the serve step's in ``kv_cache_dtype``; both
    with ``extra_rules``), and
    its local params: the full numpy tree ``params`` sharded here, in the
    model's dtype, else the seeded init. With ``serve_pp`` (a mesh with a
    ``pod`` axis) there is no prefill step (None) and the serve step is
    the rank's PP stage: ``build_step(serve_pp=True)``'s, or, given
    ``pod_flops``, ``build_pp_serve_step``'s with them; the params are
    the stage's (``PPBuiltStep``; ``params`` may be
    the unsplit or the packed tree)."""
    from repro_torch.models.convert import _to_tensor
    srv_shape = ShapeSpec("serve", max_len, batch, "serve_step")
    if serve_pp:
        if pod_flops is None:
            srv = build_step(cfg, srv_shape, mesh, serve_pp=True,
                             kv_cache_dtype=kv_cache_dtype,
                             extra_rules=extra_rules, device=device)
        else:
            from repro_torch.launch.pipeline import build_pp_serve_step
            srv = build_pp_serve_step(
                cfg, srv_shape, mesh, dict(build_rules(
                    cfg, mesh, False, step="serve_step", shape=srv_shape),
                    **(extra_rules or {})),
                pod_flops=pod_flops, kv_cache_dtype=kv_cache_dtype,
                device=device)
        local = (srv.shard_params(params) if params is not None
                 else srv.init_params(seed))
        return None, srv, local
    pre = build_step(cfg, ShapeSpec("prefill", max_len, batch,
                                    "prefill_step"), mesh,
                     extra_rules=extra_rules, device=device)
    srv = build_step(cfg, srv_shape, mesh, kv_cache_dtype=kv_cache_dtype,
                     extra_rules=extra_rules, device=device)
    if params is not None:
        dt = pre.model.dtype
        local = pre.shard_params(_tree(
            params, lambda a: _to_tensor(a, device).to(dt)))
    else:
        local = pre.init_params(seed)
    return pre, srv, local


def serve_generate(mesh: Any, device: torch.device, cfg: ArchConfig,
                   inputs: Dict[str, np.ndarray], steps: int, max_len: int,
                   params: Optional[Dict] = None, seed: int = 0,
                   feed: Optional[np.ndarray] = None,
                   kv_cache_dtype: Optional[str] = None,
                   serve_pp: bool = False, cache: Optional[Dict] = None,
                   pod_flops: Optional[Sequence[float]] = None,
                   extra_rules: Optional[Dict] = None
                   ) -> Dict[str, Any]:
    """One rank's prefill of ``inputs`` (numpy, the whole batch) and
    ``steps`` greedy serve steps through ``serving_steps``; with ``feed``
    (B, steps) step i is fed ``feed[:, i]`` instead of the last greedy
    token; with ``kv_cache_dtype`` the prefilled cache is stored in fp8
    (``BuiltStep.store_cache``) before the first step. Returns numpy
    arrays: the greedy ``tokens`` (B, 1 + steps), this rank's ``rows``
    (lo, hi), its ``prefill_logits`` (rows, Vpad), ``logits`` (rows, steps,
    Vpad) and ``cache`` after the last step (every key the family's cache
    holds; bf16 and fp8 leaves as their exact fp32 values), the fp8
    leaves' raw bytes (``cache_bytes``, uint8), its local head counts
    (attention and SSD), the kernel ``launches`` (counts zeroed just
    before the prefill, read after the last step) and ``decode_attention``'s
    by the cache's dtype, the collectives of the serve steps
    (``allreduce``: ``Sharder.stats``) and, in ``layout_collectives``,
    those of the prefill step (``prefill``) and of ``store_cache``
    (``store``), and the prefill's ``residual_shape`` (this rank's).
    ``extra_rules`` go to both steps (``serving_steps``).

    ``serve_pp``: the PP serve step (``serving_steps``) from ``cache``,
    the whole start cache (the reference's PP layout or an unsplit
    contiguous one, numpy or tensors; ``k`` / ``v`` as uint8 are the
    bytes of ``kv_cache_dtype``, floats are cast to the model's dtype and
    stored by ``store_cache``), fed ``inputs["tokens"]`` (B, 1) first. The
    same keys but ``prefill_logits``, with ``rows`` the rank's rows of
    each microbatch, ``logits`` the last stage's (m * rows, steps, Vpad;
    None on the other stages) and besides ``stage``, ``pp_split``,
    ``n_microbatches`` and the ``hops`` (sends, receives, bytes) of the
    steps."""
    if serve_pp:
        return _pp_generate(mesh, device, cfg, inputs["tokens"], cache,
                            steps, max_len, params, seed, feed,
                            kv_cache_dtype, pod_flops, extra_rules)
    from repro_torch.kernels import ops
    b = (inputs["tokens"] if "tokens" in inputs else inputs["embeds"]
         ).shape[0]
    pre, srv, local = serving_steps(mesh, device, cfg, b, max_len, params,
                                    seed, kv_cache_dtype,
                                    extra_rules=extra_rules)
    x = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in inputs.items()}
    rows = pre.meta["rows"]
    sharder = srv.meta["sharder"]
    with torch.no_grad():
        ops.reset_launch_counts()
        pre.meta["sharder"].reset_stats()
        sharder.reset_stats()
        tok, cache = pre.fn(local, x)
        cache = srv.store_cache(cache)
        prefill_logits = pre.last_logits.float().cpu().numpy()
        layout = {"prefill": dict(pre.meta["sharder"].stats),
                  "store": dict(sharder.stats)}
        sharder.reset_stats()
        cur = tok.reshape(b, 1)
        toks, logits = [cur], []
        for i in range(steps):
            if feed is not None:
                cur = torch.from_numpy(np.ascontiguousarray(
                    feed[:, i:i + 1])).to(device=device, dtype=torch.int32)
            cur, cache = srv.fn(local, cache, cur)
            toks.append(cur)
            logits.append(srv.last_logits.float())
    return dict(_rank_result(pre.model, srv, cache, toks, ops),
                rows=(rows.start, rows.stop), layout_collectives=layout,
                residual_shape=pre.model.residual_shape,
                prefill_logits=prefill_logits,
                logits=torch.cat(logits, 1).cpu().numpy())


def _rank_result(model, srv: BuiltStep, cache: Dict, toks: list,
                 ops) -> Dict[str, Any]:
    """The keys every rank-side run returns (``serve_generate``)."""
    return {"tokens": torch.cat(toks, 1).cpu().numpy(),
            "cache": {k: (v.float() if v.is_floating_point() else v)
                      .cpu().numpy() for k, v in cache.items()},
            "cache_bytes": {k: v.view(torch.uint8).cpu().numpy()
                            for k, v in cache.items()
                            if v.dtype in FP8_DTYPES.values()},
            "n_heads_local": model.n_heads_local,
            "n_kv_local": model.n_kv_local,
            "ssm_heads_local": model.ssm_heads_local,
            "launches": ops.launch_counts(),
            "decode_lse_launches": ops.decode_lse_launches(),
            "decode_by_cache_dtype": ops.decode_launches_by_cache_dtype(),
            "allreduce": dict(srv.meta["sharder"].stats)}


def _pp_generate(mesh: Any, device: torch.device, cfg: ArchConfig,
                 tokens: np.ndarray, cache: Dict, steps: int, max_len: int,
                 params: Optional[Dict], seed: int,
                 feed: Optional[np.ndarray], kv_cache_dtype: Optional[str],
                 pod_flops: Optional[Sequence[float]],
                 extra_rules: Optional[Dict]) -> Dict[str, Any]:
    """``serve_generate`` with ``serve_pp``."""
    from repro_torch.kernels import ops
    if cache is None:
        raise ValueError("serve_generate(serve_pp=True) starts from a "
                         "given cache")
    b = tokens.shape[0]
    _, srv, local = serving_steps(mesh, device, cfg, b, max_len, params,
                                  seed, kv_cache_dtype, serve_pp=True,
                                  pod_flops=pod_flops,
                                  extra_rules=extra_rules)
    model = srv.model
    full = {}
    for k, v in cache.items():
        t = v if torch.is_tensor(v) else torch.from_numpy(
            np.ascontiguousarray(v))
        if k in ("k", "v") and t.dtype == torch.uint8 and kv_cache_dtype:
            t = t.view(FP8_DTYPES[kv_cache_dtype])
        elif t.is_floating_point() and t.dtype not in FP8_DTYPES.values():
            t = t.to(model.dtype)
        full[k] = t
    hops = srv.meta["hops"]
    with torch.no_grad():
        state = srv.store_cache(srv.shard_cache(full))
        del full
        ops.reset_launch_counts()
        srv.meta["sharder"].reset_stats()
        hops.update(dict.fromkeys(hops, 0))
        cur = torch.from_numpy(np.ascontiguousarray(tokens)).to(
            device=device, dtype=torch.int32)
        toks, logits = [cur], []
        for i in range(steps):
            if feed is not None:
                cur = torch.from_numpy(np.ascontiguousarray(
                    feed[:, i:i + 1])).to(device=device, dtype=torch.int32)
            cur, state = srv.fn(local, state, cur)
            toks.append(cur)
            if srv.last_logits is not None:
                logits.append(srv.last_logits.float())
    rows = srv.meta["rows"]
    return dict(_rank_result(model, srv, state, toks, ops),
                rows=(rows.start, rows.stop), stage=srv.meta["stage"],
                pp_split=srv.meta["pp_split"],
                n_microbatches=srv.meta["n_microbatches"],
                logits=(torch.cat(logits, 1).cpu().numpy() if logits
                        else None),
                hops=dict(hops))


def serve_cases(mesh: Any, device: torch.device, cases: list) -> list:
    """``serve_generate`` for each keyword dict of ``cases`` in one world
    (one world start for many checks)."""
    return [serve_generate(mesh, device, **case) for case in cases]


def _tree(node, fn):
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    return fn(node)
