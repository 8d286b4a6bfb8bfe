"""The ``seq`` rule (sequence-split activations) in the port's prefill step,
``extra_rules`` on every step (fault C8) and K/V leaves the ``cache_seq``
axes do not divide (fault C7), against the JAX package.

Without ranks:

- (a) for every config of the JAX package, meshes (1, 2), (2, 2), (1, 4)
  and ``extra_rules`` of ``{"seq": ("model",)}``, ``{"seq": None}`` and
  ``{"cache_seq": ("model",)}``, the prefill and serve steps'
  ``meta["rules"]`` equal the reference's ``build_step``'s, and their
  local K/V cache shapes what the reference's ``resolve`` gives under
  them; the same for the PP serve step on (2, 1, 2);
- (b) a leaf whose length the ``cache_seq`` axes do not divide stays
  whole, at the heads ``resolve`` gives it;
- (c) the train step builds with a ``seq`` that resolves to a mesh axis
  and records the cut (``tests/test_torch_seq_train.py`` runs it).

With ranks, one gloo world per mesh shape running every case:

- (d) the dense 6 / 3-head, qwen2-vl, granite-moe, mamba2, zamba2 and
  whisper 6-head reduced configs through ``build_step``'s prefill step
  with ``{"seq": ("model",)}`` and serve steps, on meshes (1, 2), (2, 2)
  and (1, 4), against the reference's unsharded model: tokens equal,
  logits within fp32 2e-5, each rank's cache its ``shard_cache`` of the
  reference's, the residual stream a rank holds of the shape
  ``resolve(("batch", "seq", None))`` gives, and the prefill's
  collectives equal to a written reckoning; granite-moe and zamba2 once
  more with ``cache_seq`` forced onto the serve step, whose KV heads the
  model axis divides (the decode gathers each token's KV heads);
- (e) fault C7: whisper 6-head and the dense 6 / 3-head config with a
  ``max_len`` and encoder frames that the model axis does not divide, at
  (1, 4) and (1, 2), against the reference's unsharded model, each rank's
  local cache shapes as ``resolve`` gives them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.steps as jsteps
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import get_config as jax_config
from repro.configs.shapes import ShapeSpec as JShapeSpec
from repro.models import build_model as jax_build
from repro.models import input_specs as jax_input_specs
from repro.sharding import rules as JR
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import pipeline as pp
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import mesh_for_rank, run_ranks
from repro_torch.models.transformer import KV_KEYS

ATOL = RTOL = 2e-5
AXES = ("data", "model")
EXTRAS = ({"seq": ("model",)}, {"seq": None}, {"cache_seq": ("model",)})


def _jmesh(shape, axes):
    n = int(np.prod(shape))
    devs = np.array(jax.devices() * (n // len(jax.devices()) + 1))[:n]
    return jax.sharding.Mesh(devs.reshape(shape), axes)


def _ref_local(names, shape, rules, jmesh):
    """The local shape ``resolve`` gives a tensor of ``shape`` named
    ``names`` under ``rules``."""
    spec = JR.resolve(names, shape, rules, jmesh)
    out = []
    for dim, e in zip(shape, spec):
        n = 1
        for a in (() if e is None else (e,) if isinstance(e, str) else e):
            n *= jmesh.shape[a]
        out.append(dim // n)
    return tuple(out)


def _port_local(model, shape):
    """The port's local shape of a K/V leaf of global ``shape``."""
    rows = model.sharder.local_shape(("batch",), (shape[1],))[0]
    s = shape[2]
    return (shape[0], rows, model.seq_slice(s)[1], model.kv_heads_of(s),
            shape[4])


# (a) -----------------------------------------------------------------------------
S_LEN, ROWS = 16384, 8        # the qwen3-32b / llama prefill at data 1 turns
#                               the seq rule on by itself (act_gb > 1)


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2), (1, 4)])
@pytest.mark.parametrize("arch", sorted(JAX_REGISTRY))
def test_extra_rules_reach_every_step_as_in_the_reference(arch, mesh_shape):
    jcfg, cfg = jax_config(arch), get_config(arch)
    jm = _jmesh(mesh_shape, AXES)
    names = jax_build(jcfg).cache_specs()
    kv_shapes = jax_input_specs(jcfg, JShapeSpec("d", S_LEN, ROWS,
                                                 "serve_step"))["cache"]
    seen_seq = set()
    for extra in ({},) + EXTRAS:
        for step in ("prefill_step", "serve_step"):
            want = jsteps.build_step(jcfg, JShapeSpec("x", S_LEN, ROWS, step),
                                     jm, extra_rules=extra).meta["rules"]
            built = S.build_step(cfg, ShapeSpec("x", S_LEN, ROWS, step),
                                 mesh_for_rank(mesh_shape, AXES, 0),
                                 extra_rules=extra, device="cpu")
            assert built.meta["rules"] == want, (arch, step, extra)
            assert built.meta["sharder"].rules == want
            seen_seq.add(want["seq"])
            for key in KV_KEYS:
                if key not in names:
                    continue
                shape = tuple(kv_shapes[key].shape)
                got = _port_local(built.model, shape)
                assert got == _ref_local(names[key], shape, want, jm), (
                    arch, mesh_shape, step, extra, key)
                if step == "serve_step":
                    assert tuple(built.in_shardings[1][key]) == got
    assert None in seen_seq and ("model",) in seen_seq


@pytest.mark.parametrize("arch", [a for a in sorted(JAX_REGISTRY)
                                  if pp.pp_supported(get_config(a))])
def test_extra_rules_reach_the_pp_step_as_in_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    mesh_shape, axes = (2, 1, 2), ("pod", "data", "model")
    jm = _jmesh(mesh_shape, axes)
    shape = ShapeSpec("d", S_LEN, ROWS, "serve_step")
    names = ("pp_stage", "layers", None, "batch", "cache_seq", "kv_heads",
             "head_dim")
    for extra in EXTRAS:
        want = jsteps.build_step(jcfg, JShapeSpec("d", S_LEN, ROWS,
                                                  "serve_step"), jm,
                                 serve_pp=True, extra_rules=extra)
        built = S.build_step(cfg, shape, mesh_for_rank(mesh_shape, axes, 0),
                             serve_pp=True, extra_rules=extra, device="cpu")
        assert built.meta["rules"] == want.meta["rules"], (arch, extra)
        full = tuple(built.args_shapes[1]["k"].shape)
        ref = _ref_local(names, full, want.meta["rules"], jm)
        # the stage holds its own layers (want: the padded lmax); the rest
        assert tuple(built.in_shardings[1]["k"])[1:] == ref[2:], extra


# (b) -----------------------------------------------------------------------------
@pytest.mark.parametrize("length", [4096, 4097, 4098, 1500])
@pytest.mark.parametrize("arch,mesh_shape", [("whisper-tiny", (1, 4)),
                                             ("whisper-tiny", (1, 8)),
                                             ("qwen3-32b", (1, 2)),
                                             ("qwen3-32b", (2, 4))])
def test_a_leaf_the_axes_do_not_divide_stays_whole(arch, mesh_shape,
                                                   length):
    """Any length, the prefill's rule (``cache_seq`` always): the leaf is
    cut where the model axis divides it, else kept whole at the heads
    ``resolve`` gives ``kv_heads`` (whisper's 1500 encoder frames cut at
    model 4, whole at model 8)."""
    jcfg, cfg = jax_config(arch), get_config(arch)
    jm = _jmesh(mesh_shape, AXES)
    rules = jsteps.build_rules(jcfg, jm, False, step="prefill_step")
    model = S.build_step(cfg, ShapeSpec("p", length, ROWS, "prefill_step"),
                         mesh_for_rank(mesh_shape, AXES, 0),
                         device="cpu").model
    shape = (cfg.n_layers, ROWS, length, cfg.n_kv_heads, cfg.hd)
    names = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    want = _ref_local(names, shape, rules, jm)
    assert _port_local(model, shape) == want
    assert model.seq_cuts(length) == (length % mesh_shape[1] == 0)
    meta = torch.empty(shape, device="meta")
    assert tuple(model.cache_part(meta, 2, 3).shape)[2:4] == want[2:4]


# (c) -----------------------------------------------------------------------------
def test_the_train_step_refuses_a_seq_rule():
    """Named for the refusal the train step made before it followed the
    rule: it now builds with a ``seq`` rule and records the cut (the
    layout's ``seq`` axes, the model's cut of a microbatch's rows)."""
    cfg = get_config("qwen3-32b").reduced()
    shape = ShapeSpec("t", 16, 4, "train_step")
    mesh = mesh_for_rank((1, 2), AXES, 0)
    built = S.build_step(cfg, shape, mesh, extra_rules={"seq": ("model",)},
                         device="cpu")
    assert built.meta["rules"]["seq"] == ("model",)
    assert built.layout.seq == "model"
    rows = built.meta["rows"]
    assert built.model.train_seq_axes(
        {"targets": torch.zeros((rows.stop - rows.start, 16))}) == "model"
    # a seq rule that resolves to no axis (the sequence does not divide
    # it) is no cut, and builds
    built = S.build_step(cfg, ShapeSpec("t", 15, 4, "train_step"), mesh,
                         extra_rules={"seq": ("model",)}, device="cpu")
    assert built.meta["rules"]["seq"] == ("model",)
    assert built.layout.seq is None


# (d), (e) -------------------------------------------------------------------------
B, STEPS = 4, 2
SEQ = {"seq": ("model",)}
CASES = {
    # name: (arch, overrides, prompt, max_len, encoder frames, extra_rules)
    "odd_heads": ("qwen3-32b", {"n_heads": 6, "n_kv_heads": 3}, 8, 16, 0,
                  SEQ),
    "vlm": ("qwen2-vl-2b", {}, 8, 16, 0, SEQ),
    "moe": ("granite-moe-3b-a800m", {}, 8, 16, 0, SEQ),
    "ssm": ("mamba2-1.3b", {}, 8, 16, 0, SEQ),
    "hybrid": ("zamba2-2.7b", {}, 8, 16, 0, SEQ),
    "encdec_6": ("whisper-tiny", {"n_heads": 6, "n_kv_heads": 6}, 8, 16, 8,
                 SEQ),
    # the serve cache cut by sequence where the KV heads divide the model
    # axis (a decoded token's KV heads gathered before its write)
    "moe_cut": ("granite-moe-3b-a800m", {}, 8, 16, 0,
                dict(SEQ, cache_seq=("model",))),
    "hybrid_cut": ("zamba2-2.7b", {}, 8, 16, 0,
                   dict(SEQ, cache_seq=("model",))),
}
# fault C7: lengths no model axis of 2 or 4 divides (the prompt's too, so
# the seq rule stays off: the caches alone are under test)
C7_CASES = {
    "encdec_6": ("whisper-tiny", {"n_heads": 6, "n_kv_heads": 6}, 7, 17, 9,
                 None),
    "odd_heads": ("qwen3-32b", {"n_heads": 6, "n_kv_heads": 3}, 7, 17, 0,
                  None),
}


def _flat_np(tree):
    if isinstance(tree, dict):
        return {k: _flat_np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _inputs(cfg, prompt, frames, rng):
    if cfg.frontend == "vision_embeds":
        t = np.arange(prompt)
        pos = np.stack([t, t // 2, t % 3 + t // 3])
        return {"embeds": rng.randn(B, prompt, cfg.d_model)
                .astype(np.float32),
                "positions": np.broadcast_to(pos[:, None], (3, B, prompt))
                .astype(np.int32).copy()}
    inputs = {"tokens": rng.randint(0, cfg.vocab, (B, prompt))
              .astype(np.int32)}
    if cfg.is_encdec:
        inputs["embeds"] = rng.randn(B, frames, cfg.d_model).astype(
            np.float32)
    return inputs


def _reference(arch, over, prompt, max_len, frames, extra):
    """The reference's unsharded prefill and ``STEPS`` greedy decode
    steps."""
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **over)
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    model = jax_build(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    inputs = _inputs(cfg, prompt, frames, np.random.RandomState(7))
    logits, cache = jax.jit(lambda p, i: model.prefill(p, i, max_len=max_len))(
        params, {k: jnp.asarray(v) for k, v in inputs.items()})
    cur = model.sample_greedy(logits).reshape(B, 1).astype(jnp.int32)
    dec = jax.jit(model.decode_step)
    toks, step_logits = [cur], []
    for _ in range(STEPS):
        lg, cache = dec(params, cache, cur)
        cur = model.sample_greedy(lg).reshape(B, 1).astype(jnp.int32)
        toks.append(cur)
        step_logits.append(lg)
    host = {k: (torch.full((B,), int(v), dtype=torch.int32) if k == "pos"
                else torch.from_numpy(np.array(v)))
            for k, v in cache.items()}
    return dict(cfg=cfg, jcfg=jcfg, params=_flat_np(params), inputs=inputs,
                cache=host, logits=np.asarray(logits), max_len=max_len,
                prompt=prompt, frames=frames, extra=extra,
                tokens=np.asarray(jnp.concatenate(toks, 1)),
                step_logits=np.asarray(jnp.concatenate(step_logits, 1)))


@pytest.fixture(scope="module")
def references():
    return {n: _reference(*c) for n, c in CASES.items()}


@pytest.fixture(scope="module")
def c7_references():
    return {n: _reference(*c) for n, c in C7_CASES.items()}


def _world_cases(refs):
    return [dict(cfg=r["cfg"], inputs=r["inputs"], steps=STEPS,
                 max_len=r["max_len"], params=r["params"],
                 extra_rules=r["extra"]) for r in refs.values()]


def _reckoning(cfg, mesh_shape, prompt, frames):
    """The collectives of one prefill step with the sequence cut over
    ``model`` (n ranks; ``prompt`` and ``frames`` multiples of n), written
    out. A block that needs the whole sequence gathers it (one all_gather):
    every attention and Mamba2 mixer, every MoE (its router sees every
    token), an FFN whose columns split. A row-parallel product whose rows
    split (``wo`` of split heads, ``w_down`` of split columns, ``w_out`` of
    split SSD heads) and the vocab-parallel embedding reduce-scatter their
    sums into the rank's slice; the rest slice their own result. The
    encoder-decoder gathers the encoder's output once, and its
    cross-attention gathers the decoder's sequence only where its heads
    split. all_reduce: the last position's hidden state (one), the
    vocab-parallel logits, the Mamba2 gated norm's sums of squares a layer
    whose SSD heads split, the MoE's capacity queues a layer and the
    tokens' rows under a batch split. all_to_all: one a K/V leaf where the
    KV heads split (the cache cut by sequence from the heads projected)."""
    data, n = mesh_shape

    def split(x):
        return int(x % n == 0)
    heads, ffn, vocab = split(cfg.n_heads), split(cfg.d_ff), split(
        cfg.padded_vocab)
    kv = split(cfg.n_kv_heads) if cfg.n_kv_heads else 0
    rows = int(data > 1)
    embed_rs = vocab
    gathers = rs = 0
    reduces = 1 + vocab + rows
    leaves = 0
    if cfg.is_encdec:
        per = 1 + ffn                                     # attention, FFN
        gathers += cfg.n_encoder_layers * per + 1
        rs += cfg.n_encoder_layers * (heads + ffn)
        gathers += cfg.n_layers * (1 + heads + ffn)       # self, cross, FFN
        rs += cfg.n_layers * (2 * heads + ffn)
        leaves = 4
    elif cfg.family in ("ssm", "hybrid"):
        ssm = split(cfg.ssm_heads)
        gathers += cfg.n_layers
        rs += cfg.n_layers * ssm
        reduces += cfg.n_layers * ssm
        apps = len(cfg.shared_attn_positions()) if cfg.n_heads else 0
        gathers += apps * (1 + ffn)
        rs += apps * (heads + ffn)
        leaves = 2 if apps else 0
    else:
        moe = cfg.n_experts > 0
        gathers += cfg.n_layers * (1 + (ffn or moe))
        rs += cfg.n_layers * (heads + ffn)
        reduces += cfg.n_layers * moe * rows
        leaves = 2
        if cfg.frontend == "vision_embeds":
            embed_rs = 0
    return {"gather_calls": gathers, "rs_calls": rs + embed_rs,
            "calls": reduces, "a2a_calls": leaves * kv}


def _check_world(refs, mesh_shape, outs, seq: bool):
    n = mesh_shape[1]
    for rank, per_case in enumerate(outs):
        mesh = mesh_for_rank(mesh_shape, AXES, rank)
        for name, got in zip(refs, per_case):
            ref = refs[name]
            cfg = ref["cfg"]
            lo, hi = got["rows"]
            where = f"{name} rank {rank}"
            np.testing.assert_array_equal(got["tokens"], ref["tokens"],
                                          err_msg=where)
            np.testing.assert_allclose(got["prefill_logits"],
                                       ref["logits"][lo:hi], atol=ATOL,
                                       rtol=RTOL, err_msg=where)
            np.testing.assert_allclose(got["logits"],
                                       ref["step_logits"][lo:hi], atol=ATOL,
                                       rtol=RTOL, err_msg=where)
            srv = S.build_step(cfg, ShapeSpec("d", ref["max_len"], B,
                                              "serve_step"), mesh,
                               extra_rules=ref["extra"], device="cpu")
            want = srv.shard_cache(ref["cache"])
            assert set(got["cache"]) == set(want), where
            for key in want:
                if key == "pos":
                    continue
                np.testing.assert_allclose(got["cache"][key],
                                           want[key].float().numpy(),
                                           atol=ATOL, rtol=RTOL,
                                           err_msg=f"{where} {key}")
            # the local K/V shapes are resolve's under the serve rules
            jm = _jmesh(mesh_shape, AXES)
            rules = jsteps.build_step(
                ref["jcfg"], JShapeSpec("d", ref["max_len"], B,
                                        "serve_step"), jm,
                extra_rules=ref["extra"]).meta["rules"]
            names = jax_build(ref["jcfg"]).cache_specs()
            for key in KV_KEYS:
                if key in want:
                    full = tuple(ref["cache"][key].shape)
                    assert got["cache"][key].shape == _ref_local(
                        names[key], full, rules, jm), f"{where} {key}"
            # the residual stream the prefill ended with
            d = cfg.d_model
            prefill_rules = dict(jsteps.build_rules(
                ref["jcfg"], jm, False, step="prefill_step"),
                **(ref["extra"] or {}))
            res = _ref_local(("batch", "seq", None), (B, ref["prompt"], d),
                             prefill_rules, jm)
            assert tuple(got["residual_shape"]) == res, where
            assert (res[1] < ref["prompt"]) == (seq and n > 1)
            if seq:
                stats = got["layout_collectives"]["prefill"]
                counted = {k: stats[k] for k in ("gather_calls", "rs_calls",
                                                 "calls", "a2a_calls")}
                assert counted == _reckoning(cfg, mesh_shape, ref["prompt"],
                                             ref["frames"]), (where, counted)


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2), (1, 4)])
def test_world_prefills_sequence_split_activations_as_the_reference(
        references, mesh_shape):
    outs = run_ranks(S.serve_cases, mesh_shape, AXES,
                     args=(_world_cases(references),))
    _check_world(references, mesh_shape, outs, seq=True)


@pytest.mark.parametrize("mesh_shape", [(1, 4), (1, 2)])
def test_world_keeps_leaves_the_axes_do_not_divide_whole(c7_references,
                                                        mesh_shape):
    outs = run_ranks(S.serve_cases, mesh_shape, AXES,
                     args=(_world_cases(c7_references),))
    _check_world(c7_references, mesh_shape, outs, seq=False)
    # the prefill's cache_seq rule holds and nothing is cut: every leaf
    # keeps its 17 positions (whisper's cross cache its 9 frames)
    for per_case in outs:
        for name, got in zip(c7_references, per_case):
            for key, t in got["cache"].items():
                if key in KV_KEYS:
                    assert t.shape[2] in (17, 9), (name, key, t.shape)
