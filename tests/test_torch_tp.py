"""Tensor parallelism over a mesh of ranks in the port
(``repro_torch.sharding``, ``repro_torch.launch.mesh``,
``repro_torch.launch.steps``) against the JAX package.

Without ranks: the port's rule tables, ``resolve`` and ``build_rules``
equal the reference's on every ``REGISTRY`` config, rule table and mesh
(the reference side on ``tests/test_sharding_hlo.py``'s fake meshes of one
host device, the port's on a stand-in with ``.shape``); ``tree_shard``'s
slices put back together give every full tensor; the MoE's queue share
reproduces the unsplit layer's capacity drops; the refusals name their
ROADMAP items; a one-rank mesh and fp8-stored weights.

With ranks: one spawned gloo world per mesh shape, (1,2), (2,2) and (1,4),
each running ``build_step``'s prefill and four greedy serve steps for a
dense config, the VLM (qkv bias, tied embeddings, a prefill from
embeddings under distinct M-RoPE streams), an MoE config and a config
whose 6 heads / 3 KV heads divide no model axis evenly in groups, all
``.reduced()`` fp32, from the reference's params (numpy, carried across as
``models/convert.py`` does): prefill and step logits within 2e-5 of the
reference's unsharded ``prefill`` / ``decode_step``, greedy tokens
identical, each rank's cache after the last step equal to its
``shard_cache`` of the reference's. A (1,2) world of its own runs
``calibrate_allreduce`` over the model group as a real all_reduce.
"""

import collections
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import repro.launch.steps as jsteps
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import get_config as jax_config
from repro.configs.shapes import ALL_SHAPES as JAX_SHAPES
from repro.models import build_model as jax_build
from repro.models import input_specs as jax_input_specs
from repro.sharding import rules as JR
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ALL_SHAPES, ShapeSpec
from repro_torch.hw.calibration import calibrate_model_allreduce
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import mesh_for_rank, run_ranks
from repro_torch.models import build_model
from repro_torch.models import moe as moe_mod
from repro_torch.sharding import rules as R

ATOL = RTOL = 2e-5
MESHES = [((2, 4), ("data", "model")), ((1, 4), ("data", "model")),
          ((2, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]
TABLES = ["INFER_RULES", "INFER_RULES_MULTIPOD", "TRAIN_RULES",
          "TRAIN_RULES_MULTIPOD"]


def fake_mesh(shape, axes):
    devs = np.array(jax.devices() * (int(np.prod(shape)) // len(
        jax.devices()) + 1))[: int(np.prod(shape))]
    return JaxMesh(devs.reshape(shape), axes)


def stand_in(shape, axes):
    return types.SimpleNamespace(
        shape=collections.OrderedDict(zip(axes, shape)))


def _is_names(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _pairs(specs, shapes):
    """(names, shape) for every leaf of a spec tree and its shape tree."""
    if _is_names(specs):
        return [(specs, tuple(shapes.shape))]
    out = []
    for k in specs:
        out += _pairs(specs[k], shapes[k])
    return out


def _resolve_both(names, shape, table, mesh_shape, axes):
    try:
        want = tuple(JR.resolve(names, shape, getattr(JR, table),
                                fake_mesh(mesh_shape, axes)))
    except KeyError:
        with pytest.raises(KeyError):
            R.resolve(names, shape, getattr(R, table),
                      stand_in(mesh_shape, axes))
        return
    got = R.resolve(names, shape, getattr(R, table),
                    stand_in(mesh_shape, axes))
    assert got == want, (names, shape, table, mesh_shape, got, want)


def test_rule_tables_equal_the_reference():
    for table in TABLES:
        assert getattr(R, table) == getattr(JR, table), table


@pytest.mark.parametrize("arch", sorted(JAX_REGISTRY))
def test_resolve_equals_reference_on_param_and_cache_specs(arch):
    jcfg = jax_config(arch)
    jmodel = jax_build(jcfg)
    pairs = _pairs(jmodel.param_specs(), jmodel.param_shapes())
    cache = jax_input_specs(jcfg, ShapeSpec("d", 1024, 8, "serve_step"))
    pairs += [p for p in _pairs(jmodel.cache_specs(), cache["cache"])
              if p[0]]
    if not jcfg.is_encdec:
        model = build_model(get_config(arch), device="meta")
        assert model.param_specs() == jmodel.param_specs()
        assert model.cache_specs() == jmodel.cache_specs()
    for mesh_shape, axes in MESHES:
        for table in TABLES:
            for names, shape in pairs:
                _resolve_both(names, shape, table, mesh_shape, axes)


@pytest.mark.parametrize("arch", sorted(JAX_REGISTRY))
def test_build_rules_equal_reference(arch):
    jcfg, cfg = jax_config(arch), get_config(arch)
    for (mesh_shape, axes) in MESHES:
        jm, pm = fake_mesh(mesh_shape, axes), stand_in(mesh_shape, axes)
        assert S.n_chips(pm) == jsteps.n_chips(jm)
        for jshape, shape in zip(JAX_SHAPES, ALL_SHAPES):
            for train in (False, True):
                want = jsteps.build_rules(jcfg, jm, train, step=jshape.step,
                                          shape=jshape)
                got = S.build_rules(cfg, pm, train, step=shape.step,
                                    shape=shape)
                assert got == want, (arch, mesh_shape, shape.name, train)


@pytest.mark.parametrize("mesh_shape,axes", MESHES[:3] + [
    ((2, 2, 2), ("pod", "data", "model"))])
@pytest.mark.parametrize("arch", ["qwen3-32b", "granite-moe-3b-a800m",
                                  "qwen2-0.5b"])
def test_tree_shard_round_trip(arch, mesh_shape, axes):
    """``tree_shard`` is the one parameter slicer (``LM.shard_params`` and
    ``LM.init`` call it): every rank's slices, put back where
    ``local_range`` says in whole heads (the selected KV heads at their
    head index where the model replicates ``kv_heads``), give each full
    tensor back: every element covered, replicas equal, no head cut."""
    cfg = get_config(arch).reduced()
    full = build_model(cfg, device="cpu").init(seed=0)
    rules = R.INFER_RULES_MULTIPOD if "pod" in axes else R.INFER_RULES
    world = int(np.prod(mesh_shape))
    rebuilt = {n: torch.full(tuple(t.shape), float("nan"))
               for n, t in _flat(full).items()}
    for r in range(world):
        sh = R.Sharder(mesh_for_rank(mesh_shape, axes, r), dict(rules))
        model = build_model(cfg, device="cpu", sharder=sh)
        specs = model.param_specs()
        local = _flat(R.tree_shard(full, specs, sh, cfg.hd, model._kv_sel))
        assert _flat(model.shard_params(full)).keys() == local.keys()
        shapes = _flat(model.local_param_shapes())
        names = _flat(specs)
        for key, t in local.items():
            assert tuple(t.shape) == shapes[key], key
            unit = R.head_units(names[key], cfg.hd)
            for i, n in enumerate(names[key]):
                if n in ("heads", "kv_heads"):
                    assert t.shape[i] % cfg.hd == 0, (key, t.shape)
            if "kv_heads" in names[key] and model._kv_sel is not None:
                ax = names[key].index("kv_heads")
                heads = rebuilt[key].unflatten(ax, (-1, cfg.hd))
                parts = t.unflatten(ax, (-1, cfg.hd))
                for j, h in enumerate(model._kv_sel):
                    prev = heads.select(ax, h)
                    got = parts.select(ax, j)
                    assert torch.isnan(prev).all() or torch.equal(prev, got)
                    prev.copy_(got)
                continue
            assert tuple(t.shape) == sh.local_shape(
                names[key], rebuilt[key].shape, unit), key
            idx = tuple(slice(*sh.local_range(names[key], rebuilt[key].shape,
                                              i, unit))
                        for i in range(t.ndim))
            prev = rebuilt[key][idx]
            assert torch.isnan(prev).all() or torch.equal(prev, t), key
            rebuilt[key][idx] = t
    for key, t in _flat(full).items():
        assert torch.equal(rebuilt[key], t), key


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_moe_queue_share_reproduces_the_unsplit_drops():
    """Two row shards of a batch, each told the pairs per expert of the
    shard before it, drop exactly the pairs the unsplit layer drops (a
    capacity factor of 0.5 makes it drop many)."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    model = build_model(cfg, device="cpu")
    p = model._layer(model.init(seed=0), 0)["moe"]
    x = torch.from_numpy(np.random.RandomState(1).randn(4, 6, cfg.d_model)
                         .astype(np.float32))
    args = (cfg.moe_top_k, cfg.act, cfg.gated_ffn, 0.5)
    want, _, idx = moe_mod.moe_apply(p, x, *args)
    first = torch.nn.functional.one_hot(idx[:12].reshape(-1),
                                        cfg.n_experts).sum(0)
    assert first.max() * 2 > moe_mod._capacity(24, cfg.n_experts,
                                               cfg.moe_top_k, 0.5)
    zero = torch.zeros_like(first)
    a, _, _ = moe_mod.moe_apply(p, x[:2], *args,
                                queue_share=lambda c: (zero, 2))
    b, _, _ = moe_mod.moe_apply(p, x[2:], *args,
                                queue_share=lambda c: (first, 2))
    torch.testing.assert_close(torch.cat([a, b]), want, atol=0, rtol=0)
    alone, _, _ = moe_mod.moe_apply(p, x[2:], *args)
    assert not torch.equal(alone, want[2:])      # the share matters here


def test_moe_row_parallel_partials_stay_fp32():
    """A bf16 MoE layer split over ``expert_ffn`` in two halves, as two
    ranks hold it: each half's combined output reaches ``reduce`` in fp32,
    and their sum rounded once is no further from the layer evaluated in
    fp32 on the same values than the unsplit bf16 layer is."""
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(),
                              dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    p = model._layer(model.init(seed=0), 0)["moe"]
    x = torch.from_numpy(np.random.RandomState(1).randn(4, 6, cfg.d_model)
                         .astype(np.float32)).bfloat16()
    args = (cfg.moe_top_k, cfg.act, cfg.gated_ffn)
    unsplit, _, _ = moe_mod.moe_apply(p, x, *args)
    exact, _, _ = moe_mod.moe_apply({k: v.float() for k, v in p.items()},
                                    x.float(), *args)
    f = cfg.d_ff // 2
    parts = []
    for cut in (slice(0, f), slice(f, None)):
        half = dict(p, w_up=p["w_up"][..., cut], w_down=p["w_down"][:, cut])
        if "w_gate" in p:
            half["w_gate"] = p["w_gate"][..., cut]
        out, _, _ = moe_mod.moe_apply(half, x, *args,
                                      reduce=lambda t: parts.append(t) or t)
        assert out.dtype == torch.bfloat16
    assert [t.dtype for t in parts] == [torch.float32] * 2
    split = (parts[0] + parts[1]).bfloat16().reshape(unsplit.shape)

    def rel(a):
        return float((a.float() - exact).abs().max() / exact.abs().max())
    assert rel(split) <= rel(unsplit), (rel(split), rel(unsplit))


def test_unsupported_steps_name_their_roadmap_item():
    cfg = get_config("qwen3-32b").reduced()
    mesh = mesh_for_rank((1, 2), ("data", "model"), 0)
    cases = [
        (cfg, ShapeSpec("t", 16, 4, "train_step"), mesh, {}, "A9.4"),
        (cfg, ShapeSpec("d", 16, 4, "serve_step"), mesh,
         {"kv_cache_dtype": "float8_e4m3fn"}, "A9.3"),
        (cfg, ShapeSpec("d", 16, 4, "serve_step"),
         mesh_for_rank((2, 1, 2), ("pod", "data", "model"), 0),
         {"serve_pp": True}, "A9.2"),
    ]
    for arch in ("mamba2-1.3b", "zamba2-2.7b", "whisper-tiny"):
        cases.append((get_config(arch).reduced(),
                      ShapeSpec("d", 16, 4, "serve_step"), mesh, {},
                      "A9.1b"))
    for c, shape, m, kw, item in cases:
        with pytest.raises(NotImplementedError, match=item.replace(
                ".", r"\.")):
            S.build_step(c, shape, m, device="cpu", **kw)


def _greedy_lm(model, params, inputs, steps, max_len):
    with torch.no_grad():
        logits, cache = model.prefill(params, inputs, max_len=max_len,
                                      ring=True)
        cur = model.sample_greedy(logits).reshape(-1, 1).to(torch.int32)
        toks, outs = [cur], []
        for _ in range(steps):
            lg, cache = model.decode_step(params, cache, cur)
            cur = model.sample_greedy(lg).to(torch.int32)
            toks.append(cur)
            outs.append(lg)
    return logits, torch.cat(toks, 1), torch.cat(outs, 1)


@pytest.mark.parametrize("arch", ["qwen3-32b", "mamba2-1.3b",
                                  "whisper-tiny"])
def test_one_rank_mesh_steps_equal_the_unsplit_model(arch):
    """On a (1, 1) mesh the steps are the unsplit model's (an SSM and the
    encoder-decoder included: only a model axis above 1 refuses them)."""
    cfg = get_config(arch).reduced()
    mesh = mesh_for_rank((1, 1), ("data", "model"), 0)
    rng = np.random.RandomState(0)
    inputs = {"tokens": torch.from_numpy(rng.randint(0, cfg.vocab, (2, 5)))}
    if cfg.is_encdec:
        inputs["embeds"] = torch.from_numpy(
            rng.randn(2, 8, cfg.d_model).astype(np.float32))
    pre = S.build_step(cfg, ShapeSpec("p", 12, 2, "prefill_step"), mesh,
                       device="cpu")
    srv = S.build_step(cfg, ShapeSpec("d", 12, 2, "serve_step"), mesh,
                       device="cpu")
    params = pre.init_params(seed=0)
    model = build_model(cfg, device="cpu")
    with torch.no_grad():
        kw = {} if cfg.is_encdec else {"ring": True}
        want_lg, cache = model.prefill(params, dict(inputs), max_len=12,
                                       **kw)
        tok, got_cache = pre.fn(params, inputs)
        torch.testing.assert_close(pre.last_logits, want_lg, atol=0, rtol=0)
        assert torch.equal(tok, model.sample_greedy(want_lg).to(torch.int32))
        cur = tok.reshape(2, 1)
        for _ in range(3):
            want, cache = model.decode_step(params, cache, cur)
            cur, got_cache = srv.fn(params, got_cache, cur)
            torch.testing.assert_close(srv.last_logits, want, atol=0, rtol=0)
    assert srv.in_shardings[1]["pos"] == (2,)


def test_fp8_stored_weights_upcast_each_serve_step():
    cfg = get_config("qwen3-32b").reduced()
    mesh = mesh_for_rank((1, 1), ("data", "model"), 0)
    srv = S.build_step(cfg, ShapeSpec("d", 12, 2, "serve_step"), mesh,
                       weight_dtype="float8_e4m3fn", device="cpu")
    model = build_model(cfg, device="cpu")
    params = model.init(seed=0)
    stored = srv.shard_params(params)
    assert stored["layers"]["attn"]["wq"].dtype == torch.float8_e4m3fn
    assert stored["final_norm"]["w"].dtype == torch.float32
    rounded = _map(stored, lambda t: t.float())
    tokens = torch.tensor([[3], [7]], dtype=torch.int32)
    with torch.no_grad():
        want, _ = model.decode_step(rounded, model.init_cache(2, 12), tokens)
        got, _ = srv.fn(stored, model.init_cache(2, 12), tokens)
        torch.testing.assert_close(srv.last_logits, want, atol=0, rtol=0)
    assert torch.equal(got, model.sample_greedy(want).to(torch.int32))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# spawned worlds against the reference's unsharded model
# ---------------------------------------------------------------------------
B, PROMPT, STEPS, MAX_LEN = 4, 7, 4, 16
WORLD_CASES = {
    "dense": ("internlm2-1.8b", {}),
    "vlm": ("qwen2-vl-2b", {}),
    "moe": ("granite-moe-3b-a800m", {}),
    # 6 heads / 3 KV heads: on 2 ranks each rank's 3 query heads read KV
    # heads in unequal groups (0, 0, 1 / 1, 2, 2); on 4 nothing divides
    "odd_heads": ("qwen3-32b", {"n_heads": 6, "n_kv_heads": 3}),
}


def _flat_np(tree):
    if isinstance(tree, dict):
        return {k: _flat_np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _reference(name):
    arch, over = WORLD_CASES[name]
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **over)
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    model = jax_build(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(7)
    if cfg.frontend == "vision_embeds":
        t = np.arange(PROMPT)
        pos = np.stack([t, t // 2, t % 3 + t // 3])         # distinct streams
        inputs = {"embeds": rng.randn(B, PROMPT, cfg.d_model)
                  .astype(np.float32),
                  "positions": np.broadcast_to(pos[:, None], (3, B, PROMPT))
                  .astype(np.int32).copy()}
    else:
        inputs = {"tokens": rng.randint(0, cfg.vocab, (B, PROMPT))
                  .astype(np.int32)}
    prefill = jax.jit(lambda p, i: model.prefill(p, i, max_len=MAX_LEN))
    decode = jax.jit(model.decode_step)
    logits, cache = prefill(params, {k: jnp.asarray(v)
                                     for k, v in inputs.items()})
    cur = model.sample_greedy(logits).reshape(B, 1).astype(jnp.int32)
    toks, step_logits = [cur], []
    for _ in range(STEPS):
        lg, cache = decode(params, cache, cur)
        cur = model.sample_greedy(lg).reshape(B, 1).astype(jnp.int32)
        toks.append(cur)
        step_logits.append(lg)
    cache = {"k": torch.from_numpy(np.array(cache["k"])),
             "v": torch.from_numpy(np.array(cache["v"])),
             "pos": torch.full((B,), int(cache["pos"]), dtype=torch.int32)}
    return dict(cfg=cfg, params=_flat_np(params), inputs=inputs,
                cache=cache,
                logits=np.asarray(logits),
                tokens=np.asarray(jnp.concatenate(toks, 1)),
                step_logits=np.asarray(jnp.concatenate(step_logits, 1)))


@pytest.fixture(scope="module")
def references():
    return {name: _reference(name) for name in WORLD_CASES}


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2), (1, 4)])
def test_world_steps_equal_the_unsharded_reference(references, mesh_shape):
    names = list(WORLD_CASES)
    cases = [dict(cfg=references[n]["cfg"], inputs=references[n]["inputs"],
                  steps=STEPS, max_len=MAX_LEN,
                  params=references[n]["params"])
             for n in names]
    outs = run_ranks(S.serve_cases, mesh_shape, ("data", "model"),
                     args=(cases,))
    model_size = mesh_shape[1]
    for rank, per_case in enumerate(outs):
        for name, got in zip(names, per_case):
            ref = references[name]
            cfg = ref["cfg"]
            lo, hi = got["rows"]
            assert hi - lo == B // mesh_shape[0] if B % mesh_shape[0] == 0 \
                else (lo, hi) == (0, B)
            np.testing.assert_allclose(got["prefill_logits"],
                                       ref["logits"][lo:hi], atol=ATOL,
                                       rtol=RTOL, err_msg=f"{name} {rank}")
            np.testing.assert_allclose(got["logits"],
                                       ref["step_logits"][lo:hi], atol=ATOL,
                                       rtol=RTOL, err_msg=f"{name} {rank}")
            np.testing.assert_array_equal(got["tokens"], ref["tokens"])
            # the rank's cache after the last step is its shard
            # (``shard_cache``) of the reference's
            srv = S.build_step(cfg, ShapeSpec("d", MAX_LEN, B, "serve_step"),
                               mesh_for_rank(mesh_shape, ("data", "model"),
                                             rank), device="cpu")
            want = srv.shard_cache(ref["cache"])
            for key in ("k", "v"):
                np.testing.assert_allclose(got["cache"][key],
                                           want[key].numpy(), atol=ATOL,
                                           rtol=RTOL, err_msg=f"{name} {key}")
            np.testing.assert_array_equal(got["cache"]["pos"],
                                          want["pos"].numpy())
            split = cfg.n_heads % model_size == 0
            assert got["n_heads_local"] == (cfg.n_heads // model_size
                                            if split else cfg.n_heads)
            if name == "dense" and mesh_shape[0] == 1:
                # per step and layer: the attention and FFN sums, plus the
                # embedding's and the logits' (the batch is not split)
                want_calls = STEPS * (2 * cfg.n_layers + 2)
                assert got["allreduce"]["calls"] == want_calls, \
                    got["allreduce"]


def test_calibrate_allreduce_over_a_model_group_is_real():
    """Over a 2-rank model group ``calibrate_allreduce`` times a real
    all_reduce (gloo) and fits finite, positive alpha and beta."""
    outs = run_ranks(calibrate_model_allreduce, (1, 2), ("data", "model"))
    for cal in outs:
        assert np.isfinite(cal["alpha_s"]) and cal["alpha_s"] > 0
        assert np.isfinite(cal["beta_bps"]) and cal["beta_bps"] > 0
