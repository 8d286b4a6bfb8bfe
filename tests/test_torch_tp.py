"""Tensor parallelism over a mesh of ranks in the port
(``repro_torch.sharding``, ``repro_torch.launch.mesh``,
``repro_torch.launch.steps``) against the JAX package.

Without ranks: the port's rule tables, ``resolve`` and ``build_rules``
equal the reference's on every ``REGISTRY`` config, rule table and mesh
(the reference side on ``tests/test_sharding_hlo.py``'s fake meshes of one
host device, the port's on a stand-in with ``.shape``); ``tree_shard``'s
slices put back together give every full tensor, the Mamba2 mixer's
fused leaves by SSD head; the mixer split over two ranks (threads)
equals the unsplit block and a per-rank gated norm does not; the local
conv widths keep the SSD scan's tensor-core route; the MoE's queue share
reproduces the unsplit layer's capacity drops; the train step builds
with the reference's microbatches and rules; a one-rank mesh and
fp8-stored weights, in the serve step and (ignored) in the prefill step.

With ranks: one spawned gloo world per mesh shape, (1,2), (2,2) and (1,4),
each running ``build_step``'s prefill and four greedy serve steps for a
dense config, the VLM (qkv bias, tied embeddings, a prefill from
embeddings under distinct M-RoPE streams), an MoE config, a config
whose 6 heads / 3 KV heads divide no model axis evenly in groups, Mamba2
(8 SSD heads, and a 6-head variant whose mixer stays whole at model 4),
Zamba2 (8 SSD heads, 4 attention heads in the shared block) and whisper
(4 heads, and a 6-head variant whose attention stays whole at model 4),
all ``.reduced()`` fp32, from the reference's params (numpy, carried
across as ``models/convert.py`` does): prefill and step logits within
2e-5 of the reference's unsharded ``prefill`` / ``decode_step``, greedy
tokens identical, each rank's cache after the last step equal to its
``shard_cache`` of the reference's, every key. A (1,2) world of its own
runs ``calibrate_allreduce`` over the model group as a real all_reduce.
"""

import collections
import dataclasses
import threading
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
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import matmul_fp32
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
                                  "qwen2-0.5b", "mamba2-1.3b", "zamba2-2.7b",
                                  "whisper-tiny", "mamba2-6-heads"])
def test_tree_shard_round_trip(arch, mesh_shape, axes):
    """``tree_shard`` is the one parameter slicer (the models'
    ``shard_params`` and ``init`` call it): every rank's slices, put back
    where ``local_range`` says in whole heads (the selected KV heads at
    their head index where the model replicates ``kv_heads``; the Mamba2
    mixer's pieces where ``MixerSplit.ranges`` says: each rank's z, x and
    dt columns of ``w_in``, its x channels of ``conv_w`` / ``conv_b`` with
    B and C whole, its heads of ``dt_bias`` / ``a_log`` / ``d_skip``, its
    slice of ``gate_norm`` and rows of ``w_out``), give each full tensor
    back: every element covered, replicas equal, no head cut."""
    cfg = _variant(arch)
    full = build_model(cfg, device="cpu").init(seed=0)
    rules = R.INFER_RULES_MULTIPOD if "pod" in axes else R.INFER_RULES
    world = int(np.prod(mesh_shape))
    rebuilt = {n: torch.full(tuple(t.shape), float("nan"))
               for n, t in _flat(full).items()}
    for r in range(world):
        sh = R.Sharder(mesh_for_rank(mesh_shape, axes, r), dict(rules))
        model = build_model(cfg, device="cpu", sharder=sh)
        specs = model.param_specs()
        local = _flat(R.tree_shard(full, specs, sh, cfg.hd, model._kv_sel,
                                   model._mixer))
        assert _flat(model.shard_params(full)).keys() == local.keys()
        shapes = _flat(model.local_param_shapes())
        names = _flat(specs)
        for key, t in local.items():
            assert tuple(t.shape) == shapes[key], key
            mixed = [i for i, n in enumerate(names[key])
                     if n in ("ssm_inner", "ssm_heads")]
            if mixed:
                ax = mixed[0]
                off = 0
                for lo, hi in model._mixer.ranges(names[key][ax],
                                                  rebuilt[key].shape[ax]):
                    prev = rebuilt[key].narrow(ax, lo, hi - lo)
                    got = t.narrow(ax, off, hi - lo)
                    assert torch.isnan(prev).all() or torch.equal(prev, got)
                    prev.copy_(got)
                    off += hi - lo
                assert off == t.shape[ax], key
                continue
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


def _variant(arch):
    """A reduced config by name; ``mamba2-6-heads``: reduced mamba2 at
    d_model 48, 6 SSD heads of 16 (3 a rank at model 2, whole at 4)."""
    if arch == "mamba2-6-heads":
        return dataclasses.replace(get_config("mamba2-1.3b").reduced(),
                                   d_model=48)
    return get_config(arch).reduced()


def test_mixer_split_over_two_ranks_norms_over_the_whole_inner_dim():
    """Reduced mamba2's mixer (8 SSD heads of 16) split over two ranks,
    run as two threads whose ``reduce`` sums the ranks' tensors: each
    rank's prefill and step output and its state equal the unsplit
    block's (2e-5), the gated RMSNorm dividing the ranks' summed squares
    by the whole ``d_inner``; a norm over the rank's own 4 heads only
    (``reduce`` dropped, ``w_out`` still summed) misses by far more."""
    cfg = get_config("mamba2-1.3b").reduced()
    model = build_model(cfg, device="cpu")
    p = model._layer(model.init(seed=0), 0)["mixer"]
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 9, cfg.d_model).astype(np.float32))
    x1 = torch.from_numpy(rng.randn(2, 1, cfg.d_model).astype(np.float32))
    dims = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim)
    want_y, want_st = ssm_mod.mamba2_prefill(p, x, *dims, chunk=4)
    want1, want_st1 = ssm_mod.mamba2_step(p, x1, want_st, *dims)
    half = cfg.ssm_heads // 2
    splits = [R.MixerSplit(cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                           lo, lo + half) for lo in (0, half)]
    # each leaf's logical names, the layer axis dropped
    names = {k: d[1:] for k, d in
             model.param_specs()["layers"]["mixer"].items()}
    barrier = threading.Barrier(2)
    buf = [None, None]

    def reduce(r):
        def fn(t):
            buf[r] = t.clone()
            barrier.wait()
            out = buf[0] + buf[1]
            barrier.wait()
            return out
        return fn

    def run(r, norm_reduce, out):
        pl = {k: R.shard_leaf(v, names[k], R.Sharder(), mixer=splits[r])
              for k, v in p.items()}
        red = reduce(r)
        kw = dict(reduce=red if norm_reduce else None,
                  row_parallel=lambda a, w: red(matmul_fp32(a, w)))
        y, st = ssm_mod.mamba2_prefill(pl, x, *dims, chunk=4, **kw)
        y1, st1 = ssm_mod.mamba2_step(pl, x1, st, *dims, **kw)
        out[r] = (y, st, y1, st1)

    def world(norm_reduce):
        out = [None, None]
        threads = [threading.Thread(target=run, args=(r, norm_reduce, out))
                   for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return out
    for r, (y, st, y1, st1) in enumerate(world(True)):
        torch.testing.assert_close(y, want_y, atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(y1, want1, atol=ATOL, rtol=RTOL)
        for got, full in ((st, want_st), (st1, want_st1)):
            names_c = (None, None, "ssm_inner")
            torch.testing.assert_close(got.conv, R.shard_leaf(
                full.conv, names_c, R.Sharder(), mixer=splits[r]))
            torch.testing.assert_close(got.ssd, R.shard_leaf(
                full.ssd, (None, "ssm_heads", None, None), R.Sharder(),
                mixer=splits[r]), atol=ATOL, rtol=RTOL)
    y, _, y1, _ = world(False)[0]
    assert (y - want_y).abs().max() > 1e-3
    assert (y1 - want1).abs().max() > 1e-3


@pytest.mark.parametrize("arch,model_n", [("mamba2-1.3b", 2),
                                          ("mamba2-1.3b", 4),
                                          ("zamba2-2.7b", 2),
                                          ("zamba2-2.7b", 4)])
def test_local_conv_widths_keep_the_tensor_core_ssd_route(arch, model_n):
    """At full width a rank's conv output ``[x | B | C]`` (mamba2 at model
    2: 32 heads of 64 + 2 x 128 = 2304 channels; zamba2 at model 4: 20 of
    64 + 2 x 64 = 1408) keeps what the SSD forward's tensor-core route
    asks of bf16 x, B and C (``csrc/ssd_scan.cu``, ``rt_ssd_scan``): head
    dim and state width multiples of 8, row strides multiples of 8
    elements, and B and C starting 16 bytes into the row's 16-byte pieces
    (a multiple of 8 bf16 elements past x). The kernel reports the body it
    took; the chip smoke counts that report."""
    cfg = get_config(arch)
    sh = R.Sharder(mesh_for_rank((1, model_n), ("data", "model"), 0),
                   dict(R.INFER_RULES))
    model = build_model(cfg, device="meta", sharder=sh)
    nh = cfg.ssm_heads // model_n
    assert model.ssm_heads_local == nh
    width = model.local_param_shapes()["layers"]["mixer"]["conv_w"][-1]
    assert width == nh * cfg.ssm_head_dim + 2 * cfg.ssm_state
    xbc = torch.zeros(1, 4, width, dtype=torch.bfloat16)
    d = nh * cfg.ssm_head_dim
    x = xbc[..., :d].reshape(1, 4, nh, cfg.ssm_head_dim)
    b, c = xbc[..., d:d + cfg.ssm_state], xbc[..., d + cfg.ssm_state:]
    assert cfg.ssm_head_dim % 8 == 0 and cfg.ssm_state % 8 == 0
    for t in (x, b, c):
        assert t.storage_offset() % 8 == 0
    strides = (*x.stride()[:3], *b.stride()[:2], *c.stride()[:2])
    assert all(st % 8 == 0 for st in strides), strides


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
    """``build_step`` on a train shape (ROADMAP A9.4, no longer refused)
    builds this rank's train step on a (1, 2) mesh, whose
    ``n_microbatches`` and rules equal the reference's build on the same
    mesh shape, with and without ``n_microbatches`` / ``extra_rules``."""
    cfg, jcfg = get_config("qwen3-32b").reduced(), jax_config(
        "qwen3-32b").reduced()
    shape = ShapeSpec("t", 16, 4, "train_step")
    for kw in ({}, {"n_microbatches": 2, "extra_rules": {"vocab": None}}):
        built = S.build_step(cfg, shape, mesh_for_rank((1, 2), ("data",
                                                                "model"), 0),
                             device="cpu", **kw)
        want = jsteps.build_step(jcfg, shape, fake_mesh((1, 2), ("data",
                                                                 "model")),
                                 attn_chunk=0, **kw).meta
        assert built.meta["n_microbatches"] == want["n_microbatches"]
        assert built.meta["rules"] == want["rules"]
        assert callable(built.fn)


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


def test_fp8_weight_dtype_leaves_the_prefill_step_in_the_model_dtype():
    """A prefill step built with ``weight_dtype`` stores nothing in fp8
    (the reference applies ``weight_dtype`` to the serve step only), so it
    runs its own ``init_params`` and equals the prefill built without
    it."""
    cfg = get_config("qwen3-32b").reduced()
    mesh = mesh_for_rank((1, 1), ("data", "model"), 0)
    shape = ShapeSpec("p", 12, 2, "prefill_step")
    pre8 = S.build_step(cfg, shape, mesh, weight_dtype="float8_e4m3fn",
                        device="cpu")
    pre = S.build_step(cfg, shape, mesh, device="cpu")
    params8, params = pre8.init_params(seed=0), pre.init_params(seed=0)
    assert params8["layers"]["attn"]["wq"].dtype == torch.float32
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (2, 5)))
    with torch.no_grad():
        tok8, cache8 = pre8.fn(params8, {"tokens": tokens})
        tok, cache = pre.fn(params, {"tokens": tokens})
    torch.testing.assert_close(pre8.last_logits, pre.last_logits, atol=0,
                               rtol=0)
    assert torch.equal(tok8, tok)
    for key in ("k", "v"):
        assert torch.equal(cache8[key], cache[key])


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
    # 8 SSD heads of 16: 4 / 2 a rank at model 2 / 4
    "ssm": ("mamba2-1.3b", {}),
    # 6 SSD heads (d_model 48): 3 a rank at model 2, whole at 4
    "ssm_6": ("mamba2-1.3b", {"d_model": 48}),
    # 8 SSD heads and a shared block of 4 MHA heads (its MLP split too)
    "hybrid": ("zamba2-2.7b", {}),
    "encdec": ("whisper-tiny", {}),
    # 6 heads: 3 a rank at model 2, attention whole at 4 (FFN and vocab
    # split)
    "encdec_6": ("whisper-tiny", {"n_heads": 6, "n_kv_heads": 6}),
}
ENC_FRAMES = 8


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
    if cfg.is_encdec:
        inputs["embeds"] = rng.randn(B, ENC_FRAMES, cfg.d_model).astype(
            np.float32)
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
    cache = {k: torch.full((B,), int(v), dtype=torch.int32) if k == "pos"
             else torch.from_numpy(np.array(v)) for k, v in cache.items()}
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
            assert got["cache"].keys() == want.keys(), name
            for key in want:
                if key == "pos":
                    continue
                assert got["cache"][key].shape == tuple(want[key].shape)
                np.testing.assert_allclose(got["cache"][key],
                                           want[key].numpy(), atol=ATOL,
                                           rtol=RTOL, err_msg=f"{name} {key}")
            np.testing.assert_array_equal(got["cache"]["pos"],
                                          want["pos"].numpy())
            for n, key in ((cfg.n_heads, "n_heads_local"),
                           (cfg.ssm_heads if cfg.ssm_state else 0,
                            "ssm_heads_local")):
                split = n % model_size == 0
                assert got[key] == (n // model_size if split else n), \
                    (name, key)
            if name in ("dense", "ssm") and mesh_shape[0] == 1:
                # per step and layer: the attention and FFN sums (Mamba2:
                # the gated norm's sums of squares and w_out's), plus the
                # embedding's and the logits' (the batch is not split)
                want_calls = STEPS * (2 * cfg.n_layers + 2)
                assert got["allreduce"]["calls"] == want_calls, \
                    (name, got["allreduce"])


def test_calibrate_allreduce_over_a_model_group_is_real():
    """Over a 2-rank model group ``calibrate_allreduce`` times a real
    all_reduce (gloo) and fits finite, positive alpha and beta."""
    outs = run_ranks(calibrate_model_allreduce, (1, 2), ("data", "model"))
    for cal in outs:
        assert np.isfinite(cal["alpha_s"]) and cal["alpha_s"] > 0
        assert np.isfinite(cal["beta_bps"]) and cal["beta_bps"] > 0
