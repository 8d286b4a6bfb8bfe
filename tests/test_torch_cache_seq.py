"""The sequence-split KV cache (the reference's ``cache_seq`` rule) in the
port's prefill, serve and PP steps, against the JAX package.

Without ranks:

- (a) the contiguous decode's plain version with ``lse=`` equals a direct
  log-sum-exp and softmax in fp32 (ragged and dead rows, a window, a ring
  read, fp8 caches), and agrees with the finite-masked oracle wherever a
  row sees a key;
- (b) ``merge_partials`` over 2 and 4 sequence slices, each read at its
  local position by the plain version with ``lse=``, equals the unsplit
  plain decode (slices a row sees nothing of, past the end of, and a
  window straddling a slice boundary);
- (c) for every config of the JAX package and meshes (1, 2), (2, 2), (1, 4)
  (and (2, 1, 2), (2, 2, 2), (2, 1, 4) for the PP step), the local K/V
  cache shapes of the port's prefill, serve and PP steps equal what the
  reference's ``resolve`` gives under its ``build_rules``.

With ranks, one gloo world per mesh shape running every case:

- (d) reduced configs whose serve cache is cut by sequence at model 2 or 4
  (6 / 3 heads, qwen2-vl, whisper with 6 heads, granite-moe, danube's
  ring) and zamba2's shared block (its prefill side) through ``build_step``'s prefill and
  serve steps against the reference's unsharded model: tokens equal,
  logits within fp32 2e-5, each rank's cache its ``shard_cache`` of the
  reference's; an e4m3fn serve cache against the reference's fp8 step:
  tokens equal, the cache's codes at most one fp8 step apart (the ranks'
  row-parallel sums round the hidden state in another order) and
  almost all equal;
- (f) the collectives a step and the layout's collectives (the prefill's
  all_to_all, ``store_cache``'s) equal a written reckoning;
- (e) a (2, 1, 2) PP world with the 6 / 3 config gives the reference's PP
  step's tokens and, rank by rank, its cache's slices.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types

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
from repro_torch.kernels import decode_attention as da
from repro_torch.launch import pipeline as pp
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import mesh_for_rank, run_ranks
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models.common import FP8_DTYPES, astype
from repro_torch.models.transformer import KV_KEYS
from repro_torch.sharding.rules import shard_leaf

ATOL = RTOL = 2e-5
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _direct(q, k, v, pos, window):
    """Each row's natural log-sum-exp and softmax-weighted values, written
    out loop by loop in fp64."""
    q, k, v = q.double(), k.double(), v.double()
    b, _, nh, d = q.shape
    g = nh // k.shape[2]
    o = torch.zeros((b, 1, nh, d), dtype=torch.float64)
    lse = torch.full((b, nh), -np.inf, dtype=torch.float64)
    for r in range(b):
        keys = [t for t in range(k.shape[1]) if t <= pos[r]
                and (window is None or t > pos[r] - window)]
        if not keys:
            continue
        for h in range(nh):
            s = torch.stack([q[r, 0, h] @ k[r, t, h // g] for t in keys])
            s = s / np.sqrt(d)
            lse[r, h] = torch.logsumexp(s, 0)
            w = torch.exp(s - lse[r, h])
            o[r, 0, h] = sum(w[i] * v[r, t, h // g]
                             for i, t in enumerate(keys))
    return o, lse


def _cache(rng, b, s, nkv, d, fmt=None):
    k = torch.from_numpy(rng.randn(b, s, nkv, d).astype(np.float32))
    v = torch.from_numpy(rng.randn(b, s, nkv, d).astype(np.float32))
    if fmt:
        k, v = astype(k, FP8_DTYPES[fmt]), astype(v, FP8_DTYPES[fmt])
    return k, v


# (a) ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", [None, "float8_e4m3fn", "float8_e5m2"])
@pytest.mark.parametrize("window", [None, 5])
def test_plain_lse_equals_a_direct_logsumexp_and_softmax(window, fmt):
    rng = np.random.RandomState(3)
    b, s, nh, nkv, d = 6, 20, 6, 2, 16
    q = torch.from_numpy(rng.randn(b, 1, nh, d).astype(np.float32))
    k, v = _cache(rng, b, s, nkv, d, fmt)
    # ragged rows, a dead row (-1: it sees nothing), one past the end
    pos = torch.tensor([0, 7, 19, -1, 25, 3], dtype=torch.int32)
    lse = torch.empty((b, nh), dtype=torch.float32)
    o, got = da.decode_attention_plain(q, k, v, pos, window=window, lse=lse)
    assert got is lse and o.dtype == torch.float32
    want_o, want_lse = _direct(q, k.float(), v.float(), pos.tolist(),
                               window)
    torch.testing.assert_close(o.double(), want_o, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse.double(), want_lse, atol=ATOL, rtol=RTOL)
    assert torch.isneginf(lse[3]).all() and not o[3].any()
    # the finite-masked oracle agrees wherever a row sees a key (with the
    # window, the row past the end sees none either)
    live = torch.isfinite(want_lse[:, 0])
    assert int(live.sum()) == (5 if window is None else 4)
    ref = attn.decode_attention(q, k, v, pos, window=window)
    torch.testing.assert_close(o[live], ref[live].float(), atol=ATOL,
                               rtol=RTOL)


def test_plain_lse_reads_a_ring_as_the_ring_route_does():
    """A ring of 8 slots after position 13: the slots the reference's
    ``slot_pos`` mask keeps are all of them, read at min(pos, 7) without a
    window, as ``ops.decode_attention_ring`` reads them."""
    rng = np.random.RandomState(4)
    b, s, nh, nkv, d = 3, 8, 4, 2, 16
    q = torch.from_numpy(rng.randn(b, 1, nh, d).astype(np.float32))
    k, v = _cache(rng, b, s, nkv, d)
    pos = torch.tensor([13, 13, 13], dtype=torch.int32)
    slot_pos = torch.tensor([8, 9, 10, 11, 12, 13, 6, 7], dtype=torch.int32)
    lse = torch.empty((b, nh))
    o, _ = da.decode_attention_plain(q, k, v, torch.clamp(pos, max=s - 1),
                                     lse=lse)
    want = attn.decode_attention_ring(q, k, v, pos, slot_pos)
    torch.testing.assert_close(o, want, atol=ATOL, rtol=RTOL)
    _, want_lse = _direct(q, k, v, [s - 1] * b, None)
    torch.testing.assert_close(lse.double(), want_lse, atol=ATOL, rtol=RTOL)


# (b) ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("window", [None, 6])
def test_merged_slices_equal_the_unsplit_plain_decode(n, window):
    rng = np.random.RandomState(5 + n)
    b, s, nh, nkv, d = 5, 24, 8, 2, 16
    q = torch.from_numpy(rng.randn(b, 1, nh, d).astype(np.float32))
    k, v = _cache(rng, b, s, nkv, d)
    # row 0 inside the first slice (the others see nothing), row 3 past
    # the end; with the window, rows 1 and 2 straddle a slice boundary
    pos = torch.tensor([2, s // n + 1, s // 2 + 2, s + 1, s - 1],
                       dtype=torch.int32)
    want = da.decode_attention_plain(q, k, v, pos, window=window)
    width = s // n
    parts, lses = [], []
    for r in range(n):
        sl = slice(r * width, (r + 1) * width)
        lse = torch.empty((b, nh))
        o, _ = da.decode_attention_plain(q, k[:, sl].contiguous(),
                                         v[:, sl].contiguous(),
                                         pos - r * width, window=window,
                                         lse=lse)
        parts.append(o)
        lses.append(lse)
    lse = torch.stack(lses)
    assert torch.isneginf(lse[1:, 0]).all()        # row 0: later slices
    got = attn.merge_partials(torch.stack(parts), lse)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_a_row_that_sees_no_key_anywhere_merges_to_zero():
    o = torch.randn(3, 2, 1, 4, 8)
    lse = torch.full((3, 2, 4), -np.inf)
    lse[1, 0] = 0.5
    out = attn.merge_partials(o, lse)
    assert not out[1].any()
    torch.testing.assert_close(out[0], o[1, 0])


# (c) ---------------------------------------------------------------------------
S_LEN, ROWS = 4096, 8


def _jmesh(shape, axes):
    devs = np.array(jax.devices() * int(np.prod(shape)))[:int(np.prod(shape))]
    return jax.sharding.Mesh(devs.reshape(shape), axes)


def _ref_local(names, shape, rules, jmesh):
    spec = JR.resolve(names, shape, rules, jmesh)
    out = []
    for dim, e in zip(shape, spec):
        n = 1
        for a in (() if e is None else (e,) if isinstance(e, str) else e):
            n *= jmesh.shape[a]
        out.append(dim // n)
    return tuple(out)


def _port_local(model, key, shape):
    """The port's local shape of a K/V leaf of global ``shape``."""
    lead, s, nkv, hd = shape[:2], shape[2], shape[3], shape[4]
    rows = model.sharder.local_shape(("batch",), (lead[1],))[0]
    return (lead[0], rows, model.seq_slice(s)[1], model.n_kv_cache, hd)


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2), (1, 4)])
@pytest.mark.parametrize("arch", [a for a in sorted(JAX_REGISTRY)
                                  if get_config(a).n_kv_heads])
def test_local_cache_shapes_equal_the_reference_resolve(arch, mesh_shape):
    """Every config that holds a KV cache (mamba2 holds none)."""
    jcfg, cfg = jax_config(arch), get_config(arch)
    axes = ("data", "model")
    jm = _jmesh(mesh_shape, axes)
    spec = jax_input_specs(jcfg, JShapeSpec("d", S_LEN, ROWS, "serve_step"))
    names = jax_build(jcfg).cache_specs()
    for step in ("prefill_step", "serve_step"):
        rules = jsteps.build_rules(jcfg, jm, False, step=step)
        built = S.build_step(cfg, ShapeSpec("x", S_LEN, ROWS, step),
                             mesh_for_rank(mesh_shape, axes, 0),
                             device="cpu")
        model = built.model
        for key in KV_KEYS:
            if key not in names:
                continue
            shape = tuple(spec["cache"][key].shape)
            want = _ref_local(names[key], shape, rules, jm)
            got = _port_local(model, key, shape)
            if step == "serve_step":
                assert tuple(built.in_shardings[1][key]) == got, key
            assert got == want, (arch, mesh_shape, step, key, got, want)
            # the one slicer cuts a cache leaf as resolve decides
            meta = torch.empty(shape, device="meta")
            assert tuple(shard_leaf(meta, names[key], model.sharder).shape
                         ) == want, key
        # the meta device's cache is what the step builds
        meta = build_model(cfg, device="meta", sharder=model.sharder)
        kw = ({"s_enc": S_LEN} if cfg.is_encdec else {"ring": True})
        local = meta.init_cache(ROWS // mesh_shape[0], S_LEN, **kw)
        for key in KV_KEYS:
            if key in local:
                assert tuple(local[key].shape) == _port_local(
                    model, key, tuple(spec["cache"][key].shape)), key


@pytest.mark.parametrize("mesh_shape", [(2, 1, 2), (2, 2, 2), (2, 1, 4)])
@pytest.mark.parametrize("arch", [a for a in sorted(JAX_REGISTRY)
                                  if pp.pp_supported(get_config(a))])
def test_pp_cache_shapes_equal_the_reference_resolve(arch, mesh_shape):
    """Every config the PP step takes."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    axes = ("pod", "data", "model")
    jm = _jmesh(mesh_shape, axes)
    shape = ShapeSpec("d", S_LEN, ROWS, "serve_step")
    built = S.build_step(cfg, shape, mesh_for_rank(mesh_shape, axes, 0),
                         serve_pp=True, device="cpu")
    rules = dict(jsteps.build_rules(jcfg, jm, False, step="serve_step"),
                 pp_stage=("pod",), batch=("data",))
    full = tuple(built.args_shapes[1]["k"].shape)
    names = ("pp_stage", "layers", None, "batch", "cache_seq", "kv_heads",
             "head_dim")
    want = _ref_local(names, full, rules, jm)
    got = tuple(built.in_shardings[1]["k"])
    # the stage holds its own layers (want: the padded lmax); the rest
    assert got[1:] == want[2:], (arch, mesh_shape, got, want)


# (d), (f) ------------------------------------------------------------------------
B, PROMPT, STEPS, MAX_LEN = 4, 7, 3, 16
ENC_FRAMES = 8
FP8 = "float8_e4m3fn"
CASES = {
    # 6 heads / 3 KV heads: cut by sequence at model 2 (3 query heads a
    # rank reading KV heads 0, 0, 1 / 1, 2, 2) and at 4 (heads whole)
    "odd_heads": ("qwen3-32b", {"n_heads": 6, "n_kv_heads": 3}),
    # 4 / 2 heads: heads layout at model 2, cut by sequence at 4
    "vlm": ("qwen2-vl-2b", {}),
    "moe": ("granite-moe-3b-a800m", {}),
    # 6 / 6: self and cross caches cut by sequence at model 4
    "encdec_6": ("whisper-tiny", {"n_heads": 6, "n_kv_heads": 6}),
    # 4 / 4 in the shared block: only the prefill's cache is cut
    "hybrid": ("zamba2-2.7b", {}),
    # the ring cache of a sliding window (8 slots: the prompt wraps it),
    # its slots cut by sequence at model 4
    "ring": ("h2o-danube-3-4b", {}),
}


def _flat_np(tree):
    if isinstance(tree, dict):
        return {k: _flat_np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _inputs(cfg, rng):
    if cfg.frontend == "vision_embeds":
        t = np.arange(PROMPT)
        pos = np.stack([t, t // 2, t % 3 + t // 3])
        return {"embeds": rng.randn(B, PROMPT, cfg.d_model)
                .astype(np.float32),
                "positions": np.broadcast_to(pos[:, None], (3, B, PROMPT))
                .astype(np.int32).copy()}
    inputs = {"tokens": rng.randint(0, cfg.vocab, (B, PROMPT))
              .astype(np.int32)}
    if cfg.is_encdec:
        inputs["embeds"] = rng.randn(B, ENC_FRAMES, cfg.d_model).astype(
            np.float32)
    return inputs


def _reference(arch, over, fp8=None):
    """The reference's unsharded prefill and greedy decode steps; with
    ``fp8``, its prefill cache cast by its ``maybe_q`` rule and its
    ``build_step`` fp8 serve function on one device."""
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **over)
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    model = jax_build(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    inputs = _inputs(cfg, np.random.RandomState(7))
    logits, cache = jax.jit(lambda p, i: model.prefill(p, i, max_len=MAX_LEN))(
        params, {k: jnp.asarray(v) for k, v in inputs.items()})
    cur = model.sample_greedy(logits).reshape(B, 1).astype(jnp.int32)
    if fp8:
        mesh = _jmesh((1, 1), ("data", "model"))
        built = jsteps.build_step(jcfg, JShapeSpec("d", MAX_LEN, B,
                                                   "serve_step"), mesh,
                                  kv_cache_dtype=fp8)
        cache = {k: v.astype(fp8) if v.dtype == model.dtype and v.ndim >= 5
                 else v for k, v in cache.items()}
        fn = jax.jit(built.fn)
        toks = [cur]
        with mesh:
            for _ in range(STEPS):
                cur, cache = fn(params, cache, cur)
                toks.append(cur)
        step_logits = []
    else:
        dec = jax.jit(model.decode_step)
        toks, step_logits = [cur], []
        for _ in range(STEPS):
            lg, cache = dec(params, cache, cur)
            cur = model.sample_greedy(lg).reshape(B, 1).astype(jnp.int32)
            toks.append(cur)
            step_logits.append(lg)
    host = {}
    for k, v in cache.items():
        if k == "pos":
            host[k] = torch.full((B,), int(v), dtype=torch.int32)
        elif fp8 and v.dtype == jnp.dtype(fp8):
            host[k] = torch.from_numpy(np.asarray(v).view(np.uint8).copy()
                                       ).view(FP8_DTYPES[fp8])
        else:
            host[k] = torch.from_numpy(np.array(v))
    return dict(cfg=cfg, params=_flat_np(params), inputs=inputs, cache=host,
                logits=np.asarray(logits),
                tokens=np.asarray(jnp.concatenate(toks, 1)),
                step_logits=(np.asarray(jnp.concatenate(step_logits, 1))
                             if step_logits else None))


@pytest.fixture(scope="module")
def references():
    refs = {n: _reference(*CASES[n]) for n in CASES}
    refs["odd_heads_fp8"] = _reference(*CASES["odd_heads"], fp8=FP8)
    return refs


def _world_cases(refs):
    out = []
    for name, ref in refs.items():
        case = dict(cfg=ref["cfg"], inputs=ref["inputs"], steps=STEPS,
                    max_len=MAX_LEN, params=ref["params"])
        if name.endswith("_fp8"):
            # fed the reference's tokens: a step's argmax cannot fork
            case.update(kv_cache_dtype=FP8, feed=ref["tokens"][:, :-1])
        out.append(case)
    return out


def _reckoning(cfg, mesh_shape):
    """Collectives a serve step, written out: all_reduce calls (the
    row-parallel sums of each layer's split products, the vocab-parallel
    embedding and logits, the tokens' rows, the MoE's queue tables under a
    batch split), and, on a serve cache cut by
    sequence, per attention over it one all_gather of q and one all_to_all
    of the partials where the query heads are split, else one all_gather
    of the partials."""
    data, n = mesh_shape
    heads = n > 1 and cfg.n_heads % n == 0
    seq = n > 1 and cfg.n_kv_heads % n != 0
    ffn = n > 1 and cfg.d_ff % n == 0
    vocab = n > 1 and cfg.padded_vocab % n == 0
    attns = 2 if cfg.is_encdec else 1          # self and cross
    # the MoE's capacity queues count the rows of the ranks before this one
    queues = cfg.n_experts > 0 and data > 1
    reduces = (cfg.n_layers * (attns * heads + ffn + queues) + 2 * vocab
               + (data > 1))
    return {"calls": reduces,
            "gather_calls": cfg.n_layers * attns * seq,
            "a2a_calls": cfg.n_layers * attns * (seq and heads)}


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2), (1, 4)])
def test_world_serves_sequence_split_caches_as_the_reference(references,
                                                             mesh_shape):
    names = list(references)
    outs = run_ranks(S.serve_cases, mesh_shape, ("data", "model"),
                     args=(_world_cases(references),))
    n = mesh_shape[1]
    for rank, per_case in enumerate(outs):
        mesh = mesh_for_rank(mesh_shape, ("data", "model"), rank)
        for name, got in zip(names, per_case):
            ref, fp8 = references[name], name.endswith("_fp8")
            cfg = ref["cfg"]
            lo, hi = got["rows"]
            np.testing.assert_array_equal(got["tokens"], ref["tokens"],
                                          err_msg=f"{name} {rank}")
            np.testing.assert_allclose(got["prefill_logits"],
                                       ref["logits"][lo:hi], atol=ATOL,
                                       rtol=RTOL, err_msg=f"{name} {rank}")
            if not fp8:
                np.testing.assert_allclose(got["logits"],
                                           ref["step_logits"][lo:hi],
                                           atol=ATOL, rtol=RTOL,
                                           err_msg=f"{name} {rank}")
            srv = S.build_step(cfg, ShapeSpec("d", MAX_LEN, B, "serve_step"),
                               mesh, device="cpu")
            want = srv.shard_cache(ref["cache"])
            seq = n > 1 and cfg.n_kv_heads % n != 0
            for key in want:
                if key == "pos":
                    continue
                g = got["cache"][key]
                assert g.shape == tuple(want[key].shape), (name, key)
                if key in KV_KEYS and seq:       # every head, S / n slots
                    assert g.shape[2:4] == (want[key].shape[2],
                                            cfg.n_kv_heads)
                    assert g.shape[2] * n in (MAX_LEN, ENC_FRAMES)
                if fp8 and key in got["cache_bytes"]:
                    w = want[key].view(torch.uint8).numpy().astype(int)
                    apart = np.abs(got["cache_bytes"][key].astype(int) - w)
                    assert apart.max() <= 1 and (apart > 0).mean() < 1e-2, \
                        (name, key, apart.max(), (apart > 0).mean())
                    continue
                np.testing.assert_allclose(g, want[key].float().numpy(),
                                           atol=ATOL, rtol=RTOL,
                                           err_msg=f"{name} {key}")
            if name == "hybrid":
                continue
            # (f): a step's collectives, and the layout's
            per_step = {k: got["allreduce"][k] // STEPS
                        for k in ("calls", "gather_calls", "a2a_calls")}
            assert per_step == _reckoning(cfg, mesh_shape), (name, per_step)
            assert all(got["allreduce"][k] % STEPS == 0 for k in per_step)
            kv_leaves = 4 if cfg.is_encdec else 2
            heads_split = n > 1 and cfg.n_kv_heads % n == 0
            layout = got["layout_collectives"]
            # the prefill cuts the heads it projected into sequence slices
            # (all_to_all) where kv_heads is split, else slices; the serve
            # step lays them back out by heads where that is its layout
            assert layout["prefill"]["a2a_calls"] == kv_leaves * heads_split
            assert layout["store"]["a2a_calls"] == kv_leaves * heads_split
            assert got["decode_lse_launches"] == 0     # the CPU


# (e) ---------------------------------------------------------------------------
PP_SEQ, PP_POS, PP_ROWS = 16, 5, 8
PP_OVER = {"n_heads": 6, "n_kv_heads": 3}
PP_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json, sys
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.configs.shapes import ShapeSpec
    from repro.launch.pipeline import pack_pp_params
    from repro.launch.steps import build_step
    from repro.models import build_model

    out, over, seq, pos, b, steps = sys.argv[1], json.loads(sys.argv[2]), \\
        *map(int, sys.argv[3:7])
    cfg = dataclasses.replace(get_config("qwen3-32b").reduced(), **over)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 1, 2),
                ("pod", "data", "model"))
    built = build_step(cfg, ShapeSpec("d", seq, b, "serve_step"), mesh,
                       serve_pp=True)
    params = build_model(cfg, remat=False).init(jax.random.PRNGKey(0))
    packed = pack_pp_params(params, built.meta["pp_split"])
    rng = np.random.RandomState(0)
    kv = built.args_sds[1]["k"].shape
    k0, v0 = (rng.randn(*kv).astype(np.float32) for _ in range(2))
    tok0 = rng.randint(0, cfg.vocab, (b, 1)).astype(np.int32)
    cache = {"k": jnp.asarray(k0), "v": jnp.asarray(v0),
             "pos": jnp.int32(pos)}
    fn = jax.jit(built.fn, in_shardings=built.in_shardings)
    toks, outs = jnp.asarray(tok0), []
    with mesh:
        for _ in range(steps):
            toks, cache = fn(packed, cache, toks)
            outs.append(np.asarray(toks))
    flat = {}
    def walk(t, p):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, p + "/" + k)
        else:
            flat[p] = np.asarray(t)
    walk(params, "p")
    np.savez(out, k0=k0, v0=v0, tok0=tok0, toks=np.concatenate(outs, 1),
             k=np.asarray(cache["k"]), v=np.asarray(cache["v"]), **flat)
""")


def _unflat(npz) -> dict:
    tree: dict = {}
    for key in npz.files:
        if key.startswith("p/"):
            node, parts = tree, key.split("/")[1:]
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = npz[key]
    return tree


def test_pp_world_on_a_sequence_split_cache_gives_the_reference_tokens(
        tmp_path):
    out = tmp_path / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", PP_SCRIPT, str(out), json.dumps(PP_OVER),
         str(PP_SEQ), str(PP_POS), str(PP_ROWS), str(STEPS)], env=env,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    ref = np.load(out)
    cfg = dataclasses.replace(get_config("qwen3-32b").reduced(), **PP_OVER)
    case = dict(cfg=cfg, inputs={"tokens": ref["tok0"]}, steps=STEPS,
                max_len=PP_SEQ, params=_unflat(ref), serve_pp=True,
                cache={"k": ref["k0"], "v": ref["v0"],
                       "pos": np.int32(PP_POS)})
    mesh_shape = (2, 1, 2)
    outs = run_ranks(S.serve_cases, mesh_shape, ("pod", "data", "model"),
                     args=([case],))
    for rank, (got,) in enumerate(outs):
        np.testing.assert_array_equal(got["tokens"][:, 1:], ref["toks"])
        srv = S.build_step(cfg, ShapeSpec("d", PP_SEQ, PP_ROWS,
                                          "serve_step"),
                           mesh_for_rank(mesh_shape, ("pod", "data",
                                                      "model"), rank),
                           serve_pp=True, device="cpu")
        # 3 KV heads on a model axis of 2: the stage's cache is cut by
        # sequence, every head in each slice
        assert srv.in_shardings[1]["k"][3:5] == (PP_SEQ // 2, 3)
        want = srv.shard_cache({"k": ref["k"], "v": ref["v"],
                                "pos": np.int32(PP_POS + STEPS)})
        for key in ("k", "v"):
            np.testing.assert_allclose(got["cache"][key],
                                       want[key].numpy(), atol=ATOL,
                                       rtol=RTOL, err_msg=f"{key} {rank}")
        assert got["stage"] == mesh_for_rank(
            mesh_shape, ("pod", "data", "model"), rank).coords["pod"]


def test_decode_on_a_prefill_layout_refuses():
    """A prefill step's model (KV heads split, the cache cut by sequence)
    does not decode: the serve step's layout is by heads there."""
    cfg = get_config("internlm2-1.8b").reduced()
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 2},
                                 coords={"data": 0, "model": 0})
    pre = S.build_step(cfg, ShapeSpec("p", MAX_LEN, 2, "prefill_step"),
                       mesh, device="cpu")
    model = pre.model
    assert model.n_kv_local == 1 and model.n_kv_cache == 2
    cache = model.init_cache(2, MAX_LEN)
    assert tuple(cache["k"].shape) == (cfg.n_layers, 2, MAX_LEN // 2, 2,
                                       cfg.hd)
    q = torch.zeros((2, 1, model.n_heads_local, cfg.hd))
    with pytest.raises(NotImplementedError, match="store_cache"):
        model._split_attention(q, cache["k"][0], cache["v"][0],
                               torch.zeros(2, dtype=torch.int32))
