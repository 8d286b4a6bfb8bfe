"""The rank-side pipeline-parallel serve step (``build_step(serve_pp=True)``
on a mesh with a ``pod`` axis; ``launch/pipeline.py``'s
``build_pp_serve_step`` with a mesh) against the JAX package's PP step.

The reference runs once in a subprocess with four forced host devices (its
``shard_map`` over ``pod`` needs ``XLA_FLAGS`` before JAX loads), one case
per mesh shape (pod, data, model): reduced internlm2-1.8b at (2, 1, 1)
with ``pod_flops=[1.0, 0.5]`` (an uneven split), (3, 1, 1), (2, 1, 2) and
(2, 2, 1), qwen2-vl-2b at (2, 1, 2), and a ``float8_e4m3fn`` cache at
(2, 1, 1); each from a random cache, three greedy steps. Its params,
caches and tokens come back through one ``.npz`` per case. The port runs
one spawned gloo world per mesh shape, every case of that shape in it
(``serve_cases`` with ``serve_pp=True``): tokens identical, each rank's
cache, gathered back into the reference's (n_stages, lmax, m, mb, S, nkv,
hd) layout, within fp32 2e-5 of the reference's (the fp8 case: the same
bytes), and ``m`` sends a step from each stage but the last, ``m``
receives into each but the first. granite-moe (the reference's MoE PP step
does not build under this JAX) runs at (2, 1, 1) against the reference's
unsplit ``decode_step``, one microbatch at a time. Without worlds: a
rank's params and cache from the unsplit and the packed trees, its seeded
init, the stages' holdings, and the refusals.
"""

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

import repro.launch.pipeline as jpp
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import pipeline as pp
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import mesh_for_rank, run_ranks
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
AXES = ("pod", "data", "model")
SEQ, POS, STEPS = 32, 7, 3
ATOL = RTOL = 2e-5
# case -> (arch, mesh (pod, data, model), pod_flops, rows, kv_cache_dtype)
CASES = {
    "dense_211_uneven": ("internlm2-1.8b", (2, 1, 1), [1.0, 0.5], 8, None),
    "dense_211_e4m3": ("internlm2-1.8b", (2, 1, 1), [1.0, 0.5], 8,
                       "float8_e4m3fn"),
    "dense_311": ("internlm2-1.8b", (3, 1, 1), None, 6, None),
    "dense_212": ("internlm2-1.8b", (2, 1, 2), None, 8, None),
    "vlm_212": ("qwen2-vl-2b", (2, 1, 2), None, 8, None),
    "dense_221": ("internlm2-1.8b", (2, 2, 1), None, 8, None),
}
MOE = "granite-moe-3b-a800m"

SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.configs.shapes import ShapeSpec
    from repro.launch.pipeline import build_pp_serve_step, pack_pp_params
    from repro.launch.steps import build_rules, build_step
    from repro.models import build_model

    out_dir, cases = sys.argv[1], json.loads(sys.argv[2])
    SEQ, POS, STEPS = {SEQ}, {POS}, {STEPS}

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            out = {{}}
            for k, v in tree.items():
                out.update(flat(v, prefix + "/" + k))
            return out
        return {{prefix: np.asarray(tree)}}

    for name, (arch, shape3, pod_flops, b, kvd) in cases.items():
        cfg = get_config(arch).reduced()
        shape = ShapeSpec("d", SEQ, b, "serve_step")
        n = int(np.prod(shape3))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape3),
                    ("pod", "data", "model"))
        if pod_flops is None:           # the user's entry point
            built = build_step(cfg, shape, mesh, serve_pp=True,
                               kv_cache_dtype=kvd)
        else:
            rules = build_rules(cfg, mesh, False, "serve_step", shape)
            built = build_pp_serve_step(cfg, shape, mesh, rules,
                                        pod_flops=pod_flops,
                                        kv_cache_dtype=kvd)
        params = build_model(cfg, remat=False).init(jax.random.PRNGKey(0))
        packed = pack_pp_params(params, built.meta["pp_split"])
        rng = np.random.RandomState(0)
        kv = built.args_sds[1]["k"].shape
        k0 = rng.randn(*kv).astype(np.float32)
        v0 = rng.randn(*kv).astype(np.float32)
        tok0 = rng.randint(0, cfg.vocab, (b, 1)).astype(np.int32)
        cache = {{"k": jnp.asarray(k0), "v": jnp.asarray(v0),
                  "pos": jnp.int32(POS)}}
        if kvd:                  # fp8: the cast cache, carried as bytes
            cache["k"] = cache["k"].astype(kvd)
            cache["v"] = cache["v"].astype(kvd)
            k0 = np.asarray(cache["k"]).view(np.uint8)
            v0 = np.asarray(cache["v"]).view(np.uint8)

        def host(x):
            x = np.asarray(x)
            return x.view(np.uint8) if kvd else x
        toks, outs = jnp.asarray(tok0), []
        fn = jax.jit(built.fn, in_shardings=built.in_shardings)
        with mesh:
            for _ in range(STEPS):
                toks, cache = fn(packed, cache, toks)
                outs.append(np.asarray(toks))
        np.savez(os.path.join(out_dir, name + ".npz"), k0=k0, v0=v0,
                 tok0=tok0, toks=np.concatenate(outs, 1),
                 k=host(cache["k"]), v=host(cache["v"]),
                 pos=np.asarray(cache["pos"]),
                 split=np.asarray(built.meta["pp_split"]),
                 m=np.asarray(built.meta["n_microbatches"]),
                 **flat(params, "p"))
    print("done")
""").format(SEQ=SEQ, POS=POS, STEPS=STEPS)


def _unflat(npz) -> dict:
    tree: dict = {}
    for key in npz.files:
        if not key.startswith("p/"):
            continue
        node, parts = tree, key.split("/")[1:]
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = npz[key]
    return tree


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """The reference's PP step on every case, in one subprocess."""
    out = tmp_path_factory.mktemp("ref_pp_ranks")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", SCRIPT, str(out),
                          json.dumps(CASES)], env=env, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return {name: np.load(out / f"{name}.npz") for name in CASES}


def _case(ref, name) -> dict:
    """A ``serve_cases`` keyword dict: the reference's params (unsplit
    numpy tree), its start cache in the PP layout and its first tokens."""
    arch, _, pod_flops, _, kvd = CASES[name]
    cfg = get_config(arch).reduced()
    return dict(cfg=cfg, inputs={"tokens": ref["tok0"]}, steps=STEPS,
                max_len=SEQ, params=_unflat(ref), serve_pp=True,
                cache={"k": ref["k0"], "v": ref["v0"],
                       "pos": np.int32(POS)},
                pod_flops=pod_flops, kv_cache_dtype=kvd)


# MoE at (2, 1, 1) against the reference's unsplit decode, one microbatch at
# a time (its expert capacity depends on the rows of a call)
@pytest.fixture(scope="module")
def moe_ref():
    jcfg = jax_config(MOE).reduced()
    jmodel = jax_build(jcfg, remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    b = 8
    shape = ShapeSpec("d", SEQ, b, "serve_step")
    srv = pp.build_pp_serve_step(get_config(MOE).reduced(), shape,
                                 mesh_for_rank((2, 1, 1), AXES, 0), None,
                                 device="cpu")
    m = srv.meta["n_microbatches"]
    mb = b // m
    rng = np.random.RandomState(1)
    kv = (jcfg.n_layers, b, SEQ, jcfg.n_kv_heads, jcfg.hd)
    k0, v0 = (rng.randn(*kv).astype(np.float32) for _ in range(2))
    tok0 = rng.randint(0, jcfg.vocab, (b, 1)).astype(np.int32)
    decode = jax.jit(jmodel.decode_step)
    toks, ks, vs = [], [], []
    for i in range(m):
        rows = slice(i * mb, (i + 1) * mb)
        cache = {"k": jnp.asarray(k0[:, rows]), "v": jnp.asarray(v0[:, rows]),
                 "pos": jnp.int32(POS)}
        cur, seq = jnp.asarray(tok0[rows]), []
        for _ in range(STEPS):
            logits, cache = decode(jparams, cache, cur)
            cur = jmodel.sample_greedy(logits).astype(jnp.int32)
            seq.append(np.asarray(cur))
        toks.append(np.concatenate(seq, 1))
        ks.append(np.asarray(cache["k"]))
        vs.append(np.asarray(cache["v"]))
    return dict(params=jax.tree.map(np.asarray, jparams), k0=k0, v0=v0,
                tok0=tok0, toks=np.concatenate(toks),
                k=np.concatenate(ks, 1), v=np.concatenate(vs, 1), m=m)


def _moe_case(ref) -> dict:
    return dict(cfg=get_config(MOE).reduced(), inputs={"tokens": ref["tok0"]},
                steps=STEPS, max_len=SEQ, params=ref["params"],
                serve_pp=True, cache={"k": ref["k0"], "v": ref["v0"],
                                      "pos": np.full(8, POS, np.int32)})


WORLDS = {(2, 1, 1): ["dense_211_uneven", "dense_211_e4m3", "moe"],
          (3, 1, 1): ["dense_311"],
          (2, 1, 2): ["dense_212", "vlm_212"],
          (2, 2, 1): ["dense_221"]}


@pytest.fixture(scope="module")
def worlds(ref_runs, moe_ref):
    """One gloo world per mesh shape, every case of that shape in it."""
    out = {}
    for shape3, names in WORLDS.items():
        cases = [_moe_case(moe_ref) if n == "moe" else _case(ref_runs[n], n)
                 for n in names]
        ranks = run_ranks(S.serve_cases, shape3, AXES, args=(cases,))
        for k, n in enumerate(names):
            out[n] = [per_rank[k] for per_rank in ranks]
    return out


def _gather(outs, shape3, start, fp8):
    """The ranks' caches put back into the reference's PP layout over the
    start cache (padded slots keep their start values, as the
    reference's masked layers leave them)."""
    full = {k: start[k].copy() for k in ("k", "v")}
    for r, o in enumerate(outs):
        c = mesh_for_rank(shape3, AXES, r).coords
        lo, hi = o["rows"]
        n = o["pp_split"][o["stage"]]
        nkv = o["n_kv_local"]
        heads = slice(c["model"] * nkv, (c["model"] + 1) * nkv)
        for k in ("k", "v"):
            got = o["cache_bytes"][k] if fp8 else o["cache"][k]
            full[k][o["stage"], :n, :, lo:hi, :, heads] = got
    return full


def _check_hops(outs, m, n_stages):
    """``m`` sends a step from every stage but the last, ``m`` receives
    into every stage but the first: ``m * (n_stages - 1)`` hops a step for
    each (data, model) coordinate."""
    for o in outs:
        s = o["stage"]
        assert o["hops"]["sends"] == (STEPS * m if s < n_stages - 1 else 0)
        assert o["hops"]["recvs"] == (STEPS * m if s > 0 else 0)
    assert sum(o["hops"]["sends"] for o in outs) == STEPS * m * (
        n_stages - 1) * len(outs) // n_stages


@pytest.mark.parametrize("name", list(CASES))
def test_rank_pp_step_matches_the_references_pp_step(ref_runs, worlds,
                                                     name):
    arch, shape3, pod_flops, b, kvd = CASES[name]
    ref, outs = ref_runs[name], worlds[name]
    split, m = ref["split"].tolist(), int(ref["m"])
    if pod_flops is not None:
        assert len(set(split)) > 1
    for o in outs:
        assert o["pp_split"] == split and o["n_microbatches"] == m
        np.testing.assert_array_equal(o["tokens"][:, 1:], ref["toks"],
                                      err_msg=name)
        assert int(o["cache"]["pos"]) == int(ref["pos"]) == POS + STEPS
        lo, hi = o["rows"]
        assert hi - lo == b // m // shape3[1]
        assert o["n_heads_local"] == get_config(arch).reduced().n_heads \
            // shape3[2]
        assert (o["logits"] is None) == (o["stage"] < shape3[0] - 1)
    _check_hops(outs, m, shape3[0])
    got = _gather(outs, shape3, {"k": ref["k0"], "v": ref["v0"]}, bool(kvd))
    for key in ("k", "v"):
        if kvd:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        else:
            np.testing.assert_allclose(got[key], ref[key], atol=ATOL,
                                       rtol=RTOL, err_msg=key)


def test_rank_pp_step_of_the_moe_matches_the_references_unsplit_decode(
        moe_ref, worlds):
    outs = worlds["moe"]
    m, b = moe_ref["m"], 8
    split = outs[0]["pp_split"]
    for o in outs:
        np.testing.assert_array_equal(o["tokens"][:, 1:], moe_ref["toks"])
    _check_hops(outs, m, 2)
    for key in ("k", "v"):
        layers = []
        for o in sorted(outs, key=lambda o: o["stage"]):
            c = o["cache"][key]                     # (n, m, mb, S, nkv, hd)
            layers.append(c.reshape((c.shape[0], b) + c.shape[3:]))
        got = np.concatenate(layers)
        assert got.shape[0] == sum(split)
        np.testing.assert_allclose(got, moe_ref[key], atol=ATOL, rtol=RTOL,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# without worlds
# ---------------------------------------------------------------------------
def _rank_steps(cfg, shape3, b=8, **kw):
    shape = ShapeSpec("d", SEQ, b, "serve_step")
    return [S.build_step(cfg, shape, mesh_for_rank(shape3, AXES, r),
                         serve_pp=True, device="cpu", **kw)
            for r in range(int(np.prod(shape3)))]


@pytest.mark.parametrize("arch,shape3", [("qwen3-32b", (2, 1, 2)),
                                         ("qwen2-vl-2b", (3, 1, 1)),
                                         (MOE, (2, 2, 1))])
def test_rank_params_from_the_unsplit_and_packed_trees_and_the_init(
        arch, shape3):
    """A rank's ``shard_params`` of the unsplit tree equals its share of
    the packed tree, and its ``init_params(seed)`` the unsplit init's
    numbers; each stage holds its layers, stage 0 the embedding and the
    last the final norm and the head (the embedding if tied)."""
    cfg = get_config(arch).reduced()
    full = build_model(cfg, device="cpu").init(seed=3)
    for built in _rank_steps(cfg, shape3, b=6 if shape3[0] == 3 else 8):
        split, s = built.meta["pp_split"], built.meta["stage"]
        a = built.shard_params(full)
        b = built.shard_params(pp.pack_pp_params(full, split))
        c = built.init_params(seed=3)
        want = {"layers"} | ({"embed"} if s == 0 else set())
        if s == shape3[0] - 1:
            want |= {"final_norm"} | ({"embed"} if cfg.tie_embeddings
                                      else {"lm_head"})
        assert set(a) == set(b) == set(c) == want, s
        for x, y, z in zip(pp._leaves(a), pp._leaves(b), pp._leaves(c)):
            assert torch.equal(x, y) and torch.equal(x, z)
        assert a["layers"]["attn"]["wq"].shape[0] == split[s]
        local = built.in_shardings[0]
        assert set(local) == want
        assert tuple(a["layers"]["attn"]["wq"].shape) == \
            local["layers"]["attn"]["wq"]


def test_rank_cache_from_the_pp_layout_and_from_a_contiguous_cache():
    """``shard_cache`` of an unsplit contiguous cache (L, b, ...) equals its
    share of the same cache laid into the PP layout; fp8 keeps its bytes;
    a cache whose rows sit at different positions is refused."""
    cfg = get_config("qwen3-32b").reduced()
    b = 8
    rng = np.random.RandomState(4)
    kv = (cfg.n_layers, b, SEQ, cfg.n_kv_heads, cfg.hd)
    flat = {"k": torch.from_numpy(rng.randn(*kv).astype(np.float32)),
            "v": torch.from_numpy(rng.randn(*kv).astype(np.float32)),
            "pos": torch.full((b,), POS, dtype=torch.int32)}
    for built in _rank_steps(cfg, (2, 2, 2), b=b):
        split, m = built.meta["pp_split"], built.meta["n_microbatches"]
        lmax, mb = max(split), b // m
        laid = {k: torch.zeros((2, lmax, m, mb) + kv[2:]) for k in "kv"}
        off = 0
        for s, n in enumerate(split):
            for k in "kv":
                laid[k][s, :n] = flat[k][off:off + n].reshape(
                    (n, m, mb) + kv[2:])
            off += n
        laid["pos"] = torch.tensor(POS, dtype=torch.int32)
        a, c = built.shard_cache(flat), built.shard_cache(laid)
        assert tuple(a["k"].shape) == built.in_shardings[1]["k"]
        for k in "kv":
            assert torch.equal(a[k], c[k])
        assert int(a["pos"]) == int(c["pos"]) == POS and a["pos"].ndim == 0
        f8 = built.shard_cache({k: v.to(torch.float8_e5m2) if k != "pos"
                                else v for k, v in flat.items()})
        assert f8["k"].dtype == torch.float8_e5m2
        assert torch.equal(f8["k"].view(torch.uint8),
                           a["k"].to(torch.float8_e5m2).view(torch.uint8))
    ragged = dict(flat, pos=torch.arange(b, dtype=torch.int32))
    with pytest.raises(ValueError, match="one position"):
        built.shard_cache(ragged)


def test_build_step_serve_pp_is_build_pp_serve_step_on_a_mesh():
    """``build_step(serve_pp=True)`` on a pod mesh is the rank-side
    ``build_pp_serve_step`` with ``build_rules``' table: the reference's
    rules plus ``pp_stage`` over pod and the batch over data; its stage,
    split and microbatches; the prefill step is unchanged by
    ``serve_pp``."""
    cfg = get_config("qwen3-32b").reduced()
    mesh = mesh_for_rank((2, 1, 2), AXES, 3)
    shape = ShapeSpec("d", SEQ, 8, "serve_step")
    a = S.build_step(cfg, shape, mesh, serve_pp=True, device="cpu")
    b = pp.build_pp_serve_step(cfg, shape, mesh, S.build_rules(
        cfg, mesh, False, "serve_step", shape), device="cpu")
    assert isinstance(a, pp.PPBuiltStep)
    for key in ("rules", "pp_split", "n_microbatches", "stage", "rows",
                "held"):
        assert a.meta[key] == b.meta[key], key
    assert a.meta["stage"] == 1 and a.meta["rules"]["pp_stage"] == ("pod",)
    assert a.meta["rules"]["batch"] == ("data",)
    assert a.args_shapes[1]["k"].shape == (2, max(a.meta["pp_split"]),
                                           a.meta["n_microbatches"], 8 //
                                           a.meta["n_microbatches"], SEQ,
                                           cfg.n_kv_heads, cfg.hd)
    pre = S.build_step(cfg, ShapeSpec("p", SEQ, 8, "prefill_step"), mesh,
                       serve_pp=True, device="cpu")
    assert not isinstance(pre, pp.PPBuiltStep)


@pytest.mark.parametrize("arch,over", [("mamba2-1.3b", {}),
                                       ("whisper-tiny", {}),
                                       ("h2o-danube-3-4b", {})])
def test_unsupported_families_are_refused_as_the_reference_refuses(arch,
                                                                   over):
    cfg = get_config(arch).reduced()
    shape = ShapeSpec("d", SEQ, 8, "serve_step")
    with pytest.raises(ValueError, match="PP serve unsupported"):
        S.build_step(cfg, shape, mesh_for_rank((2, 1, 1), AXES, 0),
                     serve_pp=True, device="cpu")
    fake = types.SimpleNamespace(shape={"pod": 2, "data": 1, "model": 1})
    with pytest.raises(AssertionError, match="PP serve unsupported"):
        jpp.build_pp_serve_step(jax_config(arch).reduced(), shape, fake, {})


def test_wrong_kv_dtype_and_a_missing_world_are_refused():
    """The rank's step refuses a cache of another dtype (and shape) than it
    was built for, and, with a right cache, refuses to run outside an
    initialised world: no hop falls back to anything."""
    cfg = get_config("qwen3-32b").reduced()
    built = _rank_steps(cfg, (2, 1, 1), kv_cache_dtype="float8_e4m3fn")[1]
    params = built.init_params(seed=0)
    shp = built.in_shardings[1]["k"]
    tokens = torch.zeros((8, 1), dtype=torch.int32)
    bf = {"k": torch.zeros(shp), "v": torch.zeros(shp),
          "pos": torch.tensor(POS, dtype=torch.int32)}
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        built.fn(params, bf, tokens)
    short = built.store_cache({"k": torch.zeros(shp[:-1] + (8,)),
                               "v": torch.zeros(shp[:-1] + (8,)),
                               "pos": bf["pos"]})
    with pytest.raises(ValueError, match="shape|float8"):
        built.fn(params, short, tokens)
    good = built.store_cache(bf)
    assert good["k"].dtype == torch.float8_e4m3fn
    with pytest.raises(RuntimeError, match="initialised"):
        built.fn(params, good, tokens)


def test_reference_params_reach_the_ranks_as_the_unsplit_model_holds_them():
    """The numpy tree the worlds receive: ``params_from_jax`` of it is the
    unsplit model's tree, and a rank's share of either is the same."""
    jcfg = jax_config("internlm2-1.8b").reduced()
    jparams = jax.tree.map(np.asarray, jax_build(jcfg, remat=False).init(
        jax.random.PRNGKey(0)))
    cfg = get_config("internlm2-1.8b").reduced()
    full = params_from_jax(jparams, cfg, device="cpu")
    for built in _rank_steps(cfg, (2, 1, 2)):
        for x, y in zip(pp._leaves(built.shard_params(jparams)),
                        pp._leaves(built.shard_params(full))):
            assert torch.equal(x, y)
