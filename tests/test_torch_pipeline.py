"""The port's pipeline-parallel serve step (``repro_torch.launch.pipeline``)
against the JAX package's ``repro.launch.pipeline``.

``pp_supported``, ``pp_layer_split`` and ``pack_pp_params`` must equal the
reference's with ``==``. The PP step runs against the reference's PP step
(a ``shard_map`` over a ``pod`` axis of host devices), which needs
``XLA_FLAGS`` set before JAX loads, so that side runs once in a subprocess
(as tests/test_dryrun_small.py runs its mesh) and hands its params, caches
and tokens back through an ``.npz`` per case: dense internlm2-1.8b and the
vlm qwen2-vl-2b, ``.reduced()``, at 2 stages (even and the uneven split of
``pod_flops=[1.0, 0.5]``), at 4 stages, and with fewer rows than two per
stage (one microbatch). Three ticks from a random cache: tokens identical,
caches within fp32 2e-5. The fp8 cases (``kv_cache_dtype``) start from
the random cache cast by the reference's ``astype`` and hand their bytes
across as ``uint8``: tokens identical, the caches' bytes equal. The
reference's PP step does not build for the MoE family under this JAX, so
granite-moe runs against the reference's
unsplit ``decode_step``, one microbatch at a time (its capacity depends on
the rows of a call): a PP step only reorganises the same layers.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.pipeline as jpp
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro_torch.configs import REGISTRY, get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import pipeline as pp
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
S, POS, TICKS = 32, 7, 3
ATOL = RTOL = 2e-5
# case -> (arch, stages, pod_flops, rows)
CASES = {
    "dense_2": ("internlm2-1.8b", 2, None, 8),
    "dense_2_uneven": ("internlm2-1.8b", 2, [1.0, 0.5], 8),
    "dense_4": ("internlm2-1.8b", 4, None, 8),
    "dense_m1": ("internlm2-1.8b", 2, [1.0, 0.5], 2),
    "vlm_2_uneven": ("qwen2-vl-2b", 2, [1.0, 0.5], 8),
    "vlm_4": ("qwen2-vl-2b", 4, None, 8),
}
# fp8 K/V caches: case -> (arch, stages, pod_flops, rows, kv_cache_dtype)
FP8_CASES = {
    "dense_2_uneven_e4m3": ("internlm2-1.8b", 2, [1.0, 0.5], 8,
                            "float8_e4m3fn"),
    "dense_4_e5m2": ("internlm2-1.8b", 4, None, 8, "float8_e5m2"),
    "vlm_2_uneven_e5m2": ("qwen2-vl-2b", 2, [1.0, 0.5], 8, "float8_e5m2"),
}

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
    from repro.launch.steps import build_rules
    from repro.models import build_model

    out_dir, cases = sys.argv[1], json.loads(sys.argv[2])
    S, POS, TICKS = {S}, {POS}, {TICKS}

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            out = {{}}
            for k, v in tree.items():
                out.update(flat(v, prefix + "/" + k))
            return out
        return {{prefix: np.asarray(tree)}}

    for name, (arch, n, pod_flops, b, *kvd) in cases.items():
        kvd = kvd[0] if kvd else None
        cfg = get_config(arch).reduced()
        shape = ShapeSpec("d", S, b, "serve_step")
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(n, 1, 1),
                    ("pod", "data", "model"))
        rules = build_rules(cfg, mesh, False, "serve_step", shape)
        built = build_pp_serve_step(cfg, shape, mesh, rules,
                                    pod_flops=pod_flops, kv_cache_dtype=kvd)
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
            for _ in range(TICKS):
                toks, cache = fn(packed, cache, toks)
                outs.append(np.asarray(toks))
        np.savez(os.path.join(out_dir, name + ".npz"), k0=k0, v0=v0,
                 tok0=tok0, toks=np.stack(outs), k=host(cache["k"]),
                 v=host(cache["v"]), pos=np.asarray(cache["pos"]),
                 split=np.asarray(built.meta["pp_split"]),
                 m=np.asarray(built.meta["n_microbatches"]),
                 **flat(params, "p"))
    print("done")
""").format(S=S, POS=POS, TICKS=TICKS)


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
    out = tmp_path_factory.mktemp("ref_pp")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", SCRIPT, str(out),
                          json.dumps({**CASES, **FP8_CASES})], env=env,
                         capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return out


def _build(cfg, b, n, pod_flops=None, n_microbatches=None,
           kv_cache_dtype=None):
    return pp.build_pp_serve_step(cfg, ShapeSpec("d", S, b, "serve_step"), n,
                                  devices=["cpu"] * n, pod_flops=pod_flops,
                                  n_microbatches=n_microbatches,
                                  kv_cache_dtype=kv_cache_dtype)


# -- planning and layout --------------------------------------------------------
def test_pp_supported_equals_the_reference_on_every_config():
    assert sorted(REGISTRY) == sorted(JAX_REGISTRY)
    got = {n: pp.pp_supported(c) for n, c in REGISTRY.items()}
    assert got == {n: jpp.pp_supported(c) for n, c in JAX_REGISTRY.items()}
    assert any(got.values()) and not all(got.values())


FLOPS = {"even": None, "halves": [1.0, 0.5, 1.0, 0.5],
         "falling": [1.0, 0.6, 0.35, 0.2]}


@pytest.mark.parametrize("arch", sorted(
    n for n, c in REGISTRY.items() if pp.pp_supported(c)))
def test_pp_layer_split_equals_the_reference(arch):
    for n in (2, 3, 4):
        for key, flops in FLOPS.items():
            f = None if flops is None else flops[:n]
            got = pp.pp_layer_split(get_config(arch), n, pod_flops=f)
            assert got == jpp.pp_layer_split(jax_config(arch), n,
                                             pod_flops=f), (n, key)
            assert sum(got) == get_config(arch).n_layers and min(got) >= 1


@pytest.mark.parametrize("split", [[3, 1], [2, 2]])
def test_pack_pp_params_equals_the_reference(split):
    jcfg = jax_config("internlm2-1.8b").reduced()
    jparams = jax_build(jcfg, remat=False).init(jax.random.PRNGKey(0))
    ref = jax.tree.map(np.asarray, jpp.pack_pp_params(jparams, split))
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             get_config("internlm2-1.8b").reduced(),
                             device="cpu")
    got = pp.pack_pp_params(params, split)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), got))[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
    for (path, a), (_, r) in zip(flat_got, flat_ref):
        assert a.shape == r.shape and a.dtype == r.dtype, path
        np.testing.assert_array_equal(a, r, err_msg=str(path))


def test_fp8_kv_cache_is_refused(ref_runs):
    """A PP step built with ``kv_cache_dtype`` refuses a cache of another
    dtype, and on its fp8 cache matches the reference's fp8 PP step (the
    uneven two-stage split in ``float8_e4m3fn``; the other fp8 cases in
    ``test_fp8_pp_step_matches_the_references_fp8_pp_step``)."""
    cfg = get_config("internlm2-1.8b").reduced()
    step, meta = _build(cfg, 8, 2, [1.0, 0.5],
                        kv_cache_dtype="float8_e4m3fn")
    assert meta["kv_dtype"] == torch.float8_e4m3fn
    kv = (2, max(meta["pp_split"]), meta["n_microbatches"], 8 // meta[
        "n_microbatches"], S, cfg.n_kv_heads, cfg.hd)
    cache = {"k": torch.zeros(kv), "v": torch.zeros(kv),
             "pos": torch.tensor(POS, dtype=torch.int32)}
    params = pp.pack_pp_params(build_model(cfg, device="cpu").init(0),
                               meta["pp_split"])
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        step(params, cache, torch.zeros((8, 1), dtype=torch.int32))
    _check_against_ref(ref_runs, "dense_2_uneven_e4m3",
                       FP8_CASES["dense_2_uneven_e4m3"])


@pytest.mark.parametrize("arch,b,m", [("mamba2-1.3b", 8, None),
                                      ("h2o-danube-3-4b", 8, None),
                                      ("qwen3-32b", 6, 4)])
def test_unsupported_configs_and_uneven_microbatches_are_refused(arch, b, m):
    with pytest.raises(ValueError):
        _build(get_config(arch).reduced(), b, 2, n_microbatches=m)


def test_step_needs_a_card_unless_given_cpu_devices():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = get_config("qwen3-32b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pp.build_pp_serve_step(cfg, ShapeSpec("d", S, 8, "serve_step"), 2)
    step, meta = _build(cfg, 8, 2)
    assert [d.type for d in meta["devices"]] == ["cpu", "cpu"]


# -- the step against the reference's PP step -----------------------------------
@pytest.mark.parametrize("case", sorted(CASES))
def test_pp_step_matches_the_references_pp_step(ref_runs, case):
    _check_against_ref(ref_runs, case, CASES[case])


@pytest.mark.parametrize("case", sorted(set(FP8_CASES)
                                        - {"dense_2_uneven_e4m3"}))
def test_fp8_pp_step_matches_the_references_fp8_pp_step(ref_runs, case):
    _check_against_ref(ref_runs, case, FP8_CASES[case])


def _from_bytes(a: np.ndarray, kv: str) -> torch.Tensor:
    return torch.from_numpy(a.copy()).view(getattr(torch, kv))


def _check_against_ref(ref_runs, case, spec):
    """The port's PP step from the reference's params, cache and tokens:
    three ticks' tokens identical, the caches within fp32 2e-5 (fp8: the
    same bytes)."""
    arch, n, pod_flops, b, *kv = spec
    kv = kv[0] if kv else None
    ref = np.load(ref_runs / f"{case}.npz")
    cfg = get_config(arch).reduced()
    step, meta = _build(cfg, b, n, pod_flops, kv_cache_dtype=kv)
    assert meta["pp_split"] == ref["split"].tolist()
    assert meta["n_microbatches"] == int(ref["m"])
    if case == "dense_m1":
        assert meta["n_microbatches"] == 1
    if pod_flops is not None:
        assert len(set(meta["pp_split"])) > 1
    params = pp.pack_pp_params(
        params_from_jax(_unflat(ref), cfg, device="cpu"), meta["pp_split"])
    load = (lambda a: _from_bytes(a, kv)) if kv else (
        lambda a: torch.from_numpy(a.copy()))
    cache = {"k": load(ref["k0"]), "v": load(ref["v0"]),
             "pos": torch.tensor(POS, dtype=torch.int32)}
    toks = torch.from_numpy(ref["tok0"].copy())
    for t in range(TICKS):
        toks, cache = step(params, cache, toks)
        assert toks.dtype == torch.int32 and toks.shape == (b, 1)
        np.testing.assert_array_equal(toks.numpy(), ref["toks"][t],
                                      err_msg=f"tick {t}")
    assert int(cache["pos"]) == int(ref["pos"]) == POS + TICKS
    for key in ("k", "v"):
        if kv:
            assert cache[key].dtype == getattr(torch, kv)
            np.testing.assert_array_equal(
                cache[key].view(torch.uint8).numpy(), ref[key], err_msg=key)
            continue
        np.testing.assert_allclose(cache[key].numpy(), ref[key], atol=ATOL,
                                   rtol=RTOL, err_msg=key)


# -- MoE against the reference's unsplit decode, one microbatch at a time -------
def _to_pp_layout(full, split, m):
    """(L, b, ...) -> (n_stages, lmax, m, b // m, ...), zero-padded."""
    lmax, L, b = max(split), full.shape[0], full.shape[1]
    out = np.zeros((len(split), lmax, m, b // m) + full.shape[2:],
                   full.dtype)
    off = 0
    for s, n in enumerate(split):
        out[s, :n] = full[off:off + n].reshape((n, m, b // m)
                                               + full.shape[2:])
        off += n
    assert off == L
    return out


def _from_pp_layout(pp_kv, split):
    return np.concatenate([pp_kv[s, :n].reshape(
        (n, -1) + pp_kv.shape[4:]) for s, n in enumerate(split)])


@pytest.mark.parametrize("n,pod_flops", [(2, [1.0, 0.5]), (4, None)])
def test_moe_pp_step_matches_the_references_unsplit_decode(n, pod_flops):
    arch, b = "granite-moe-3b-a800m", 8
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jmodel = jax_build(jcfg, remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    step, meta = _build(cfg, b, n, pod_flops)
    split, m = meta["pp_split"], meta["n_microbatches"]
    mb = b // m
    rng = np.random.RandomState(1)
    kv = (cfg.n_layers, b, S, cfg.n_kv_heads, cfg.hd)
    k0, v0 = (rng.randn(*kv).astype(np.float32) for _ in range(2))
    tok0 = rng.randint(0, cfg.vocab, (b, 1)).astype(np.int32)
    # reference: the unsplit decode_step on each microbatch's rows
    decode = jax.jit(jmodel.decode_step)
    ref_toks, ref_k, ref_v = [], [], []
    for i in range(m):
        rows = slice(i * mb, (i + 1) * mb)
        cache = {"k": jnp.asarray(k0[:, rows]), "v": jnp.asarray(v0[:, rows]),
                 "pos": jnp.int32(POS)}
        toks, seq = jnp.asarray(tok0[rows]), []
        for _ in range(TICKS):
            logits, cache = decode(jparams, cache, toks)
            toks = jmodel.sample_greedy(logits).astype(jnp.int32)
            seq.append(np.asarray(toks))
        ref_toks.append(np.stack(seq))
        ref_k.append(np.asarray(cache["k"]))
        ref_v.append(np.asarray(cache["v"]))
    ref_toks = np.concatenate(ref_toks, axis=1)
    params = pp.pack_pp_params(params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu"), split)
    cache = {"k": torch.from_numpy(_to_pp_layout(k0, split, m)),
             "v": torch.from_numpy(_to_pp_layout(v0, split, m)),
             "pos": torch.tensor(POS, dtype=torch.int32)}
    toks = torch.from_numpy(tok0)
    for t in range(TICKS):
        toks, cache = step(params, cache, toks)
        np.testing.assert_array_equal(toks.numpy(),
                                      ref_toks[t].reshape(b, 1),
                                      err_msg=f"tick {t}")
    for key, ref in (("k", ref_k), ("v", ref_v)):
        np.testing.assert_allclose(
            _from_pp_layout(cache[key].numpy(), split),
            np.concatenate(ref, axis=1), atol=ATOL, rtol=RTOL, err_msg=key)


# -- the step against the port's own unsplit decode ----------------------------
@pytest.mark.parametrize("arch,n,pod_flops,m", [
    ("qwen3-32b", 2, [1.0, 0.5], None),
    ("qwen3-32b", 3, [1.0, 0.6, 0.35], 4),
    ("qwen2-vl-2b", 4, None, 2)])
def test_pp_step_matches_the_ports_unsplit_decode(arch, n, pod_flops, m):
    """Prefill with the unsplit model, lay its K/V into the PP layout, then
    PP ticks against ``LM.decode_step`` one microbatch at a time: equal
    tokens, logits and caches."""
    cfg, b = get_config(arch).reduced(), 8
    model = build_model(cfg, device="cpu")
    params = model.init(seed=0)
    step, meta = _build(cfg, b, n, pod_flops, n_microbatches=m)
    split, m = meta["pp_split"], meta["n_microbatches"]
    mb = b // m
    prompt = torch.from_numpy(
        np.random.RandomState(2).randint(0, cfg.vocab, (b, 5)))
    logits, full = model.prefill(params, {"tokens": prompt}, max_len=S)
    first = model.sample_greedy(logits).reshape(b, 1)
    cache = {"k": torch.from_numpy(_to_pp_layout(full["k"].numpy(), split,
                                                 m)),
             "v": torch.from_numpy(_to_pp_layout(full["v"].numpy(), split,
                                                 m)),
             "pos": torch.tensor(5, dtype=torch.int32)}
    seen = []
    head = meta["model"].logits
    meta["model"].logits = lambda p, x: seen.append(head(p, x)) or seen[-1]
    packed = pp.pack_pp_params(params, split)
    refs = [{"k": full["k"][:, i * mb:(i + 1) * mb].clone(),
             "v": full["v"][:, i * mb:(i + 1) * mb].clone(),
             "pos": full["pos"][i * mb:(i + 1) * mb].clone()}
            for i in range(m)]
    toks = ref_toks = first
    for _ in range(4):
        seen.clear()
        toks, cache = step(packed, cache, toks)
        outs, ref_logits = [], []
        for i in range(m):
            lg, refs[i] = model.decode_step(
                params, refs[i], ref_toks[i * mb:(i + 1) * mb])
            ref_logits.append(lg)
            outs.append(model.sample_greedy(lg).reshape(mb, 1))
        ref_toks = torch.cat(outs)
        assert torch.equal(toks.long(), ref_toks)
        assert len(seen) == m
        torch.testing.assert_close(torch.cat(seen), torch.cat(ref_logits),
                                   atol=ATOL, rtol=RTOL)
    ref_k = torch.cat([r["k"] for r in refs], dim=1)
    torch.testing.assert_close(
        torch.from_numpy(_from_pp_layout(cache["k"].numpy(), split)), ref_k,
        atol=ATOL, rtol=RTOL)


def test_place_pp_lists_stages_and_serves_the_same_tokens():
    cfg = get_config("qwen3-32b").reduced()
    step, meta = _build(cfg, 8, 2, [1.0, 0.5])
    split, m = meta["pp_split"], meta["n_microbatches"]
    params = pp.pack_pp_params(build_model(cfg, device="cpu").init(seed=0),
                               split)
    rng = np.random.RandomState(3)
    shp = (2, max(split), m, 8 // m, S, cfg.n_kv_heads, cfg.hd)
    cache = {"k": torch.from_numpy(rng.randn(*shp).astype(np.float32)),
             "v": torch.from_numpy(rng.randn(*shp).astype(np.float32)),
             "pos": torch.tensor(POS, dtype=torch.int32)}
    placed_p, placed_c = pp.place_pp(
        params, {k: (v.clone() if k != "pos" else v)
                 for k, v in cache.items()}, ["cpu", "cpu"])
    assert isinstance(placed_c["k"], list) and len(placed_c["k"]) == 2
    assert isinstance(placed_p["layers"]["attn"]["wq"], list)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (8, 1)))
    a, cache = step(params, cache, toks)
    b, placed_c = step(placed_p, placed_c, toks)
    assert torch.equal(a, b)
    for s in range(2):
        assert torch.equal(cache["k"][s], placed_c["k"][s])
