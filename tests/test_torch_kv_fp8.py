"""fp8 KV caches in the port (``kv_cache_dtype``: ``common.astype``, the
cache writers, ``launch/steps.py``'s serve step) against the JAX package.

fp8 crosses between the two as ``uint8`` views: torch's fp8 tensors have
no numpy twin, and the port does not import ``ml_dtypes``.

- The cast: ``astype``'s bytes equal ``jnp.astype``'s on every bf16 bit
  pattern and on an fp32 sweep around +-448 / +-464 / +-57344 and the
  subnormals, in both formats (a NaN equals a NaN whatever its sign);
  every fp8 code upcasts to fp32 and bf16 exactly; a weight past 464
  stores as NaN in ``float8_e4m3fn``, as the reference's ``astype``
  stores it (fault C6).
- The plain decode on an fp8 cache equals the reference's jnp
  ``decode_attention`` and its Pallas kernel in interpret mode on the
  same bytes.
- The serve step built with ``kv_cache_dtype`` against the reference's
  ``build_step`` serve function on a (1, 1) mesh, both from the
  reference's prefill cache cast by its ``astype``, three steps, both
  formats: dense, MoE, VLM, the ring cache of a sliding-window model,
  Zamba2 in bf16 and Mamba2 in bf16 (where the rule quantizes nothing).
  Tokens equal; the stored prefill's bytes equal; the written fp8 bytes
  equal at fp32; at bf16 the two sides' K / V differ as their bf16
  arithmetic does, and an fp8 entry is held within one fp8 step plus 2e-2
  of the leaf's largest value.
- The refusals: the encoder-decoder and fp32 Mamba2 / Zamba2, where the
  reference's serve step raises ``TypePromotionError`` on the cache its
  rule quantizes.
- Gloo worlds (1, 2) and (2, 2) serving an fp8 cache against the
  unsplit port step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import repro.launch.steps as jsteps
from repro.configs import get_config as jax_config
from repro.configs.shapes import ShapeSpec as JShapeSpec
from repro.kernels import decode_attention as jdec
from repro.models import attention as jattn
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as da
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import mesh_for_rank, run_ranks
from repro_torch.models.common import FP8_DTYPES, astype
from repro_torch.models.convert import _to_tensor, params_from_jax

FORMATS = ("float8_e4m3fn", "float8_e5m2")
JNP = {"float8_e4m3fn": jnp.float8_e4m3fn, "float8_e5m2": jnp.float8_e5m2}


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8).numpy()


def _from_bytes(a: np.ndarray, fmt: str) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.uint8).copy()
                            ).view(FP8_DTYPES[fmt])


def _jnp_bytes(x) -> np.ndarray:
    return np.asarray(x).view(np.uint8)


def _assert_same_codes(got: np.ndarray, want: np.ndarray, fmt: str,
                       what: str) -> None:
    """Equal fp8 bytes, where two NaNs are equal whatever their sign."""
    nan_g = np.isnan(_from_bytes(got, fmt).float().numpy())
    nan_w = np.isnan(_from_bytes(want, fmt).float().numpy())
    np.testing.assert_array_equal(nan_g, nan_w, err_msg=f"{what}: NaNs")
    bad = (got != want) & ~nan_g
    assert not bad.any(), (what, np.flatnonzero(bad)[:10])


# mantissa bits: one fp8 step is at most 2^-bits of an element
MANTISSA = {"float8_e4m3fn": 3, "float8_e5m2": 2}


def _assert_fp8_close(got: np.ndarray, want: np.ndarray, fmt: str,
                      what: str) -> None:
    """bf16 models: the two sides' bf16 K / V differ as their bf16
    arithmetic does (the unquantized leaves are held at 2e-2), and each
    rounds to fp8 on its own: held within one fp8 step of the element
    plus 2e-2 of the leaf's largest value."""
    g = _from_bytes(got, fmt).float().numpy()
    w = _from_bytes(want, fmt).float().numpy()
    np.testing.assert_allclose(g, w, rtol=2.0 ** -MANTISSA[fmt],
                               atol=2e-2 * np.abs(w).max(), err_msg=what)


def _fp8_steps_apart(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """How many fp8 codes apart two byte arrays of one format are (codes
    ordered by value: the magnitude's code with the sign applied)."""
    def order(x):
        x = x.astype(np.int32)
        return np.where(x & 0x80, -(x & 0x7F), x & 0x7F)
    return np.abs(order(a) - order(b))


# -- the cast -------------------------------------------------------------------
@pytest.mark.parametrize("fmt", FORMATS)
def test_astype_matches_jax_on_every_bf16_value(fmt):
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    x = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    want = _jnp_bytes(jnp.asarray(bits).view(jnp.bfloat16).astype(JNP[fmt]))
    _assert_same_codes(_bytes(astype(x, FP8_DTYPES[fmt])), want, fmt,
                       "bf16")
    if fmt == "float8_e4m3fn":
        # where torch's own cast saturates: |x| >= 466 and +-inf
        plain = _bytes(x.to(FP8_DTYPES[fmt]))
        assert (np.isnan(x.float().numpy()) | (plain == want)).sum() < (
            1 << 16) - 30000


def _sweep() -> np.ndarray:
    """fp32 values around the formats' edges: +-448 / 464 / 480 (e4m3fn's
    largest value, the midpoint past it, the code past it), 57344 / 61440
    / 65536 (e5m2's), the smallest subnormals and normals, 1; each point
    scaled over +-20% and its 64 nearest fp32 neighbours on each side;
    plus the infinities, NaN and zeros."""
    pts = np.array([448, 464, 480, 57344, 61440, 65536, 2.0 ** -9,
                    2.0 ** -10, 2.0 ** -6, 2.0 ** -7, 2.0 ** -16,
                    2.0 ** -17, 2.0 ** -14, 2.0 ** -15, 1.0], np.float32)
    out = [p * (1 + np.linspace(-0.2, 0.2, 4001, dtype=np.float32))
           for p in pts]
    for p in pts:
        lo = hi = p
        for _ in range(64):
            lo = np.nextafter(lo, np.float32(0))
            hi = np.nextafter(hi, np.float32(np.inf))
            out.append(np.array([lo, hi], np.float32))
    out.append(np.array([np.inf, np.nan, 0.0], np.float32))
    x = np.concatenate(out).astype(np.float32)
    return np.concatenate([x, -x])


@pytest.mark.parametrize("fmt", FORMATS)
def test_astype_matches_jax_on_an_fp32_sweep(fmt):
    x = _sweep()
    got = _bytes(astype(torch.from_numpy(x), FP8_DTYPES[fmt]))
    _assert_same_codes(got, _jnp_bytes(jnp.asarray(x).astype(JNP[fmt])),
                       fmt, "fp32")


@pytest.mark.parametrize("fmt", FORMATS)
def test_every_fp8_code_upcasts_exactly(fmt):
    codes = np.arange(256, dtype=np.uint8)
    t = _from_bytes(codes, fmt)
    j = jnp.asarray(codes).view(JNP[fmt])
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        got = t.to(tdt).float().numpy()
        want = np.asarray(j.astype(jdt).astype(jnp.float32))
        np.testing.assert_array_equal(got, want, err_msg=str(tdt))
        # the upcast is exact: back to fp8 gives the code (NaN aside)
        back = _bytes(astype(t.to(tdt), FP8_DTYPES[fmt]))
        real = ~np.isnan(got)
        np.testing.assert_array_equal(back[real], codes[real])


def test_fp8_weight_store_rounds_overflow_to_nan_as_the_reference():
    """Fault C6: ``BuiltStep._store`` wrote fp8 weights with torch's cast,
    which saturates a ``float8_e4m3fn`` overflow to +-448 where the
    reference's ``astype`` gives NaN."""
    cfg = get_config("qwen3-32b").reduced()
    srv = S.build_step(cfg, ShapeSpec("d", 12, 2, "serve_step"),
                       mesh_for_rank((1, 1), ("data", "model"), 0),
                       weight_dtype="float8_e4m3fn", device="cpu")
    params = srv.model.init(seed=0)
    wq = params["layers"]["attn"]["wq"]
    wq[0, 0, :4] = torch.tensor([500.0, -500.0, 464.0, 470.0])
    stored = srv.shard_params(params)["layers"]["attn"]["wq"]
    assert stored.dtype == torch.float8_e4m3fn
    got = stored[0, 0, :4].float()
    assert torch.isnan(got[0]) and torch.isnan(got[1]) and torch.isnan(got[3])
    assert got[2] == 448.0
    want = jnp.asarray(wq.numpy()).astype(jnp.float8_e4m3fn)
    _assert_same_codes(_bytes(stored), _jnp_bytes(want), "float8_e4m3fn",
                       "wq")


# -- the decode oracle on an fp8 cache ------------------------------------------
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("qdt", ["float32", "bfloat16"])
def test_plain_decode_on_an_fp8_cache_equals_the_reference(fmt, qdt):
    rng = np.random.RandomState(3)
    b, s, nh, nkv, d = 3, 64, 8, 2, 32
    q = rng.randn(b, 1, nh, d).astype(np.float32)
    # K moderate (the scores stay O(1)), V across the format's range
    kv = [np.asarray(jnp.asarray(rng.randn(b, s, nkv, d).astype(np.float32)
                                 * scale).astype(JNP[fmt])).view(np.uint8)
          for scale in (2.0, 40.0)]
    pos = np.array([0, 37, 63], np.int32)
    jq = jnp.asarray(q).astype(qdt)
    jk, jv = (jnp.asarray(a).view(JNP[fmt]) for a in kv)
    tq = torch.from_numpy(q).to(getattr(torch, qdt))
    tk, tv = (_from_bytes(a, fmt) for a in kv)
    for window in (None, 20):
        got = da.decode_attention_plain(tq, tk, tv, torch.from_numpy(pos),
                                        window=window).float().numpy()
        ref = jattn.decode_attention(jq, jk, jv, jnp.asarray(pos), None,
                                     window=window)
        pallas = jdec.decode_attention(jq, jk, jv, jnp.asarray(pos),
                                       window=window, block_kv=32,
                                       interpret=True)
        # fp32: two summation orders over V of up to +-448, relative to
        # the output's largest element; bf16: about one bf16 step of it
        tol = 1e-5 if qdt == "float32" else 1e-2
        for name, want in (("jnp", ref), ("pallas", pallas)):
            want = np.asarray(want.astype(jnp.float32))
            np.testing.assert_allclose(
                got, want, atol=tol * np.abs(want).max(), rtol=0,
                err_msg=f"{name} window={window}")


def test_only_the_contiguous_decode_kernel_takes_an_fp8_cache():
    q = torch.zeros((2, 1, 4, 16))
    k = torch.zeros((2, 8, 2, 16), dtype=torch.float8_e5m2)
    _build.expect_attention("decode_attention", q, k, k, fp8_kv=True)
    with pytest.raises(ValueError, match="contiguous decode kernel"):
        _build.expect_attention("chunk_attention", q, k, k)
    with pytest.raises(ValueError, match="one fp8 dtype"):
        _build.expect_attention("decode_attention", q, k,
                                k.to(torch.float8_e4m3fn), fp8_kv=True)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        _build.expect_attention("decode_attention", q.half(), k, k,
                                fp8_kv=True)


# -- the serve step against the reference's ------------------------------------
B, PROMPT, MAX_LEN, STEPS = 2, 12, 20, 3
# name -> (arch, dtype override or None); danube's reduced window (8) is
# shorter than the prompt, so its ring cache has wrapped
SERVE_CASES = {
    "dense": ("internlm2-1.8b", None),
    "moe": ("granite-moe-3b-a800m", None),
    "vlm": ("qwen2-vl-2b", None),
    "ring": ("h2o-danube-3-4b", None),
    "hybrid_bf16": ("zamba2-2.7b", "bfloat16"),
    "ssm_bf16": ("mamba2-1.3b", "bfloat16"),
}


def _configs(arch, dtype):
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    if dtype:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return jcfg, cfg


def _jmesh():
    return JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                   ("data", "model"))


def _inputs(cfg, rng):
    if cfg.frontend == "vision_embeds":
        t = np.arange(PROMPT)
        pos = np.stack([t, t // 2, t % 3 + t // 3])
        return {"embeds": rng.randn(B, PROMPT, cfg.d_model).astype(
                    np.float32),
                "positions": np.broadcast_to(pos[:, None], (3, B, PROMPT))
                .astype(np.int32).copy()}
    return {"tokens": rng.randint(0, cfg.vocab, (B, PROMPT)).astype(
        np.int32)}


def _ref_serve(jcfg, fmt, inputs):
    """The reference: its prefill, the cache cast by its ``maybe_q`` rule
    with ``astype``, then ``STEPS`` of its ``build_step`` serve function.
    Returns (params, the prefill cache, the stored cache, tokens, the
    last cache), arrays as numpy, fp8 as bytes."""
    model = jax_build(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    mesh = _jmesh()
    shape = JShapeSpec("d", MAX_LEN, B, "serve_step")
    built = jsteps.build_step(jcfg, shape, mesh, kv_cache_dtype=fmt)
    dt = model.dtype
    logits, cache = jax.jit(lambda p, i: model.prefill(
        p, i, max_len=MAX_LEN))(params, {k: jnp.asarray(v)
                                         for k, v in inputs.items()})
    stored = {k: v.astype(JNP[fmt]) if v.dtype == dt and v.ndim >= 5
              else v for k, v in cache.items()}
    tok = model.sample_greedy(logits).reshape(B, 1).astype(jnp.int32)
    fn = jax.jit(built.fn)
    cur, run, toks = tok, stored, [np.asarray(tok)]
    with mesh:
        for _ in range(STEPS):
            cur, run = fn(params, run, cur)
            toks.append(np.asarray(cur))

    def host(tree):
        return {k: _jnp_bytes(v) if v.dtype == JNP[fmt] else np.asarray(v)
                for k, v in tree.items()}
    return (jax.tree.map(np.asarray, params), host(cache), host(stored),
            np.concatenate(toks, 1), host(run))


def _port_cache(ref_cache: dict) -> dict:
    return {k: torch.full((B,), int(v), dtype=torch.int32) if k == "pos"
            else _to_tensor(v, torch.device("cpu"))
            for k, v in ref_cache.items()}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_serve_step_on_an_fp8_cache_equals_the_reference(case, fmt):
    jcfg, cfg = _configs(*SERVE_CASES[case])
    inputs = _inputs(cfg, np.random.RandomState(0))
    params, pre_cache, stored_ref, ref_toks, ref_last = _ref_serve(
        jcfg, fmt, inputs)
    srv = S.build_step(cfg, ShapeSpec("d", MAX_LEN, B, "serve_step"),
                       mesh_for_rank((1, 1), ("data", "model"), 0),
                       kv_cache_dtype=fmt, device="cpu")
    cache = srv.store_cache(_port_cache(pre_cache))
    quantized = sorted(k for k, v in cache.items()
                       if v.dtype == FP8_DTYPES[fmt])
    want_q = {"ssm_bf16": [], "hybrid_bf16": ["ak", "av"]}.get(
        case, ["k", "v"])
    assert quantized == want_q
    for k, spec in srv.args_shapes[1].items():
        assert spec.dtype == cache[k].dtype, k
    for k in quantized:               # the stored prefill: the same bytes
        _assert_same_codes(_bytes(cache[k]), stored_ref[k], fmt, k)
    p = params_from_jax(params, cfg, device="cpu")
    cur, toks = torch.from_numpy(ref_toks[:, :1].copy()), [ref_toks[:, :1]]
    with torch.no_grad():
        for _ in range(STEPS):
            cur, cache = srv.fn(p, cache, cur)
            toks.append(cur.numpy())
    np.testing.assert_array_equal(np.concatenate(toks, 1), ref_toks)
    for k, v in cache.items():
        if k == "pos":
            continue
        if k not in quantized:
            np.testing.assert_allclose(v.float().numpy(),
                                       np.asarray(ref_last[k], np.float32),
                                       atol=2e-5 if cfg.dtype == "float32"
                                       else 2e-2, rtol=2e-2, err_msg=k)
            continue
        got = _bytes(v)
        if cfg.dtype == "float32":
            _assert_same_codes(got, ref_last[k], fmt, k)
        else:
            _assert_fp8_close(got, ref_last[k], fmt, k)


@pytest.mark.parametrize("arch,dtype,line", [
    ("whisper-tiny", None, "encdec.py:333"),
    ("whisper-tiny", "bfloat16", "encdec.py:333"),
    ("mamba2-1.3b", None, "ssm.py:143"),
    ("zamba2-2.7b", None, "ssm.py:143")])
def test_kv_fp8_is_refused_where_the_reference_fails(arch, dtype, line):
    jcfg, cfg = _configs(arch, dtype)
    shape = ShapeSpec("d", MAX_LEN, B, "serve_step")
    with pytest.raises(NotImplementedError, match=line.replace(".", r"\.")):
        S.build_step(cfg, shape, mesh_for_rank((1, 1), ("data", "model"), 0),
                     kv_cache_dtype="float8_e4m3fn", device="cpu")
    # the prefill step ignores it, as the reference's does
    S.build_step(cfg, ShapeSpec("p", MAX_LEN, B, "prefill_step"),
                 mesh_for_rank((1, 1), ("data", "model"), 0),
                 kv_cache_dtype="float8_e4m3fn", device="cpu")
    # the reference raises on the cache its rule quantizes
    model = jax_build(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    built = jsteps.build_step(jcfg, JShapeSpec("d", MAX_LEN, B, "serve_step"),
                              _jmesh(), kv_cache_dtype="float8_e4m3fn")
    rng = np.random.RandomState(0)
    cache = {k: (jnp.asarray(rng.randn(*v.shape).astype(np.float32))
                 .astype(v.dtype) if jnp.issubdtype(v.dtype, jnp.floating)
                 else jnp.zeros(v.shape, v.dtype))
             for k, v in built.args_sds[1].items()}
    tokens = jnp.zeros((B, 1), jnp.int32)
    # jax's TypePromotionError, a ValueError
    with pytest.raises(ValueError, match="no available implicit dtype "
                                         "promotion path"):
        with _jmesh():
            jax.jit(built.fn)(params, cache, tokens)


# -- tensor-parallel worlds against the unsplit port step -----------------------
TP_CASES = {"dense": ("internlm2-1.8b", None, "float8_e4m3fn"),
            "hybrid_bf16": ("zamba2-2.7b", "bfloat16", "float8_e5m2")}
TP_STEPS = 4


def _tp_case(name, rng):
    arch, dtype, fmt = TP_CASES[name]
    _, cfg = _configs(arch, dtype)
    return dict(cfg=cfg, inputs=_inputs(cfg, rng), steps=TP_STEPS,
                max_len=MAX_LEN, kv_cache_dtype=fmt)


@pytest.fixture(scope="module")
def unsplit_runs():
    """Each case on a (1, 1) mesh in this process, its seeded init."""
    rng = np.random.RandomState(5)
    cases = {n: _tp_case(n, rng) for n in TP_CASES}
    runs = {n: S.serve_generate(mesh_for_rank((1, 1), ("data", "model"), 0),
                                torch.device("cpu"), **c)
            for n, c in cases.items()}
    return cases, runs


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_world_serves_an_fp8_cache_as_the_unsplit_step(unsplit_runs,
                                                       mesh_shape):
    cases, runs = unsplit_runs
    names = list(TP_CASES)
    # each rank steps on the unsplit run's tokens, so a bf16 argmax near a
    # tie cannot send the two runs down different prompts
    world = [dict(cases[n], feed=runs[n]["tokens"][:, :-1]) for n in names]
    outs = run_ranks(S.serve_cases, mesh_shape, ("data", "model"),
                     args=(world,))
    for rank, per_case in enumerate(outs):
        srv_mesh = mesh_for_rank(mesh_shape, ("data", "model"), rank)
        for name, got in zip(names, per_case):
            ref, cfg = runs[name], cases[name]["cfg"]
            fmt = cases[name]["kv_cache_dtype"]
            lo, hi = got["rows"]
            fp32 = cfg.dtype == "float32"
            if fp32:
                np.testing.assert_array_equal(got["tokens"], ref["tokens"])
            scale = np.abs(ref["logits"][lo:hi]).max()
            np.testing.assert_allclose(
                got["logits"], ref["logits"][lo:hi],
                atol=(2e-5 if fp32 else 2e-2) * max(1.0, scale), rtol=0,
                err_msg=f"{name} rank {rank}")
            assert set(got["cache_bytes"]) == set(ref["cache_bytes"]) == (
                {"k", "v"} if name == "dense" else {"ak", "av"}), name
            srv = S.build_step(cfg, ShapeSpec("d", MAX_LEN, B, "serve_step"),
                               srv_mesh, device="cpu")
            full = {k: torch.from_numpy(v.copy())
                    for k, v in ref["cache"].items()}
            full.update({k: _from_bytes(v, fmt)
                         for k, v in ref["cache_bytes"].items()})
            want = srv.shard_cache(full)
            for k, v in got["cache_bytes"].items():
                apart = _fp8_steps_apart(v, _bytes(want[k]))
                # fp32: the ranks' partial sums round K in another order;
                # an entry may land one fp8 code over on a midpoint
                assert apart.max() <= 1 and (apart > 0).mean() < 1e-3, (
                    name, k, int(apart.max()), float((apart > 0).mean()))
            assert got["launches"]["decode_attention"] == 0  # the CPU
