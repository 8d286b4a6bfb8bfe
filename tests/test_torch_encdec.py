"""Encoder-decoder parity (whisper-tiny) and the registry as a whole: the
port's ``EncDecLM`` and Engine (plain PyTorch on the CPU) against the JAX
reference's on JAX-initialised params converted through numpy.

``encode``, ``prefill``, ``cross_kv``, ``prefill_chunk`` over consecutive
chunks (equal to one full prefill, as tests/test_chunk_prefill.py shows for
the reference) and ``decode_step`` give the reference's logits and cache
contents (fp32, 2e-5). The enc-dec Engine (contiguous: batched, chunked
with the cross cache warmed per group, legacy) and command-r-plus-104b's
reduced shape give the reference engine's greedy tokens and every
``EngineStats`` field, ``retraces`` included. Every config of the port's
``REGISTRY`` (the reference's key set) has a head dim and a query-per-KV
group the CUDA attention kernels take, and serves through
``build_model`` and an ``Engine`` on the CPU at reduced size.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.serving import Engine as JaxEngine
from repro.serving import ServeRequest as JaxRequest
from repro_torch.configs import REGISTRY, get_config
from repro_torch.kernels._build import HEAD_DIMS
from repro_torch.models import EncDecLM, build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import Engine, ServeRequest

TOL = dict(atol=2e-5, rtol=2e-5)
S_ENC = 8


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


@functools.lru_cache(maxsize=None)
def _arch(name):
    """(JAX model, JAX params, port model, port params) of a reduced arch,
    the port's params converted from the JAX init through numpy."""
    jcfg = jax_config(name).reduced()
    jm = jax_build(jcfg, remat=False, attn_chunk=0)
    jparams = jm.init(jax.random.PRNGKey(0))
    tcfg = get_config(name).reduced()
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jm, jparams, build_model(tcfg, device="cpu"), tparams


def _frames(b, d, seed=0):
    return np.random.RandomState(seed).randn(b, S_ENC, d).astype(np.float32)


def _prompts(rng, vocab, b, s):
    return rng.randint(0, vocab, (b, s)).astype(np.int32)


def test_schema_and_params_from_jax():
    jm, jparams, tm, tparams = _arch("whisper-tiny")
    assert isinstance(tm, EncDecLM)
    assert jax.tree.map(lambda x: tuple(x.shape), jparams) == \
        tm.param_shapes()
    assert sorted(tparams) == ["decoder", "embed", "enc_final_ln",
                               "encoder", "final_norm"]
    bad = jax.tree.map(np.asarray, jparams)
    bad["decoder"]["cross_attn"]["bk"] = bad["decoder"]["cross_attn"]["bk"][
        ..., :-1]
    with pytest.raises(ValueError):
        params_from_jax(bad, tm.cfg, device="cpu")


def test_encode_and_cross_kv_match_jax():
    jm, jparams, tm, tparams = _arch("whisper-tiny")
    fr = _frames(2, tm.cfg.d_model)
    jenc = jm.encode(jparams, jnp.asarray(fr))
    tenc = tm.encode(tparams, torch.from_numpy(fr))
    _close(tenc, jenc)
    jck, jcv = jm.cross_kv(jparams, jenc)
    tck, tcv = tm.cross_kv(tparams, tenc)
    _close(tck, jck)
    _close(tcv, jcv)


def test_prefill_and_decode_match_jax():
    """Batched prefill (a right-padded row read at ``last_pos``) into a
    ``max_len`` cache, then decode steps: logits and every cache entry."""
    jm, jparams, tm, tparams = _arch("whisper-tiny")
    rng = np.random.RandomState(1)
    toks = _prompts(rng, tm.cfg.vocab, 2, 11)
    fr = _frames(2, tm.cfg.d_model, seed=2)
    last = np.array([10, 6], np.int32)
    jl, jcache = jm.prefill(jparams, {"embeds": jnp.asarray(fr),
                                      "tokens": jnp.asarray(toks)},
                            max_len=24, last_pos=jnp.asarray(last))
    tl, tcache = tm.prefill(tparams, {"embeds": torch.from_numpy(fr),
                                      "tokens": torch.from_numpy(toks)},
                            max_len=24, last_pos=torch.from_numpy(last))
    _close(tl, jl)
    for key in ("k", "v", "ck", "cv"):
        _close(tcache[key], jcache[key])
    assert tcache["pos"].tolist() == [11, 11]
    for _ in range(3):
        nxt = _prompts(rng, tm.cfg.vocab, 2, 1)
        jl, jcache = jm.decode_step(jparams, jcache, jnp.asarray(nxt))
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(nxt))
        _close(tl, jl)
        for key in ("k", "v"):
            _close(tcache[key], jcache[key])
    assert tcache["pos"].tolist() == [14, 14]


def test_prefill_chunks_equal_one_full_prefill():
    """Consecutive decoder chunks over a cross cache warmed by ``cross_kv``
    give one full prefill's logits and K/V, in the port and against the
    reference's chunks; a decode step after them matches too."""
    jm, jparams, tm, tparams = _arch("whisper-tiny")
    rng = np.random.RandomState(3)
    b, s, c, max_len = 2, 15, 5, 32
    toks = _prompts(rng, tm.cfg.vocab, b, s)
    fr = _frames(b, tm.cfg.d_model, seed=4)
    full_l, full = tm.prefill(tparams, {"embeds": torch.from_numpy(fr),
                                        "tokens": torch.from_numpy(toks)},
                              max_len=max_len)
    tcache = tm.init_cache(b, max_len, S_ENC)
    tcache["ck"], tcache["cv"] = tm.cross_kv(
        tparams, tm.encode(tparams, torch.from_numpy(fr)))
    jcache = jm.init_cache(b, max_len, s_enc=S_ENC)
    jcache["ck"], jcache["cv"] = jm.cross_kv(
        jparams, jm.encode(jparams, jnp.asarray(fr)))
    for base in range(0, s, c):
        chunk = toks[:, base:base + c]
        tl, tcache = tm.prefill_chunk(tparams, tcache,
                                      torch.from_numpy(chunk), base)
        jl, jcache = jm.prefill_chunk(jparams, jcache, jnp.asarray(chunk),
                                      jnp.asarray(base, jnp.int32))
        _close(tl, jl)
    _close(tl, full_l.numpy())
    for key in ("k", "v"):
        _close(tcache[key], full[key].numpy())
        _close(tcache[key], jcache[key])
    assert tcache["pos"].tolist() == [s, s]
    nxt = _prompts(rng, tm.cfg.vocab, b, 1)
    tl, _ = tm.decode_step(tparams, tcache, torch.from_numpy(nxt))
    jl, _ = jm.decode_step(jparams, jcache, jnp.asarray(nxt))
    _close(tl, jl)


# -- engines ------------------------------------------------------------------

def _batched(eng, Req):
    rs = [Req(prompt=list(range(1, 4 + 3 * i)), max_new_tokens=4 + i)
          for i in range(5)]
    assert len(eng.admit_many(rs)) == 5
    eng.drain()
    return rs


def _more_than_slots(eng, Req):
    rs = [Req(prompt=[1 + i, 2, 3], max_new_tokens=3) for i in range(5)]
    left = rs
    while left:
        taken = {id(r) for r in eng.admit_many(left)}
        left = [r for r in left if id(r) not in taken]
        eng.drain()
    return rs


def _chunked(eng, Req):
    """Two chunked groups of different sizes (one warm-up each) beside a
    live request, and short prompts batched."""
    live = Req(prompt=[3, 1, 4], max_new_tokens=12)
    eng.admit(live)
    longs = [Req(prompt=list(range(1 + i, 30 + 3 * i)), max_new_tokens=4 + i)
             for i in range(3)]
    eng.admit_many(longs[:2])
    eng.step()
    short = Req(prompt=[5, 6], max_new_tokens=3)
    eng.admit_many(longs[2:] + [short])
    eng.drain()
    return [live] + longs + [short]


ENC_SCENARIOS = {
    "batched": (_batched, dict(max_batch=8, max_len=64)),
    "more_than_slots": (_more_than_slots, dict(max_batch=2, max_len=64)),
    "chunked": (_chunked, dict(max_batch=5, max_len=64, prefill_chunk=8)),
    "legacy": (_chunked, dict(max_batch=5, max_len=64, prefill_chunk=8,
                              admission="legacy")),
}


def _run_both(name, scenario, kw):
    jm, jparams, tm, tparams = _arch(name)
    je = JaxEngine(jm.cfg, jparams, use_pallas=False, victim_policy="fewest",
                   **kw)
    te = Engine(tm.cfg, tparams, device="cpu", victim_policy="fewest", **kw)
    jreqs = scenario(je, JaxRequest)
    treqs = scenario(te, ServeRequest)
    assert [list(r.generated) for r in treqs] == \
        [list(r.generated) for r in jreqs]
    assert all(r.done for r in treqs)
    assert dataclasses.asdict(te.stats) == dataclasses.asdict(je.stats)
    assert te.kv_layout == je.kv_layout
    return je, te


@pytest.mark.parametrize("name", sorted(ENC_SCENARIOS))
def test_encdec_engine_matches_jax(name):
    """whisper-tiny through the Engine (contiguous: the auto layout): batched
    prefill, more requests than slots, chunked prefill whose groups warm
    their cross cache once per group size, and legacy batch-1 admission;
    tokens and every EngineStats field (retraces too) equal the JAX
    engine's."""
    scenario, kw = ENC_SCENARIOS[name]
    _, te = _run_both("whisper-tiny", scenario, kw)
    assert te.kv_layout == "contig" and te.bm is None
    if name == "chunked":
        assert te.stats.prefill_chunks > 0 and te.stats.chunk_scatters > 0
    if name == "legacy":
        assert te.stats.prefill_chunks == 0


CMDR_SCENARIOS = {
    "batched": (_batched, dict(max_batch=8, max_len=64)),
    "chunked": (_chunked, dict(max_batch=5, max_len=64, prefill_chunk=8,
                               block_size=8)),
    "chunked_contig": (_chunked, dict(max_batch=5, max_len=64,
                                      prefill_chunk=8, kv_layout="contig")),
}


@pytest.mark.parametrize("name", sorted(CMDR_SCENARIOS))
def test_command_r_engine_matches_jax(name):
    """command-r-plus-104b's shape at reduced size (layernorm, tied
    embeddings, GQA) through the dense trunk: paged batched and chunked,
    contiguous chunked."""
    scenario, kw = CMDR_SCENARIOS[name]
    _, te = _run_both("command-r-plus-104b", scenario, kw)
    assert te.model.cfg.norm == "layernorm" and te.model.cfg.tie_embeddings


# -- the registry as a whole --------------------------------------------------

def test_registry_matches_the_reference():
    assert sorted(REGISTRY) == sorted(JAX_REGISTRY)
    for name, cfg in REGISTRY.items():
        assert dataclasses.asdict(cfg) == \
            dataclasses.asdict(JAX_REGISTRY[name]), name


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_every_config_fits_the_attention_kernels(name):
    """At full size, every config that attends has a head dim the CUDA
    kernels are built for and whole query-per-KV groups the bf16 bodies
    take (at most 16 per KV head: the decode body's one m16 tile; the
    prefill body takes up to 128). h2o-danube-3-4b's head dim 120 was
    missing once: its every attention call raised on the card."""
    cfg = REGISTRY[name]
    if cfg.n_heads == 0:                 # attention-free (mamba2)
        return
    assert cfg.hd in HEAD_DIMS, (name, cfg.hd)
    assert cfg.n_heads % cfg.n_kv_heads == 0
    assert cfg.n_heads // cfg.n_kv_heads <= 16


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_every_config_serves_on_cpu(name):
    """``build_model`` and an ``Engine`` on its auto layout serve every
    registered config at reduced size on the CPU."""
    cfg = get_config(name).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(seed=0)
    eng = Engine(cfg, params, device="cpu", max_batch=2, max_len=32,
                 prefill_chunk=8)
    rs = [ServeRequest(prompt=list(range(1, 4 + 9 * i)), max_new_tokens=3)
          for i in range(3)]
    left = rs
    while left:
        taken = {id(r) for r in eng.admit_many(left)}
        left = [r for r in left if id(r) not in taken]
        eng.drain()
    assert all(r.done and len(r.generated) == 3 for r in rs)
    assert all(0 <= t < cfg.vocab for r in rs for t in r.generated)
