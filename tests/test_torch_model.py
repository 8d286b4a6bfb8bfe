"""Model parity: the port's dense LM (plain PyTorch on the CPU) against the
JAX reference LM on JAX-initialised params converted through numpy.

``prefill`` into a paged cache, engine-direct ``prefill_chunk`` (per-row
table snapshots, ``lens`` masking) and ``decode_step`` must give the same
logits and the same pool contents at written positions (fp32, 2e-5), on
reduced qwen3-32b (GQA), qwen2-0.5b (qkv bias, tied embeddings) and
h2o-danube-3-4b (sliding window). On the contiguous layout: MoE prefill and
decode (granite-moe, phi3.5-moe), dense chunk chains against one full
prefill, and the MoE param tree through ``params_from_jax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax

TOL = dict(atol=2e-5, rtol=2e-5)
ARCHS = ["qwen3-32b", "qwen2-0.5b", "h2o-danube-3-4b"]


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _pool_close(tcache, jcache):
    # block 0 is the trash block: pad columns race there, never read
    for key in ("k", "v"):
        _close(tcache[key][:, 1:], jcache[key][:, 1:])


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jcfg = jax_config(request.param).reduced()
    jm = jax_build(jcfg, remat=False, attn_chunk=0)
    jparams = jm.init(jax.random.PRNGKey(0))
    tcfg = get_config(request.param).reduced()
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jm, jparams, build_model(tcfg, device="cpu"), tparams


def test_prefill_chunk_decode_match_jax(models):
    jm, jparams, tm, tparams = models
    rng = np.random.RandomState(0)
    vocab = tm.cfg.vocab
    toks = rng.randint(0, vocab, (2, 20)).astype(np.int32)
    tbl = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    jcache = jm.init_cache(2, 32, vector_pos=True, kv_layout="paged",
                           n_blocks=9, block_size=8)
    jcache["block_tbl"] = jnp.asarray(tbl)
    tcache = tm.init_cache(2, 32, kv_layout="paged", n_blocks=9,
                           block_size=8)
    tcache["block_tbl"] = torch.from_numpy(tbl)

    jl, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                            cache=jcache)
    tl, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                            cache=tcache)
    _close(tl, jl)
    _pool_close(tcache, jcache)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))

    nxt = rng.randint(0, vocab, (2, 1)).astype(np.int32)
    jl, jcache = jm.decode_step(jparams, jcache, jnp.asarray(nxt))
    tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(nxt))
    _close(tl, jl)
    _pool_close(tcache, jcache)

    # engine-direct chunk: row 1 stops after 3 columns (rest -> trash)
    ch = rng.randint(0, vocab, (2, 5)).astype(np.int32)
    lens = np.array([5, 3], np.int32)
    last = np.array([4, 2], np.int32)
    jl, jcache = jm.prefill_chunk(
        jparams, jcache, jnp.asarray(ch), jnp.asarray(21, jnp.int32),
        last_pos=jnp.asarray(last), block_tbl=jnp.asarray(tbl),
        lens=jnp.asarray(lens))
    tl, tcache = tm.prefill_chunk(
        tparams, tcache, torch.from_numpy(ch), 21,
        last_pos=torch.from_numpy(last), block_tbl=torch.from_numpy(tbl),
        lens=torch.from_numpy(lens))
    _close(tl, jl)
    _pool_close(tcache, jcache)


def test_greedy_tokens_match_jax(models):
    """Sampling over the un-padded vocab agrees token for token."""
    jm, jparams, tm, tparams = models
    rng = np.random.RandomState(1)
    toks = rng.randint(0, tm.cfg.vocab, (3, 9)).astype(np.int32)
    tbl = np.array([[1, 2], [3, 4], [5, 6]], np.int32)
    jcache = jm.init_cache(3, 16, vector_pos=True, kv_layout="paged",
                           n_blocks=7, block_size=8)
    jcache["block_tbl"] = jnp.asarray(tbl)
    tcache = tm.init_cache(3, 16, kv_layout="paged", n_blocks=7,
                           block_size=8)
    tcache["block_tbl"] = torch.from_numpy(tbl)
    jl, _ = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, cache=jcache)
    tl, _ = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                       cache=tcache)
    assert tm.sample_greedy(tl).tolist() == \
        np.asarray(jm.sample_greedy(jl)).tolist()


def test_seeded_init_is_deterministic_and_shaped():
    cfg = get_config("qwen3-32b").reduced()
    m = build_model(cfg, device="cpu")
    a, b = m.init(seed=3), m.init(seed=3)
    torch.testing.assert_close(a["layers"]["attn"]["wq"],
                               b["layers"]["attn"]["wq"], rtol=0, atol=0)
    assert tuple(a["layers"]["mlp"]["w_up"].shape) == \
        (cfg.n_layers, cfg.d_model, cfg.d_ff)
    assert torch.all(a["final_norm"]["w"] == 1)
    jp = jax_build(jax_config("qwen3-32b").reduced()).init(
        jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda x: tuple(x.shape), jp)
    assert shapes == m.param_shapes()


# -- contiguous layout and the MoE family ----------------------------------

MOE_ARCHS = ["granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b"]


def _pair_models(arch):
    jcfg = jax_config(arch).reduced()
    jm = jax_build(jcfg, remat=False, attn_chunk=0)
    jparams = jm.init(jax.random.PRNGKey(0))
    tcfg = get_config(arch).reduced()
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jm, jparams, build_model(tcfg, device="cpu"), tparams


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_models(request):
    return _pair_models(request.param)


def test_moe_prefill_decode_match_jax_on_contig(moe_models):
    """MoE prefill into a fresh contiguous cache, then per-row-position
    decode steps (one row frozen at the cache end, clamped as in the
    reference): logits and cache contents match the JAX LM."""
    jm, jparams, tm, tparams = moe_models
    rng = np.random.RandomState(2)
    toks = rng.randint(0, tm.cfg.vocab, (2, 9)).astype(np.int32)
    jl, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                            max_len=16, ring=False)
    tl, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                            max_len=16)
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])
    assert tcache["pos"].tolist() == [9, 9]
    jcache["pos"] = jnp.asarray([9, 15], jnp.int32)   # row 1 at the end
    tcache["pos"] = torch.tensor([9, 15], dtype=torch.int32)
    for _ in range(3):
        nxt = rng.randint(0, tm.cfg.vocab, (2, 1)).astype(np.int32)
        jl, jcache = jm.decode_step(jparams, jcache, jnp.asarray(nxt))
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(nxt))
        _close(tl, jl)
        for key in ("k", "v"):
            _close(tcache[key], jcache[key])
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))


def test_moe_paged_decode_matches_jax():
    """On the paged layout (which the engine never picks for MoE) the LM
    works as the reference's does."""
    jm, jparams, tm, tparams = _pair_models("phi3.5-moe-42b-a6.6b")
    rng = np.random.RandomState(3)
    toks = rng.randint(0, tm.cfg.vocab, (2, 10)).astype(np.int32)
    tbl = np.array([[1, 2], [3, 4]], np.int32)
    jcache = jm.init_cache(2, 16, vector_pos=True, kv_layout="paged",
                           n_blocks=5, block_size=8)
    jcache["block_tbl"] = jnp.asarray(tbl)
    tcache = tm.init_cache(2, 16, kv_layout="paged", n_blocks=5,
                           block_size=8)
    tcache["block_tbl"] = torch.from_numpy(tbl)
    jl, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                            cache=jcache)
    tl, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                            cache=tcache)
    _close(tl, jl)
    nxt = rng.randint(0, tm.cfg.vocab, (2, 1)).astype(np.int32)
    jl, _ = jm.decode_step(jparams, jcache, jnp.asarray(nxt))
    tl, _ = tm.decode_step(tparams, tcache, torch.from_numpy(nxt))
    _close(tl, jl)


@pytest.mark.parametrize("arch", ["qwen3-32b", "h2o-danube-3-4b"])
def test_contig_prefill_chunk_chain_matches_full_prefill_and_jax(arch):
    """Chunks of 7 appended to a contiguous cache equal one full prefill
    (logits at the last position, K/V of every position) and match the
    JAX LM's chunk by chunk; decode then continues identically."""
    jm, jparams, tm, tparams = _pair_models(arch)
    rng = np.random.RandomState(4)
    b, n, c, max_len = 2, 21, 7, 32
    toks = rng.randint(0, tm.cfg.vocab, (b, n)).astype(np.int32)
    full_l, full = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                              max_len=max_len)
    tcache = tm.init_cache(b, max_len)
    jcache = jm.init_cache(b, max_len, ring=False)
    for base in range(0, n, c):
        ch = toks[:, base:base + c]
        tl, tcache = tm.prefill_chunk(tparams, tcache, torch.from_numpy(ch),
                                      base)
        jl, jcache = jm.prefill_chunk(jparams, jcache, jnp.asarray(ch),
                                      jnp.asarray(base, jnp.int32))
        _close(tl, jl)
        assert tcache["pos"].tolist() == [base + c] * b
    torch.testing.assert_close(tl, full_l, atol=2e-5, rtol=2e-5)
    for key in ("k", "v"):
        torch.testing.assert_close(tcache[key], full[key], atol=2e-5,
                                   rtol=2e-5)
        _close(tcache[key], jcache[key])
    nxt = rng.randint(0, tm.cfg.vocab, (b, 1)).astype(np.int32)
    jcache["pos"] = jnp.full((b,), n, jnp.int32)
    jl, _ = jm.decode_step(jparams, jcache, jnp.asarray(nxt))
    tl, _ = tm.decode_step(tparams, tcache, torch.from_numpy(nxt))
    _close(tl, jl)


def test_params_from_jax_takes_the_moe_tree(moe_models):
    """The MoE tree converts with no transposes: every leaf equal, the
    expert stacks shaped (L, E, d_in, d_out) as in the reference."""
    _, jparams, tm, tparams = moe_models
    c = tm.cfg
    moe = tparams["layers"]["moe"]
    assert sorted(moe) == ["router", "w_down", "w_gate", "w_up"]
    assert "mlp" not in tparams["layers"]
    assert tuple(moe["w_up"].shape) == (c.n_layers, c.n_experts, c.d_model,
                                        c.d_ff)
    assert tuple(moe["w_down"].shape) == (c.n_layers, c.n_experts, c.d_ff,
                                          c.d_model)
    for key, leaf in moe.items():
        np.testing.assert_array_equal(
            leaf.numpy(), np.asarray(jparams["layers"]["moe"][key]))
    assert jax.tree.map(lambda x: tuple(x.shape), jparams) == \
        tm.param_shapes()
    bad = jax.tree.map(np.asarray, jparams)
    bad["layers"]["moe"]["w_up"] = bad["layers"]["moe"]["w_up"][..., :-1]
    with pytest.raises(ValueError):
        params_from_jax(bad, c, device="cpu")


def test_ring_cache_and_unported_families_raise():
    tm = build_model(get_config("h2o-danube-3-4b").reduced(), device="cpu")
    with pytest.raises(NotImplementedError):
        tm.init_cache(1, 16, ring=True)
    # enc-dec (whisper's n_encoder_layers > 0) is not ported yet
    encdec = dataclasses.replace(get_config("qwen3-32b").reduced(),
                                 n_encoder_layers=2)
    with pytest.raises(NotImplementedError):
        build_model(encdec, device="cpu")


def test_prefill_chunk_without_table_needs_a_contig_cache():
    """``prefill_chunk`` writes through ``block_tbl`` (engine-direct) or
    into a contiguous cache at one scalar base; a paged cache without the
    rows' table, or per-row bases on a contiguous cache, raise."""
    tm = build_model(get_config("qwen3-32b").reduced(), device="cpu")
    params = tm.init(seed=0)
    toks = torch.zeros((2, 4), dtype=torch.long)
    paged = tm.init_cache(2, 16, kv_layout="paged", block_size=8)
    with pytest.raises(ValueError):
        tm.prefill_chunk(params, paged, toks, 0)
    with pytest.raises(ValueError):
        tm.prefill_chunk(params, tm.init_cache(2, 16), toks,
                         torch.tensor([0, 4]))
