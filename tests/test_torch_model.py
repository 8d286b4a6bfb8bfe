"""Model parity: the port's dense LM (plain PyTorch on the CPU) against the
JAX reference LM on JAX-initialised params converted through numpy.

``prefill`` into a paged cache, engine-direct ``prefill_chunk`` (per-row
table snapshots, ``lens`` masking) and ``decode_step`` must give the same
logits and the same pool contents at written positions (fp32, 2e-5), on
reduced qwen3-32b (GQA), qwen2-0.5b (qkv bias, tied embeddings) and
h2o-danube-3-4b (sliding window).
"""

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
