"""M-RoPE and the stubbed vision frontend (qwen2-vl-2b): the port against
the JAX reference on JAX-initialised params converted through numpy.

``apply_m_rope`` on distinct (temporal, height, width) streams and on
identical ones, where it equals ``apply_rope``; ``LM.prefill`` from patch
embeddings with an image grid's three position streams (2 x 4 x 4
patches, then text), and embeds ``decode_step``: logits and cache contents
(fp32, 2e-5). The VLM engine (paged, from tokens, its streams identical)
gives the reference engine's greedy tokens and every ``EngineStats``
field.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models.common import apply_m_rope as jax_m_rope
from repro.serving import Engine as JaxEngine
from repro.serving import ServeRequest as JaxRequest
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.common import apply_m_rope, apply_rope
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import Engine, ServeRequest

TOL = dict(atol=2e-5, rtol=2e-5)
ARCH = "qwen2-vl-2b"


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


@functools.lru_cache(maxsize=None)
def _arch():
    jcfg = jax_config(ARCH).reduced()
    jm = jax_build(jcfg, remat=False, attn_chunk=0)
    jparams = jm.init(jax.random.PRNGKey(0))
    tcfg = get_config(ARCH).reduced()
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jm, jparams, build_model(tcfg, device="cpu"), tparams


def image_grid_positions(b: int, t: int, h: int, w: int, n_text: int
                         ) -> np.ndarray:
    """(3, B, S) M-RoPE streams of a ``t x h x w`` patch grid followed by
    ``n_text`` text tokens: patch (i, j, k) at (temporal i, height j, width
    k); text continues from one past the grid's largest index in all three
    streams, as Qwen2-VL numbers them."""
    ti, hi, wi = np.meshgrid(np.arange(t), np.arange(h), np.arange(w),
                             indexing="ij")
    grid = np.stack([ti.ravel(), hi.ravel(), wi.ravel()])       # (3, thw)
    text = grid.max() + 1 + np.arange(n_text)
    pos = np.concatenate([grid, np.broadcast_to(text, (3, n_text))], axis=1)
    return np.ascontiguousarray(
        np.broadcast_to(pos[:, None], (3, b, pos.shape[1]))).astype(np.int32)


@pytest.mark.parametrize("streams", ["distinct", "identical"])
def test_apply_m_rope_matches_jax(streams):
    rng = np.random.RandomState(0)
    b, s, n, d = 2, 40, 3, 16
    x = rng.randn(b, s, n, d).astype(np.float32)
    if streams == "distinct":
        pos = image_grid_positions(b, 2, 4, 4, 8)
        assert len({tuple(p.ravel()) for p in pos}) == 3
    else:
        one = rng.randint(0, 500, (b, s)).astype(np.int32)
        pos = np.stack([one] * 3)
    sections = (4, 2, 2)
    out = apply_m_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                       sections)
    _close(out, jax_m_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections))
    if streams == "identical":
        _close(out, apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]),
                               1e6).numpy())
    with pytest.raises(ValueError):
        apply_m_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                     (4, 2, 1))


def test_embeds_prefill_and_decode_match_jax():
    """Patch embeddings + a 2 x 4 x 4 image grid's distinct streams, then
    text: prefill logits and the contiguous cache, then embeds decode steps
    (the decode position broadcast to all three streams)."""
    jm, jparams, tm, tparams = _arch()
    rng = np.random.RandomState(1)
    b, d = 2, tm.cfg.d_model
    pos = image_grid_positions(b, 2, 4, 4, 8)
    s = pos.shape[-1]
    emb = rng.randn(b, s, d).astype(np.float32)
    jl, jcache = jm.prefill(jparams, {"embeds": jnp.asarray(emb),
                                      "positions": jnp.asarray(pos)},
                            max_len=48, ring=False)
    tl, tcache = tm.prefill(tparams, {"embeds": torch.from_numpy(emb),
                                      "positions": torch.from_numpy(pos)},
                            max_len=48)
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])
    # the streams matter: the first stream alone rotates the patches' keys
    # otherwise (the text's, identical in every stream, agree)
    flat = torch.from_numpy(np.stack([pos[0]] * 3))
    _, other = tm.prefill(tparams, {"embeds": torch.from_numpy(emb),
                                    "positions": flat}, max_len=48)
    assert not np.allclose(other["k"][:, :, :32].numpy(),
                           np.asarray(jcache["k"][:, :, :32]), **TOL)
    _close(other["k"][:, :, 32:s], jcache["k"][:, :, 32:s])
    jcache = dict(jcache, pos=jnp.full((b,), s, jnp.int32))
    for _ in range(3):
        e = rng.randn(b, 1, d).astype(np.float32)
        jl, jcache = jm.decode_step(jparams, jcache, jnp.asarray(e))
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(e))
        _close(tl, jl)
        for key in ("k", "v"):
            _close(tcache[key], jcache[key])


def test_token_prefill_paged_matches_jax():
    """From tokens (the engine's way) into a paged cache: the default
    positions are three identical streams."""
    jm, jparams, tm, tparams = _arch()
    toks = np.random.RandomState(2).randint(0, tm.cfg.vocab, (2, 13)
                                            ).astype(np.int32)
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
    _close(tcache["k"][:, 1:], jcache["k"][:, 1:])
    nxt = np.array([[5], [7]], np.int32)
    jl, _ = jm.decode_step(jparams, jcache, jnp.asarray(nxt))
    tl, _ = tm.decode_step(tparams, tcache, torch.from_numpy(nxt))
    _close(tl, jl)


def _batched(eng, Req):
    rs = [Req(prompt=list(range(1, 4 + 3 * i)), max_new_tokens=4 + i)
          for i in range(5)]
    assert len(eng.admit_many(rs)) == 5
    eng.drain()
    return rs


def _chunked(eng, Req):
    live = Req(prompt=[3, 1, 4], max_new_tokens=10)
    eng.admit(live)
    longs = [Req(prompt=list(range(1 + i, 30 + 3 * i)), max_new_tokens=4 + i)
             for i in range(3)]
    eng.admit_many(longs)
    eng.drain()
    return [live] + longs


@pytest.mark.parametrize("scenario,kw", [
    (_batched, dict(max_batch=8, max_len=64)),
    (_chunked, dict(max_batch=4, max_len=64, prefill_chunk=8,
                    block_size=8))], ids=["batched", "chunked"])
def test_vlm_engine_matches_jax(scenario, kw):
    jm, jparams, tm, tparams = _arch()
    je = JaxEngine(jm.cfg, jparams, use_pallas=False, victim_policy="fewest",
                   **kw)
    te = Engine(tm.cfg, tparams, device="cpu", victim_policy="fewest", **kw)
    jreqs = scenario(je, JaxRequest)
    treqs = scenario(te, ServeRequest)
    assert [list(r.generated) for r in treqs] == \
        [list(r.generated) for r in jreqs]
    assert all(r.done for r in treqs)
    assert dataclasses.asdict(te.stats) == dataclasses.asdict(je.stats)
    assert te.kv_layout == je.kv_layout == "paged"
