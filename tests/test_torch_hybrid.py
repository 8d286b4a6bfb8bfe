"""Hybrid parity: the port's zamba2 LM (Mamba2 trunk plus one shared
attention block over concat(x, x0) after every ``hybrid_period`` trunk
layers, each application with its own KV cache), plain PyTorch on the CPU,
against the JAX LM on params converted from the JAX init (fp32 2e-5), and
the attention plain versions at zamba2's head dim 80 against the JAX
oracles and the Pallas kernels in interpret mode (the CUDA attention
kernels gained that head dim for this path). The hybrid engine is held to
the JAX engine in tests/test_torch_ssm.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import attention as jattn
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import LM, build_model
from repro_torch.models.convert import params_from_jax

TOL = dict(atol=2e-5, rtol=2e-5)


def _close(t, j):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **TOL)


@functools.lru_cache(maxsize=None)
def _arch(name):
    """(JAX config, JAX params, port config, port params) of a reduced
    arch, the port's converted from the JAX init through numpy."""
    jcfg = jax_config(name).reduced()
    jparams = jax_build(jcfg, remat=False, attn_chunk=0).init(
        jax.random.PRNGKey(0))
    tcfg = get_config(name).reduced()
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def test_zamba2_lm_prefill_decode_match_jax():
    """Prefill logits, conv / ssd state and both applications' K/V, then a
    chain of decode steps writing and attending ``ak``/``av`` at per-row
    positions (SSD chunks of 4, so the 13-token prompt spans four)."""
    jcfg, jparams, tcfg, tparams = _arch("zamba2-2.7b")
    jm = jax_build(jcfg, remat=False, attn_chunk=0, ssd_chunk=4)
    tm = build_model(tcfg, device="cpu", ssd_chunk=4)
    rng = np.random.RandomState(11)
    toks = rng.randint(0, tcfg.vocab, (2, 13)).astype(np.int32)
    jl, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                            max_len=24, ring=False)
    tl, cache = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                           max_len=24)
    _close(tl, jl)
    for key in cache:
        _close(cache[key], jcache[key])
    jcache["pos"] = jnp.asarray(np.array([13, 13], np.int32))
    cache["pos"] = torch.tensor([13, 13], dtype=torch.int32)
    for _ in range(4):
        nxt = rng.randint(0, tcfg.vocab, (2, 1)).astype(np.int32)
        jl, jcache = jm.decode_step(jparams, jcache, jnp.asarray(nxt))
        tl, cache = tm.decode_step(tparams, cache, torch.from_numpy(nxt))
        _close(tl, jl)
        for key in cache:
            _close(cache[key], jcache[key])
    c = tm.cfg
    assert sorted(cache) == ["ak", "av", "conv", "pos", "ssd"]
    n_apps = len(c.shared_attn_positions())
    assert n_apps == 2
    assert tuple(cache["ak"].shape) == (n_apps, 2, 24, c.n_kv_heads, c.hd)
    # positions past the 13 + 4 written tokens stay zero
    assert torch.all(cache["ak"][:, :, 17:] == 0)


def test_shared_block_positions_match_the_reference():
    for name in ("zamba2-2.7b", "mamba2-1.3b"):
        for reduce in (False, True):
            tc, jc = get_config(name), jax_config(name)
            if reduce:
                tc, jc = tc.reduced(), jc.reduced()
            assert tc.shared_attn_positions() == jc.shared_attn_positions()
            assert (tc.d_inner, tc.ssm_heads) == (jc.d_inner, jc.ssm_heads)
    full = get_config("zamba2-2.7b")
    assert full.shared_attn_positions() == tuple(range(5, 54, 6))
    assert (full.hd, full.ssm_heads) == (80, 80)


def test_hybrid_param_tree_converts_unchanged():
    """The shared block's tree (attention reading 2*d_model) converts with
    no transposes, every leaf equal to the reference's."""
    _, jparams, tcfg, tparams = _arch("zamba2-2.7b")
    shared = tparams["shared"]
    assert sorted(shared) == ["attn", "ln_attn", "ln_mlp", "mlp"]
    assert tuple(shared["attn"]["wq"].shape) == (
        2 * tcfg.d_model, tcfg.n_heads * tcfg.hd)
    assert tuple(shared["ln_attn"]["w"].shape) == (2 * tcfg.d_model,)
    flat_t = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jparams["shared"]))
    for path, leaf in flat_t:
        node = shared
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), leaf)
    assert jax.tree.map(lambda x: tuple(x.shape), jparams) == \
        build_model(tcfg, device="cpu").param_shapes()


def test_hybrid_needs_whole_groups():
    cfg = dataclasses.replace(get_config("zamba2-2.7b").reduced(),
                              n_layers=5)
    with pytest.raises(ValueError):
        LM(cfg, device="cpu")


@pytest.mark.parametrize("s,window", [(128, None), (37, None), (64, 16)])
def test_flash_plain_at_head_dim_80(s, window):
    """Zamba2's prefill attention geometry (MHA, d=80), shrunk in heads."""
    rng = np.random.RandomState(s)
    q, k, v = (rng.randn(2, s, 4, 80).astype(np.float32) for _ in range(3))
    out = tfa.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=True, window=window)
    ref = jattn.prefill_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                  causal=True, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    if s % 128 == 0:            # the Pallas wrapper's block requirement
        pal = pallas_flash(*(jnp.asarray(a) for a in (q, k, v)),
                           causal=True, window=window, interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(pal), **TOL)


def test_contig_decode_plain_at_head_dim_80():
    """Zamba2's decode geometry (MHA, d=80) against a 256-row cache, with
    ragged per-row positions and one row at the cache end."""
    rng = np.random.RandomState(80)
    b, s = 3, 256
    q = rng.randn(b, 1, 4, 80).astype(np.float32)
    ck, cv = (rng.randn(b, s, 4, 80).astype(np.float32) for _ in range(2))
    pos = np.array([0, 100, s - 1], np.int32)
    out = tda.decode_attention_plain(
        *(torch.from_numpy(a) for a in (q, ck, cv, pos)))
    ref = jattn.decode_attention(*(jnp.asarray(a) for a in (q, ck, cv, pos)),
                                 None)
    pal = pallas_decode(*(jnp.asarray(a) for a in (q, ck, cv, pos)),
                        interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(pal), **TOL)
