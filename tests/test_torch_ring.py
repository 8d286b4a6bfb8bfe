"""The ring (sliding-window) KV cache of h2o-danube-3-4b's non-engine path:
the port against the JAX reference on JAX-initialised params converted
through numpy (reduced config: window 8).

``prefill(ring=True)`` with a prompt longer than the window (the
wrap-around reorder) and one shorter, then ``decode_step`` across the
ring's end: cache contents, ``slot_pos`` and logits (fp32, 2e-5), and the
same logits as the linear (``ring=False``) cache. The ring decode route
(``ops.decode_attention_ring``: the contiguous decode kernel's function at
``min(pos, S_alloc - 1)`` with no window) equals the reference's ring
``decode_attention`` under its ``slot_pos`` mask on a ring not yet full,
exactly full and wrapped.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax

TOL = dict(atol=2e-5, rtol=2e-5)
ARCH = "h2o-danube-3-4b"


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


@pytest.mark.parametrize("prompt", [5, 8, 20], ids=["short", "window",
                                                    "wrapped"])
def test_ring_prefill_and_decode_match_jax(prompt):
    """A prompt shorter than the window, exactly the window, and longer
    (wrapped by the prefill's reorder), then decode steps that wrap the
    ring: the ring's contents, ``slot_pos`` and logits equal the
    reference's, and the logits equal the linear cache's."""
    jm, jparams, tm, tparams = _arch()
    window = tm.cfg.swa_window
    rng = np.random.RandomState(prompt)
    b, max_len = 2, 40
    toks = rng.randint(0, tm.cfg.vocab, (b, prompt)).astype(np.int32)
    jl, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                            max_len=max_len, ring=True)
    tl, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                            max_len=max_len, ring=True)
    ll, lcache = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                            max_len=max_len)
    assert tcache["k"].shape[2] == window and "slot_pos" not in lcache
    _close(tl, jl)
    _close(tl, ll.numpy())
    for key in ("k", "v", "slot_pos"):
        _close(tcache[key], jcache[key])
    for _ in range(window + 3):
        nxt = rng.randint(0, tm.cfg.vocab, (b, 1)).astype(np.int32)
        jl, jcache = jm.decode_step(jparams, jcache, jnp.asarray(nxt))
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(nxt))
        ll, lcache = tm.decode_step(tparams, lcache, torch.from_numpy(nxt))
        _close(tl, jl)
        _close(tl, ll.numpy())
        for key in ("k", "v", "slot_pos"):
            _close(tcache[key], jcache[key])
    assert tcache["pos"].tolist() == [prompt + window + 3] * b


def test_ring_refuses_chunked_prefill():
    _, _, tm, tparams = _arch()
    _, ring = tm.prefill(tparams, {"tokens": torch.zeros((1, 4),
                                                         dtype=torch.long)},
                         max_len=16, ring=True)
    with pytest.raises(ValueError, match="ring"):
        tm.prefill_chunk(tparams, ring, torch.zeros((1, 2),
                                                    dtype=torch.long), 4)


def _slots(pos: int, s_alloc: int) -> np.ndarray:
    """``slot_pos`` after the token at ``pos`` was written: slot j holds
    the latest position p <= pos with p % s_alloc == j, or -1."""
    j = np.arange(s_alloc)
    return np.where(j <= pos, pos - (pos - j) % s_alloc, -1).astype(np.int32)


@pytest.mark.parametrize("pos", [3, 15, 16, 37],
                         ids=["not_full", "exactly_full", "wrapped",
                              "wrapped_twice"])
def test_ring_decode_route_matches_reference(pos):
    rng = np.random.RandomState(pos)
    b, s_alloc, nh, nkv, d = 2, 16, 4, 2, 16
    q = rng.randn(b, 1, nh, d).astype(np.float32)
    k = rng.randn(b, s_alloc, nkv, d).astype(np.float32)
    v = rng.randn(b, s_alloc, nkv, d).astype(np.float32)
    slot_pos = _slots(pos, s_alloc)
    ref = jax_attn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(pos, jnp.int32),
                                    jnp.asarray(slot_pos))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    pos_t = torch.full((b,), pos, dtype=torch.int32)
    _close(kops.decode_attention_ring(*t, pos_t), ref)
    _close(attn.decode_attention_ring(*t, pos_t, torch.from_numpy(slot_pos)),
           ref)
