"""MoE parity: the port's ``moe_apply`` (plain PyTorch on the CPU) against
the JAX reference ``repro/models/moe.py`` on JAX-initialised expert params
converted through numpy, on reduced granite-moe-3b-a800m (RMSNorm family,
tied embeddings) and phi3.5-moe-42b-a6.6b (LayerNorm family).

Outputs and the load-balancing aux loss (``moe_aux`` of the router
outputs ``moe_apply`` returns) must agree at fp32 2e-5; the token
choices must agree exactly, which three cases pin down: a batch whose
expert capacity drops pairs, exact router ties (the lower expert index
wins, as with ``jax.lax.top_k``), and the capacity rule itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import moe as tmoe

TOL = dict(atol=2e-5, rtol=2e-5)
ARCHS = ["granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b"]


@pytest.fixture(scope="module", params=ARCHS)
def layer(request):
    """Layer 0's expert params of the reduced config, as numpy."""
    jcfg = jax_config(request.param).reduced()
    jp = jax_build(jcfg, remat=False).init(jax.random.PRNGKey(0))
    p = {k: np.array(v[0]) for k, v in jp["layers"]["moe"].items()}
    return get_config(request.param).reduced(), p


def _both(cfg, p, x):
    jo, jaux = jmoe.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), cfg.moe_top_k, cfg.act,
                              cfg.gated_ffn)
    to, probs, idx = tmoe.moe_apply(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        cfg.moe_top_k, cfg.act, cfg.gated_ffn)
    return (to, tmoe.moe_aux(probs, idx)), (np.asarray(jo), np.asarray(jaux))


def _dropped_pairs(cfg, p, x) -> int:
    """Pairs past their expert's capacity, from the port's router."""
    t = x.shape[0] * x.shape[1]
    _, _, idx = tmoe.route({"router": torch.from_numpy(p["router"])},
                           torch.from_numpy(x.reshape(t, -1)),
                           cfg.moe_top_k)
    cap = tmoe._capacity(t, cfg.n_experts, cfg.moe_top_k, 1.25)
    loads = np.bincount(idx.reshape(-1).numpy(), minlength=cfg.n_experts)
    return int(np.maximum(loads - cap, 0).sum())


@pytest.mark.parametrize("b,s", [(1, 7), (3, 5), (8, 1)])
def test_moe_apply_matches_jax(layer, b, s):
    cfg, p = layer
    x = np.random.RandomState(b * 10 + s).randn(b, s, cfg.d_model).astype(
        np.float32)
    (to, taux), (jo, jaux) = _both(cfg, p, x)
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)


def test_capacity_drops_match_jax(layer):
    """Every token prefers the same two experts, so their capacity (4 of
    the 16 pairs at 8 tokens) overflows: the dropped pairs and the slot
    order of the kept ones must match the reference."""
    cfg, p = layer
    p = dict(p)
    router = p["router"].copy()
    router[:, 0] += 0.5
    router[:, 1] += 0.4
    p["router"] = router
    rng = np.random.RandomState(11)
    x = (1.0 + 0.1 * rng.randn(2, 4, cfg.d_model)).astype(np.float32)
    assert _dropped_pairs(cfg, p, x) > 0
    (to, taux), (jo, jaux) = _both(cfg, p, x)
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)


def test_router_ties_go_to_the_lower_expert(layer):
    """Duplicate router columns give exactly equal probabilities; the
    port must pick the lower index, as ``jax.lax.top_k`` does, or it routes
    to another expert and the outputs differ."""
    cfg, p = layer
    p = dict(p)
    router = p["router"].copy()
    e = cfg.n_experts
    router[:, e - 1] = router[:, 0]      # expert e-1 ties expert 0
    router[:, 0] += 0.3                  # ... and both lead the rest
    router[:, e - 1] += 0.3
    p["router"] = router
    x = (1.0 + 0.05 * np.random.RandomState(12).randn(
        1, 6, cfg.d_model)).astype(np.float32)
    _, _, idx = tmoe.route({"router": torch.from_numpy(router)},
                           torch.from_numpy(x.reshape(6, -1)), cfg.moe_top_k)
    _, jidx = jax.lax.top_k(jax.nn.softmax(
        (jnp.asarray(x.reshape(6, -1)) @ jnp.asarray(router)).astype(
            jnp.float32), axis=-1), cfg.moe_top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (idx[:, 0] == 0).all() and (idx[:, 1] == e - 1).all()
    (to, _), (jo, _) = _both(cfg, p, x)
    np.testing.assert_allclose(to.numpy(), jo, **TOL)


@pytest.mark.parametrize("t,e,k", [(8, 16, 2), (1, 8, 2), (2048, 16, 2),
                                   (40, 40, 8), (3, 8, 2)])
def test_capacity_rule_matches_jax(t, e, k):
    assert tmoe._capacity(t, e, k, 1.25) == jmoe._capacity(t, e, k, 1.25)
    # Phi-3.5-MoE decode at 8 rows: 4 slots per expert, so drops can happen
    assert tmoe._capacity(8, 16, 2, 1.25) == 4
