"""The flash backward's yardstick on the CPU: ``flash_attention_bwd_plain``
(the plain version the card's kernel is held to) against ``jax.grad`` of
the JAX package's jnp ``prefill_attention`` (``repro/models/attention.py``),
in fp32, at the shapes where the Hopper body's tiles end: Sq = Sk of 129
and 257 (one past a 128-key tile and past two 64-query steps), causal,
with and without a sliding window, g = 6 at head dim 120 and g = 2 at 128.

The same numpy inputs go to both packages. Each gradient element is held
within 2e-5 (absolute) of its reference, whose largest elements are 3-10:
both sum the same products in float32, in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import prefill_attention
from repro_torch.kernels import flash_attention as fa


def _inputs(seed, s, nh, nkv, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, s, h, d).astype(np.float32)
            for h in (nh, nkv, nkv, nh)]


@pytest.mark.parametrize("s", [129, 257])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("nh,nkv,d", [(12, 2, 120), (4, 2, 128)])
def test_plain_backward_equals_jax_grad(s, window, nh, nkv, d):
    q, k, v, dout = _inputs(s + nh + d, s, nh, nkv, d)

    def loss(q, k, v):
        out = prefill_attention(q, k, v, causal=True, window=window)
        return jnp.sum(out * dout)

    refs = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                               for x in (q, k, v)))
    got = fa.flash_attention_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v, dout)), causal=True,
        window=window)
    for name, g, r in zip("qkv", got, refs):
        r = np.asarray(r)
        assert g.dtype == torch.float32 and g.shape == r.shape
        err = np.abs(g.numpy() - r).max()
        assert err <= 2e-5, (f"d{name}", err)
