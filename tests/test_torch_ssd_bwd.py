"""The SSD scan's backward on the CPU: ``ssd_scan_bwd_plain`` (the plain
version the card's kernel is held to, a reverse walk over the chunks)
against ``jax.vjp`` of the JAX package's jnp ``ssd_chunked``
(``repro/models/ssm.py``) and against torch autograd through
``ssd_scan_plain``, in fp32: chunks of 8, 12 and 16 with S ragged and a
multiple of the chunk, with and without an initial state and a final
state gradient, at mamba2's and zamba2's head layouts cut to a reduced
width, with x, B and C slices of one tensor as the model makes them.

The same numpy inputs go to both packages. Each gradient (dx, ddt, da,
dB, dC, dh0) is held within 2e-5 of its reference's largest element: both
sum the same float32 products in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd

# (heads, head dim, state) of mamba2-1.3b (64 of 64, N 128) and
# zamba2-2.7b (80 of 64, N 64), cut to a reduced width
LAYOUTS = {"mamba2": (8, 16, 32), "zamba2": (10, 16, 16)}
# (chunk, S): ragged, then a multiple of the chunk
LENGTHS = [(8, 37), (8, 32), (12, 29), (12, 36), (16, 50), (16, 48)]
NAMES = ("dx", "ddt", "da", "db", "dc", "dh0")
TOL = 2e-5


def _inputs(seed, bsz, s, nh, hd, n, init, dhf):
    """x, dt, a, B, C (x, B and C slices of one conv output), h0, dy and
    dh_final as numpy arrays; h0 / dh_final None unless asked for."""
    rng = np.random.RandomState(seed)
    xbc = rng.randn(bsz, s, nh * hd + 2 * n).astype(np.float32) * 0.5
    dt = (np.abs(rng.randn(bsz, s, nh)) * 0.1 + 0.01).astype(np.float32)
    a = (-np.abs(rng.randn(nh)) - 0.1).astype(np.float32)
    h0 = (rng.randn(bsz, nh, hd, n) * 0.2).astype(np.float32) if init \
        else None
    dy = rng.randn(bsz, s, nh, hd).astype(np.float32)
    dh = rng.randn(bsz, nh, hd, n).astype(np.float32) if dhf else None
    return xbc, dt, a, h0, dy, dh


def _split(xbc, nh, hd, n):
    x = xbc[..., :nh * hd].reshape(*xbc.shape[:2], nh, hd)
    return x, xbc[..., nh * hd:nh * hd + n], xbc[..., nh * hd + n:]


def _jax_grads(xbc, dt, a, h0, dy, dh, nh, hd, n, chunk):
    x, bm, cm = _split(xbc, nh, hd, n)
    h0j = (jnp.zeros((x.shape[0], nh, hd, n), jnp.float32) if h0 is None
           else jnp.asarray(h0))
    (_, hf), vjp = jax.vjp(
        lambda *t: ssd_chunked(*t[:5], chunk=chunk, h0=t[5]),
        *(jnp.asarray(t) for t in (x, dt, a, bm, cm)), h0j)
    grads = vjp((jnp.asarray(dy),
                 jnp.zeros_like(hf) if dh is None else jnp.asarray(dh)))
    return [np.asarray(g) for g in grads]


def _torch(*arrays):
    return [None if t is None else torch.from_numpy(t) for t in arrays]


def _check(got, refs, names=NAMES):
    for name, g, r in zip(names, got, refs):
        r = np.asarray(r)
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape, name
        err = np.abs(g.detach().numpy() - r).max()
        assert err <= TOL * np.abs(r).max(), (name, err, np.abs(r).max())


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("chunk,s", LENGTHS)
@pytest.mark.parametrize("init,dhf", [(False, False), (True, True)])
def test_plain_backward_equals_jax_vjp(layout, chunk, s, init, dhf):
    nh, hd, n = LAYOUTS[layout]
    arrays = _inputs(chunk + s + nh, 2, s, nh, hd, n, init, dhf)
    refs = _jax_grads(*arrays, nh, hd, n, chunk)
    xbc, dt, a, h0, dy, dh = _torch(*arrays)
    x, bm, cm = _split(xbc, nh, hd, n)
    got = ssd.ssd_scan_bwd_plain(x, dt, a, bm, cm, chunk, h0, dy, dh)
    assert (got[5] is None) == (h0 is None)
    _check(got[:6] if init else got[:5], refs[:6] if init else refs[:5])


@pytest.mark.parametrize("chunk,s", [(12, 29), (16, 48)])
@pytest.mark.parametrize("init,dhf", [(True, False), (False, True)])
def test_plain_backward_state_gradients_one_sided(chunk, s, init, dhf):
    """An initial state without a final-state gradient, and the reverse."""
    nh, hd, n = LAYOUTS["mamba2"]
    arrays = _inputs(3 * chunk + s, 1, s, nh, hd, n, init, dhf)
    refs = _jax_grads(*arrays, nh, hd, n, chunk)
    xbc, dt, a, h0, dy, dh = _torch(*arrays)
    x, bm, cm = _split(xbc, nh, hd, n)
    got = ssd.ssd_scan_bwd_plain(x, dt, a, bm, cm, chunk, h0, dy, dh)
    k = 6 if init else 5
    _check(got[:k], refs[:k])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("chunk,s,init", [(8, 37, True), (12, 36, False)])
def test_plain_backward_equals_autograd(layout, chunk, s, init):
    """The same gradients as torch autograd through ``ssd_scan_plain``
    (through ``ops.ssd_scan``, which sends CPU tensors there), the model's
    one conv output the leaf that x, B and C are cut from."""
    nh, hd, n = LAYOUTS[layout]
    arrays = _inputs(5 * chunk + s, 2, s, nh, hd, n, init, True)
    xbc, dt, a, h0, dy, dh = _torch(*arrays)
    leaves = [t.clone().requires_grad_(True) for t in (xbc, dt, a)]
    h0l = None if h0 is None else h0.clone().requires_grad_(True)
    x, bm, cm = _split(leaves[0], nh, hd, n)
    y, hf = ops.ssd_scan(x, leaves[1], leaves[2], bm, cm, chunk=chunk,
                         h0=h0l)
    wrt = [x, leaves[1], leaves[2], bm, cm] + ([h0l] if init else [])
    refs = torch.autograd.grad((y, hf), wrt, (dy, dh))
    x, bm, cm = _split(xbc, nh, hd, n)
    got = ssd.ssd_scan_bwd_plain(x, dt, a, bm, cm, chunk, h0, dy, dh)
    _check(got[:len(wrt)], [r.numpy() for r in refs])


@pytest.mark.parametrize("chunk,s,init", [(8, 37, True), (12, 36, False)])
def test_chunk_states_are_the_prefix_scans_final_states(chunk, s, init):
    """``ssd_states_plain`` (the forward kernel's ``states`` output, the
    backward's input): chunk k starts from the final state of the scan
    over the first k chunks."""
    nh, hd, n = LAYOUTS["zamba2"]
    xbc, dt, a, h0, _, _ = _torch(*_inputs(s, 2, s, nh, hd, n, init, False))
    x, bm, cm = _split(xbc, nh, hd, n)
    states = ssd.ssd_states_plain(x, dt, a, bm, cm, chunk, h0)
    assert states.shape == (2, -(-s // chunk), nh, hd, n)
    zero = torch.zeros((2, nh, hd, n))
    torch.testing.assert_close(states[:, 0], zero if h0 is None else h0)
    for k in range(1, states.shape[1]):
        t = k * chunk
        _, h = ssd.ssd_scan_plain(x[:, :t], dt[:, :t], a, bm[:, :t],
                                  cm[:, :t], chunk=chunk, h0=h0)
        torch.testing.assert_close(states[:, k], h, rtol=0, atol=1e-6)


def test_plain_backward_returns_the_inputs_dtypes():
    """dx, dB and dC in the inputs' dtype, the rest in fp32."""
    nh, hd, n = LAYOUTS["zamba2"]
    xbc, dt, a, h0, dy, dh = _torch(*_inputs(9, 1, 20, nh, hd, n, True,
                                             True))
    x, bm, cm = _split(xbc.bfloat16(), nh, hd, n)
    got = ssd.ssd_scan_bwd_plain(x, dt, a, bm, cm, 8, h0, dy.bfloat16(), dh)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.float32]


def _cpu_args():
    nh, hd, n = LAYOUTS["mamba2"]
    xbc, dt, a, _, dy, _ = _torch(*_inputs(4, 1, 16, nh, hd, n, False,
                                           False))
    x, bm, cm = _split(xbc, nh, hd, n)
    return x, dt, a, bm, cm, dy


def test_backward_kernel_refuses_cpu_tensors():
    x, dt, a, bm, cm, dy = _cpu_args()
    states = torch.zeros((1, 2, *x.shape[2:], bm.shape[-1]))
    with pytest.raises(ValueError, match="CUDA device"):
        ssd.ssd_scan_bwd(x, dt, a, bm, cm, 8, states, dy)


def test_autograd_function_refuses_cpu_tensors():
    x, dt, a, bm, cm, _ = _cpu_args()
    with pytest.raises(ValueError, match="CUDA device"):
        ssd.SsdScanFn.apply(x.requires_grad_(True), dt, a, bm, cm, 8, None)
