"""Attention parity: the port's plain PyTorch attention (the CPU path and the
oracle of the CUDA kernels) against the JAX oracles in
``repro/models/attention.py`` and, for the five kernels (paged and
contiguous decode and chunk attention, flash prefill), against the Pallas
kernels run in interpret mode as tests/test_kernels.py runs them.

Inputs come from a numpy seed and go to both frameworks; tolerances are
those of tests/test_kernels.py (fp32 2e-5, bf16 2e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chunk_attention import chunk_attention as pallas_chunk
from repro.kernels.chunk_attention import \
    chunk_attention_paged as pallas_chunk_paged
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.decode_attention import \
    decode_attention_paged as pallas_decode_paged
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import attention as jattn
from repro_torch.kernels import chunk_attention as tca
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def _pair(a: np.ndarray, name: str):
    """The same values in both frameworks (bf16 rounding is identical)."""
    jd, td = DTYPES[name]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _close(t_out, j_out, name):
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out, np.float32), **_tol(name))


def _pool(rng, b, mb, block, nkv, d):
    """Random pool + per-row table of distinct blocks (0 = trash)."""
    n_blocks = 1 + b * mb
    pk = rng.randn(n_blocks, block, nkv, d).astype(np.float32)
    pv = rng.randn(n_blocks, block, nkv, d).astype(np.float32)
    tbl = (rng.permutation(b * mb).reshape(b, mb) + 1).astype(np.int32)
    return pk, pv, tbl


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,nh,nkv,d,window", [
    (2, 32, 4, 2, 16, None),        # GQA
    (1, 32, 4, 4, 16, 8),           # MHA, SWA
    (2, 24, 4, 1, 32, None),        # ragged length, d=32
])
def test_flash_attention_plain(dtype, b, s, nh, nkv, d, window):
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(b, s, n, d).astype(np.float32)
               for n in (nh, nkv, nkv))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    out = tfa.flash_attention_plain(tq, tk, tv, causal=True, window=window)
    _close(out, jattn.prefill_attention(jq, jk, jv, causal=True,
                                        window=window), dtype)
    _close(out, pallas_flash(jq, jk, jv, causal=True, window=window,
                             interpret=True), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,nh,nkv,d,window", [
    (2, 32, 4, 2, 16, 8),           # GQA, window shorter than the rows
    (1, 24, 4, 4, 32, 5),           # MHA, ragged length
])
def test_flash_attention_plain_noncausal_window(dtype, b, s, nh, nkv, d,
                                                window):
    """Without ``causal`` the Pallas kernel (and the CUDA kernel) still
    apply the window: query i sees keys j > i - window, later keys
    included. The plain version masks the same way."""
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(b, s, n, d).astype(np.float32)
               for n in (nh, nkv, nkv))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    out = tfa.flash_attention_plain(tq, tk, tv, causal=False, window=window)
    _close(out, pallas_flash(jq, jk, jv, causal=False, window=window,
                             interpret=True), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,nh,nkv,d,window,vecpos", [
    (2, 4, 2, 16, None, True),      # GQA, per-row positions
    (3, 4, 4, 16, 8, True),         # MHA, SWA
    (2, 8, 2, 32, None, False),     # scalar position
])
def test_decode_attention_paged_plain(dtype, b, nh, nkv, d, window, vecpos):
    rng = np.random.RandomState(1)
    block, mb = 8, 4
    pk, pv, tbl = _pool(rng, b, mb, block, nkv, d)
    q = rng.randn(b, 1, nh, d).astype(np.float32)
    pos = (rng.randint(1, block * mb, (b,)).astype(np.int32) if vecpos
           else np.int32(block * mb - 3))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, pk, pv))
    out = tda.decode_attention_paged_plain(tq, tk, tv, torch.from_numpy(tbl),
                                           torch.as_tensor(pos),
                                           window=window)
    jpos = jnp.asarray(pos)
    _close(out, jattn.decode_attention_paged(jq, jk, jv, jnp.asarray(tbl),
                                             jpos, window=window), dtype)
    _close(out, pallas_decode_paged(jq, jk, jv, jnp.asarray(tbl), jpos,
                                    window=window, interpret=True), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,c,nh,nkv,d,window,vecbase", [
    (2, 16, 4, 4, 16, None, False),  # MHA, scalar base
    (2, 16, 4, 2, 16, None, True),   # GQA, per-row bases
    (1, 12, 4, 2, 32, 8, False),     # SWA, ragged chunk
])
def test_chunk_attention_paged_plain(dtype, b, c, nh, nkv, d, window,
                                     vecbase):
    rng = np.random.RandomState(2)
    block, mb = 8, 4
    pk, pv, tbl = _pool(rng, b, mb, block, nkv, d)
    q = rng.randn(b, c, nh, d).astype(np.float32)
    s_virt = block * mb
    bases = (rng.randint(0, s_virt - c + 1, (b,)).astype(np.int32) if vecbase
             else np.int32(s_virt - c - 3))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, pk, pv))
    out = tca.chunk_attention_paged_plain(tq, tk, tv, torch.from_numpy(tbl),
                                          torch.as_tensor(bases),
                                          window=window)
    q_pos = (np.broadcast_to(bases, (b,))[:, None]
             + np.arange(c)[None]).astype(np.int32)
    _close(out, jattn.chunk_attention_paged(jq, jk, jv, jnp.asarray(tbl),
                                            jnp.asarray(q_pos),
                                            window=window), dtype)
    _close(out, pallas_chunk_paged(jq, jk, jv, jnp.asarray(tbl),
                                   jnp.asarray(bases), window=window,
                                   interpret=True), dtype)


@pytest.mark.parametrize("vecbase", [False, True])
def test_cache_writes_match_jax(vecbase):
    """Token and chunk writes through the block table land where the JAX
    writes land (trash block 0 excluded: pad columns race there), and the
    chunk write clamps columns past the table width like JAX."""
    rng = np.random.RandomState(3)
    b, c, nkv, d, block, mb = 2, 6, 2, 16, 8, 3
    pk, pv, tbl = _pool(rng, b, mb, block, nkv, d)
    k = rng.randn(b, c, nkv, d).astype(np.float32)
    v = rng.randn(b, c, nkv, d).astype(np.float32)
    base = (np.array([5, 19], np.int32) if vecbase else np.int32(17))
    lens = np.array([6, 4], np.int32)
    jk, jv = jattn.cache_write_chunk_paged(
        jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(base), jnp.asarray(tbl), lens=jnp.asarray(lens))
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    tattn.cache_write_chunk_paged(tk, tv, torch.from_numpy(k),
                                  torch.from_numpy(v), torch.as_tensor(base),
                                  torch.from_numpy(tbl),
                                  lens=torch.from_numpy(lens))
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(jv)[1:])
    pos = np.array([3, 23], np.int32)
    jk, jv = jattn.cache_write_token_paged(
        jk, jv, jnp.asarray(k[:, :1]), jnp.asarray(v[:, :1]),
        jnp.asarray(pos), jnp.asarray(tbl))
    tattn.cache_write_token_paged(tk, tv, torch.from_numpy(k[:, :1]),
                                  torch.from_numpy(v[:, :1]),
                                  torch.from_numpy(pos),
                                  torch.from_numpy(tbl))
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(jv)[1:])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,nh,nkv,d,window,vecpos", [
    (2, 32, 4, 2, 16, None, True),   # GQA, per-row positions
    (3, 32, 4, 4, 16, 8, True),      # MHA, SWA
    (2, 64, 8, 2, 32, None, False),  # scalar position
])
def test_decode_attention_plain(dtype, b, s, nh, nkv, d, window, vecpos):
    """Contiguous-cache decode: plain version == JAX oracle == Pallas
    kernel 4 (interpret mode; tiling shapes, S a multiple of its block)."""
    rng = np.random.RandomState(5)
    q = rng.randn(b, 1, nh, d).astype(np.float32)
    ck = rng.randn(b, s, nkv, d).astype(np.float32)
    cv = rng.randn(b, s, nkv, d).astype(np.float32)
    pos = (rng.randint(1, s, (b,)).astype(np.int32) if vecpos
           else np.int32(s - 3))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, ck, cv))
    out = tda.decode_attention_plain(tq, tk, tv, torch.as_tensor(pos),
                                     window=window)
    jpos = jnp.asarray(pos)
    _close(out, jattn.decode_attention(jq, jk, jv, jpos, None,
                                       window=window), dtype)
    _close(out, pallas_decode(jq, jk, jv, jpos, window=window,
                              interpret=True), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,c,s,nh,nkv,d,window,vecbase", [
    (2, 16, 32, 4, 4, 16, None, False),  # MHA, scalar base
    (2, 16, 64, 4, 2, 16, None, True),   # GQA, per-row bases
    (1, 16, 32, 4, 2, 32, 8, False),     # SWA
])
def test_chunk_attention_plain(dtype, b, c, s, nh, nkv, d, window, vecbase):
    """Contiguous-cache chunk attention: plain version == JAX oracle ==
    Pallas kernel 5 (interpret mode, tiling shapes)."""
    rng = np.random.RandomState(6)
    q = rng.randn(b, c, nh, d).astype(np.float32)
    ck = rng.randn(b, s, nkv, d).astype(np.float32)
    cv = rng.randn(b, s, nkv, d).astype(np.float32)
    bases = (rng.randint(0, s - c + 1, (b,)).astype(np.int32) if vecbase
             else np.int32(s - c - 3))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, ck, cv))
    out = tca.chunk_attention_plain(tq, tk, tv, torch.as_tensor(bases),
                                    window=window)
    q_pos = (np.broadcast_to(bases, (b,))[:, None]
             + np.arange(c)[None]).astype(np.int32)
    _close(out, jattn.chunk_attention(jq, jk, jv, jnp.asarray(q_pos),
                                      window=window), dtype)
    _close(out, pallas_chunk(jq, jk, jv, jnp.asarray(bases), window=window,
                             interpret=True), dtype)


@pytest.mark.parametrize("window", [None, 8])
def test_contig_plain_ragged_shapes_match_jax(window):
    """Shapes the Pallas kernels do not tile (S=37, C=13) and a frozen
    dead row past its row's end: the plain versions still match the JAX
    oracles, which is what the CUDA kernels are held to on the card."""
    rng = np.random.RandomState(7)
    b, s, c, nh, nkv, d = 3, 37, 13, 4, 2, 16
    ck = rng.randn(b, s, nkv, d).astype(np.float32)
    cv = rng.randn(b, s, nkv, d).astype(np.float32)
    q1 = rng.randn(b, 1, nh, d).astype(np.float32)
    pos = np.array([0, 20, s], np.int32)        # row 2: dead, past the end
    out = tda.decode_attention_plain(*(torch.from_numpy(x) for x in
                                       (q1, ck, cv, pos)), window=window)
    ref = jattn.decode_attention(*(jnp.asarray(x) for x in (q1, ck, cv, pos)),
                                 None, window=window)
    _close(out, ref, "float32")
    assert torch.isfinite(out).all()
    qc = rng.randn(b, c, nh, d).astype(np.float32)
    bases = np.array([0, 11, s - c], np.int32)
    out = tca.chunk_attention_plain(*(torch.from_numpy(x) for x in
                                      (qc, ck, cv, bases)), window=window)
    q_pos = bases[:, None] + np.arange(c)[None]
    ref = jattn.chunk_attention(*(jnp.asarray(x) for x in (qc, ck, cv)),
                                jnp.asarray(q_pos), window=window)
    _close(out, ref, "float32")


@pytest.mark.parametrize("vecpos", [False, True])
def test_contig_cache_writes_match_jax(vecpos):
    """Linear-cache token writes land where the JAX writes land, including
    the clamp of a position past the cache end to its last slot; chunk
    writes land at [base, base+C) and a chunk past the end raises."""
    rng = np.random.RandomState(8)
    b, s, c, nkv, d = 3, 16, 5, 2, 16
    ck = rng.randn(b, s, nkv, d).astype(np.float32)
    cv = rng.randn(b, s, nkv, d).astype(np.float32)
    k = rng.randn(b, c, nkv, d).astype(np.float32)
    v = rng.randn(b, c, nkv, d).astype(np.float32)
    pos = np.array([3, 15, 19], np.int32) if vecpos else np.int32(7)
    jk, jv, _ = jattn.cache_write_token(
        jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(k[:, :1]),
        jnp.asarray(v[:, :1]), jnp.asarray(pos), None)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tattn.cache_write_token(tk, tv, torch.from_numpy(k[:, :1]),
                            torch.from_numpy(v[:, :1]), torch.as_tensor(pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    tattn.cache_write_chunk(tk, tv, torch.from_numpy(k),
                            torch.from_numpy(v), 9)
    np.testing.assert_array_equal(tk.numpy()[:, 9:14], k)
    np.testing.assert_array_equal(tv.numpy()[:, 9:14], v)
    with pytest.raises(ValueError):
        tattn.cache_write_chunk(tk, tv, torch.from_numpy(k),
                                torch.from_numpy(v), s - c + 1)


def test_ops_dispatch_cpu_goes_plain_and_kernels_refuse_cpu():
    """A CPU tensor takes the plain version (no launch counted); a kernel
    wrapper handed a CPU tensor raises instead of falling back."""
    rng = np.random.RandomState(4)
    pk, pv, tbl = _pool(rng, 1, 2, 8, 2, 16)
    q = torch.from_numpy(rng.randn(1, 1, 4, 16).astype(np.float32))
    tk, tv, tt = (torch.from_numpy(x) for x in (pk, pv, tbl))
    tops.reset_launch_counts()
    out = tops.decode_attention_paged(q, tk, tv, tt, 5)
    ref = tda.decode_attention_paged_plain(q, tk, tv, tt, 5)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    ck = torch.from_numpy(rng.randn(1, 16, 2, 16).astype(np.float32))
    out = tops.decode_attention(q, ck, ck, 5)
    torch.testing.assert_close(
        out, tda.decode_attention_plain(q, ck, ck, 5), rtol=0, atol=0)
    out = tops.chunk_attention(q, ck, ck, 5)
    torch.testing.assert_close(
        out, tca.chunk_attention_plain(q, ck, ck, 5), rtol=0, atol=0)
    assert tops.launch_counts() == {"decode_attention_paged": 0,
                                    "decode_attention": 0,
                                    "chunk_attention_paged": 0,
                                    "chunk_attention": 0,
                                    "flash_attention": 0,
                                    "ssd_scan": 0,
                                    "kv_probe": 0}
    with pytest.raises(ValueError):
        tda.decode_attention_paged(q, tk, tv, tt, 5)
    with pytest.raises(ValueError):
        tda.decode_attention(q, ck, ck, 5)
    with pytest.raises(ValueError):
        tca.chunk_attention_paged(q, tk, tv, tt, 5)
    with pytest.raises(ValueError):
        tca.chunk_attention(q, ck, ck, 5)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q)
