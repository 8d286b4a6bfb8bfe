"""The port's nine CUDA kernels against their plain PyTorch versions, on
the card, and the engine and the global server on the card against the
same on the CPU. The contiguous decode kernel on an fp8 cache is also
held, bit for bit, to itself on the cache upcast to q's dtype.

Marked ``gpu``: each test asks for the ``cuda`` fixture, which skips when
there is no card (the check runs inside the fixture, never at import, so
every pytest-xdist worker collects the same tests). On a machine with an
H100 run them with ``PYTHONPATH=src python -m pytest -m gpu --noconftest
tests/test_torch_kernels_gpu.py`` (this file imports no JAX; the suite's
conftest does). Each kernel is held against its plain version evaluated in
fp32 on the same input values (``_ref``): bf16 atol 5e-3 and rtol 2e-2 (the
kernel rounds P and the output to bf16; the bf16 plain version rounds the
normalised probabilities too and is itself up to ~2e-2 off in rows of a few
keys), fp32 1e-4 (the kernels sum in another order than the plain
versions' einsums). The SSD scan's ``y`` and final state are held the same
way (it rounds y to bf16 once; it sums in another order). The flash
backward is held to the plain gradient in fp32 (``_check_bwd``): fp32
within 1e-4 of each gradient's largest element, bf16 within 3x the bf16
plain version's own error (the kernel rounds P and dS to bf16 as mma
operands, the plain version rounds far more: scores, probabilities and
every product in bf16). The bf16 backward's dQ is reduce-added in fp32 in
no fixed order, so two calls may differ in its last bf16 place; dK / dV
are bitwise repeatable. The SSD scan's backward is held to its plain
version (``ssd_scan_bwd_plain``) in fp32: every gradient within 1e-4 of
its largest element (another summation order), a bf16 dx / dB / dC also
within one bf16 rounding; it sums in a fixed order, so it repeats bit for
bit. Its bf16 cases under the forward's route rule take the tensor-core
body, fp32 and the rest the CUDA-core one (``ssd.bwd_plan``).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import chunk_attention as ca
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kv_probe as kvp
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import attention as attn
from repro_torch.models.common import astype
from repro_torch.serving.kv_blocks import KV_POISON

pytestmark = pytest.mark.gpu
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _tol(dtype):
    if dtype == torch.bfloat16:
        return dict(atol=5e-3, rtol=2e-2)
    return dict(atol=1e-4, rtol=1e-4)


def _ref(plain, *args, **kw):
    """``plain`` evaluated in fp32 on the same input values."""
    return plain(*(a.float() if torch.is_tensor(a) and a.is_floating_point()
                   else a for a in args), **kw)


def _rand(rng, shape, dtype, dev):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        dev, dtype)


def _pool(rng, b, mb, bs, nkv, d, dtype, dev):
    pk = _rand(rng, (1 + b * mb, bs, nkv, d), dtype, dev)
    pv = _rand(rng, (1 + b * mb, bs, nkv, d), dtype, dev)
    tbl = torch.from_numpy((rng.permutation(b * mb).reshape(b, mb) + 1
                            ).astype(np.int32)).to(dev)
    return pk, pv, tbl


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nh,nkv,d,window", [(8, 2, 16, None),
                                             (4, 4, 32, 8),
                                             (16, 2, 128, None)])
def test_decode_kernel_matches_plain(cuda, dtype, nh, nkv, d, window):
    rng = np.random.RandomState(0)
    b, mb, bs = 3, 5, 16
    pk, pv, tbl = _pool(rng, b, mb, bs, nkv, d, dtype, cuda)
    tbl[2] = 0                                  # dead row on the trash block
    q = _rand(rng, (b, 1, nh, d), dtype, cuda)
    pos = torch.tensor([0, 37, 79], dtype=torch.int32, device=cuda)
    n0 = da.launch_counts["decode_attention_paged"]
    out = ops.decode_attention_paged(q, pk, pv, tbl, pos, window=window)
    assert da.launch_counts["decode_attention_paged"] == n0 + 1
    ref = _ref(da.decode_attention_paged_plain, q, pk, pv, tbl, pos,
               window=window)
    torch.testing.assert_close(out.float(), ref, **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,vecbase,window", [(16, False, None),
                                              (13, True, None),
                                              (40, True, 8)])
def test_chunk_kernel_matches_plain(cuda, dtype, c, vecbase, window):
    rng = np.random.RandomState(1)
    b, nh, nkv, d, mb, bs = 2, 8, 2, 64, 6, 16
    pk, pv, tbl = _pool(rng, b, mb, bs, nkv, d, dtype, cuda)
    q = _rand(rng, (b, c, nh, d), dtype, cuda)
    bases = (torch.tensor([0, 50], dtype=torch.int32, device=cuda)
             if vecbase else 30)
    out = ops.chunk_attention_paged(q, pk, pv, tbl, bases, window=window)
    ref = _ref(ca.chunk_attention_paged_plain, q, pk, pv, tbl, bases,
               window=window)
    torch.testing.assert_close(out.float(), ref, **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bs", [16, 24])
@pytest.mark.parametrize("g,d", [(8, 128), (12, 128), (8, 80), (12, 80)])
def test_chunk_kernel_unaligned_row_bases(cuda, dtype, bs, g, d):
    """The prefix-sharing suffix dispatch: per-row bases that differ in
    one call and are multiples of neither the block nor the query tile
    (the causal diagonal crosses key tiles), one row at base 0; and the
    same call with the probe over ragged real columns."""
    rng = np.random.RandomState(7)
    b, nkv, c, mb = 4, 2, 100, -(-1200 // bs)
    pk, pv, tbl = _pool(rng, b, mb, bs, nkv, d, dtype, cuda)
    q = _rand(rng, (b, c, g * nkv, d), dtype, cuda)
    bases = torch.tensor([0, 17, 1000, 1023], dtype=torch.int32,
                         device=cuda)
    out = ops.chunk_attention_paged(q, pk, pv, tbl, bases)
    ref = _ref(ca.chunk_attention_paged_plain, q, pk, pv, tbl, bases)
    torch.testing.assert_close(out.float(), ref, **_tol(dtype))
    cols = torch.tensor([c, 33, 1, c - 7], dtype=torch.int32, device=cuda)
    out_p, pmax = ops.chunk_attention_paged(q, pk, pv, tbl, bases,
                                            probe=True, probe_cols=cols)
    torch.testing.assert_close(out_p, out, atol=0, rtol=0)
    assert torch.equal(pmax, kvp.kv_probe_plain(pk, pv, tbl, bases, c,
                                                g * nkv, cols=cols))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,nh,nkv,d,causal,window", [
    (2, 64, 8, 2, 32, True, None),
    (2, 77, 8, 2, 32, True, 16),
    (2, 50, 8, 2, 32, False, None),
    (1, 1281, 32, 8, 128, True, None),      # a MoE batch-1 exact-length prompt
    (2, 77, 4, 4, 80, True, None),          # zamba2's head dim, ragged S
    (1, 300, 32, 32, 80, True, None),       # zamba2's heads
])
def test_flash_kernel_matches_plain(cuda, dtype, b, s, nh, nkv, d, causal,
                                    window):
    rng = np.random.RandomState(2)
    q = _rand(rng, (b, s, nh, d), dtype, cuda)
    k = _rand(rng, (b, s, nkv, d), dtype, cuda)
    v = _rand(rng, (b, s, nkv, d), dtype, cuda)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    ref = _ref(fa.flash_attention_plain, q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref, **_tol(dtype))


@pytest.mark.parametrize("kind", ["flash", "paged", "contig"])
@pytest.mark.parametrize("nh,nkv,d,c,s,bs,window", [
    (16, 2, 128, 13, 1100, 16, None),       # g=8: 16 queries per CTA
    (16, 2, 128, 300, 1100, 16, None),      # C not a multiple of 16
    (16, 2, 64, 511, 1100, 16, None),       # keys wrap the ring, end mid tile
    (16, 2, 64, 200, 700, 24, None),        # pool blocks straddle key tiles
    (16, 2, 128, 300, 900, 16, 40),         # SWA shorter than a key tile
    (8, 2, 32, 77, 400, 16, None),          # g=4
    (4, 4, 80, 150, 500, 16, None),         # g=1, zamba2's head dim
    (4, 1, 16, 45, 300, 8, 20),             # g=4, d=16, SWA
])
def test_bf16_prefill_tiling_edges(cuda, kind, nh, nkv, d, c, s, bs,
                                   window):
    """The bf16 prefill body (flash, paged and contig chunk) at the edges
    of its tiling: 128 packed rows of 128 / g query positions, key tiles of
    128 in a ring, a row at base 0 (its chunk sees no earlier key)."""
    rng = np.random.RandomState(6)
    dt, b = torch.bfloat16, 2
    q = _rand(rng, (b, c, nh, d), dt, cuda)
    if kind == "flash":
        k, v = (_rand(rng, (b, c, nkv, d), dt, cuda) for _ in range(2))
        out = ops.flash_attention(q, k, v, causal=True, window=window)
        ref = _ref(fa.flash_attention_plain, q, k, v, causal=True,
                   window=window)
    else:
        mb = -(-s // bs)
        bases = torch.tensor([0, mb * bs - c], dtype=torch.int32,
                             device=cuda)
        if kind == "paged":
            pk, pv, tbl = _pool(rng, b, mb, bs, nkv, d, dt, cuda)
            out = ops.chunk_attention_paged(q, pk, pv, tbl, bases,
                                            window=window)
            ref = _ref(ca.chunk_attention_paged_plain, q, pk, pv, tbl, bases,
                       window=window)
        else:
            ck, cv = (_rand(rng, (b, s, nkv, d), dt, cuda) for _ in range(2))
            bases[1] = s - c
            out = ops.chunk_attention(q, ck, cv, bases, window=window)
            ref = _ref(ca.chunk_attention_plain, q, ck, cv, bases,
                       window=window)
    torch.testing.assert_close(out.float(), ref, **_tol(dt))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,nh,nkv,d,window", [(37, 8, 2, 16, None),
                                               (40, 4, 4, 32, 8),
                                               (2080, 32, 8, 128, None),
                                               (2080, 64, 8, 128, None),
                                               (37, 4, 4, 80, None),
                                               (2080, 32, 32, 80, None)])
def test_contig_decode_kernel_matches_plain(cuda, dtype, s, nh, nkv, d,
                                            window):
    """Kernel 4: ragged S, SWA, and a dead row frozen past its row's end."""
    rng = np.random.RandomState(3)
    b = 3
    ck = _rand(rng, (b, s, nkv, d), dtype, cuda)
    cv = _rand(rng, (b, s, nkv, d), dtype, cuda)
    q = _rand(rng, (b, 1, nh, d), dtype, cuda)
    pos = torch.tensor([0, s // 2, s], dtype=torch.int32, device=cuda)
    n0 = da.launch_counts["decode_attention"]
    out = ops.decode_attention(q, ck, cv, pos, window=window)
    assert da.launch_counts["decode_attention"] == n0 + 1
    ref = _ref(da.decode_attention_plain, q, ck, cv, pos, window=window)
    torch.testing.assert_close(out.float(), ref, **_tol(dtype))
    out = ops.decode_attention(q, ck, cv, s - 3, window=window)  # scalar
    ref = _ref(da.decode_attention_plain, q, ck, cv, s - 3, window=window)
    torch.testing.assert_close(out.float(), ref, **_tol(dtype))


@pytest.mark.parametrize("fmt", [None, "float8_e4m3fn", "float8_e5m2"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nh,nkv,d,window", [(12, 2, 128, None),
                                             (6, 6, 64, None),
                                             (8, 8, 80, 40),
                                             (32, 8, 120, None)])
def test_contig_decode_lse_output_matches_plain(cuda, dtype, nh, nkv, d,
                                                window, fmt):
    """Kernel 4 with ``lse=``: the fp32 output and the natural log-sum-exp
    equal the plain version's at local positions before a slice (-inf, 0),
    inside, at and past its end; without ``lse`` the output is the same
    call's rounded to q's dtype, bit for bit."""
    rng = np.random.RandomState(11)
    b, s = 6, 520
    ck = _rand(rng, (b, s, nkv, d), dtype, cuda)
    cv = _rand(rng, (b, s, nkv, d), dtype, cuda)
    if fmt:
        from repro_torch.models.common import FP8_DTYPES
        ck, cv = astype(ck, FP8_DTYPES[fmt]), astype(cv, FP8_DTYPES[fmt])
    q = _rand(rng, (b, 1, nh, d), dtype, cuda)
    pos = torch.tensor([-300, -1, 0, 200, s - 1, s + 700], dtype=torch.int32,
                       device=cuda)
    lse = torch.empty((b, nh), dtype=torch.float32, device=cuda)
    out, got = ops.decode_attention(q, ck, cv, pos, window=window, lse=lse)
    assert got is lse and out.dtype == torch.float32
    ref_lse = torch.empty((b, nh), dtype=torch.float32)
    ref, _ = _ref(da.decode_attention_plain, q.cpu(), ck.cpu(), cv.cpu(),
                  pos.cpu(), window=window, lse=ref_lse)
    dead = torch.isneginf(ref_lse)
    assert torch.equal(torch.isneginf(lse.cpu()), dead)
    assert dead[:2].all() and not dead[2:].any()
    tol = _tol(dtype)
    scale = max(cv.float().abs().max().item(), 1.0)
    torch.testing.assert_close(out.cpu() / scale, ref / scale, **tol)
    torch.testing.assert_close(torch.where(dead, 0, lse.cpu()),
                               torch.where(dead, 0, ref_lse), **tol)
    bare = ops.decode_attention(q, ck, cv, pos, window=window)
    assert torch.equal(bare, out.to(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_contig_decode_lse_slices_merge_to_the_whole_cache(cuda, dtype):
    """A (8, 2080, 2, 128) cache cut into 4 sequence slices, each read at
    its local position with ``lse=``, merged by ``merge_partials``: the
    kernel on the whole cache (fp32 2e-5, bf16 2e-2 of max |out|)."""
    rng = np.random.RandomState(12)
    b, s, nh, nkv, d = 8, 2080, 12, 2, 128
    w = s // 4
    ck = _rand(rng, (b, s, nkv, d), dtype, cuda)
    cv = _rand(rng, (b, s, nkv, d), dtype, cuda)
    q = _rand(rng, (b, 1, nh, d), dtype, cuda)
    pos = torch.tensor([3, w - 1, w, 2 * w + 7, 3 * w - 1, s - 1, s + 5,
                        s // 2], dtype=torch.int32, device=cuda)
    whole = ops.decode_attention(q, ck, cv, pos).float()
    parts, lses = [], []
    for r in range(4):
        lse = torch.empty((b, nh), dtype=torch.float32, device=cuda)
        o, _ = ops.decode_attention(q, ck[:, r * w:(r + 1) * w].contiguous(),
                                    cv[:, r * w:(r + 1) * w].contiguous(),
                                    pos - r * w, lse=lse)
        parts.append(o)
        lses.append(lse)
    merged = attn.merge_partials(torch.stack(parts), torch.stack(lses))
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    err = (merged.to(dtype).float() - whole).abs().max().item()
    assert err <= tol * whole.abs().max().item(), err


@pytest.mark.parametrize("nh,nkv,d,b,s,window,pos", [
    # split edges at 2080 keys, 8 rows (64-key splits for short rows,
    # 192-key splits at 1535 / 1536), the row's end and the dead row
    (32, 8, 128, 8, 2080, None, [0, 63, 64, 65, 1535, 1536, 2079, 2080]),
    (32, 8, 128, 8, 2080, 20, [0, 63, 64, 65, 1535, 1536, 2079, 2080]),
    (32, 8, 128, 8, 2080, 300, [0, 63, 64, 65, 1535, 1536, 2079, 2080]),
    (64, 8, 128, 1, 1000, None, [999]),         # B = 1, S % 64 != 0
    (8, 8, 16, 3, 300, None, [0, 150, 299]),    # g = 1, d = 16
    (16, 4, 32, 3, 300, 40, [5, 150, 300]),     # g = 4, d = 32, SWA
    (16, 2, 64, 3, 1000, None, [0, 640, 1000]),  # g = 8, d = 64
    (32, 32, 80, 4, 700, None, [0, 64, 699, 700]),  # g = 1, d = 80
    (8, 2, 80, 3, 300, None, [1, 128, 300]),    # g = 4, d = 80
    (32, 2, 64, 3, 500, None, [10, 255, 500]),  # g = 16 (one m16 tile)
    (32, 1, 16, 3, 200, None, [10, 100, 200]),  # g = 32: FP32-pipe body
])
def test_contig_decode_bf16_body_edges(cuda, nh, nkv, d, b, s, window, pos):
    """Kernel 4's bf16 tensor-core body: splits sized from the positions,
    their edges, windows shorter than a tile and across splits, every head
    dim, g = 1 / 4 / 8 / 16, the frozen dead row (pos = S)."""
    rng = np.random.RandomState(7)
    dt = torch.bfloat16
    ck = _rand(rng, (b, s, nkv, d), dt, cuda)
    cv = _rand(rng, (b, s, nkv, d), dt, cuda)
    q = _rand(rng, (b, 1, nh, d), dt, cuda)
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    out = ops.decode_attention(q, ck, cv, pos, window=window)
    ref = _ref(da.decode_attention_plain, q, ck, cv, pos, window=window)
    torch.testing.assert_close(out.float(), ref, **_tol(dt))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,s,vecbase,window", [(16, 64, False, None),
                                                (13, 37, True, None),
                                                (40, 100, True, 8)])
def test_contig_chunk_kernel_matches_plain(cuda, dtype, c, s, vecbase,
                                           window):
    """Kernel 5: any C and S, scalar or per-row bases, SWA."""
    rng = np.random.RandomState(4)
    b, nh, nkv, d = 2, 8, 2, 64
    ck = _rand(rng, (b, s, nkv, d), dtype, cuda)
    cv = _rand(rng, (b, s, nkv, d), dtype, cuda)
    q = _rand(rng, (b, c, nh, d), dtype, cuda)
    bases = (torch.tensor([0, s - c], dtype=torch.int32, device=cuda)
             if vecbase else (s - c) // 2)
    n0 = ca.launch_counts["chunk_attention"]
    out = ops.chunk_attention(q, ck, cv, bases, window=window)
    assert ca.launch_counts["chunk_attention"] == n0 + 1
    ref = _ref(ca.chunk_attention_plain, q, ck, cv, bases, window=window)
    torch.testing.assert_close(out.float(), ref, **_tol(dtype))


@pytest.mark.parametrize("nh,nkv,d,b,s,bs,window,pos", [
    # block (15 / 16), tile (63 / 64 / 65) and split (1535 / 1536) edges,
    # the row's last key and one past it (the last row: dead, on the trash
    # table)
    (32, 8, 128, 10, 2080, 16, None,
     [0, 15, 16, 63, 64, 65, 1535, 1536, 2079, 2080]),
    (32, 8, 128, 9, 2088, 24, None,             # blocks of 24 straddle tiles
     [0, 23, 24, 63, 64, 1535, 1536, 2087, 2088]),
    (32, 8, 128, 4, 2080, 16, 8, [7, 16, 1536, 2080]),    # SWA < a block
    (32, 8, 128, 4, 2088, 24, 20, [23, 47, 1000, 2088]),
    (32, 8, 128, 4, 2080, 16, 300, [299, 1535, 2079, 2080]),  # across splits
    (64, 8, 128, 1, 1008, 16, None, [999]),     # B = 1
    (8, 8, 16, 3, 304, 16, None, [0, 150, 304]),          # g = 1, d = 16
    (12, 4, 32, 3, 312, 24, None, [5, 160, 312]),         # g = 3, d = 32
    (16, 4, 64, 3, 304, 16, 40, [5, 150, 304]),           # g = 4, SWA
    (12, 2, 80, 3, 312, 24, None, [1, 128, 312]),         # g = 6, d = 80
    (14, 2, 128, 3, 304, 16, None, [10, 255, 304]),       # g = 7
    (16, 2, 64, 3, 1008, 16, None, [0, 640, 1008]),       # g = 8
    (24, 2, 128, 3, 312, 24, 50, [30, 200, 312]),         # g = 12, SWA
    (32, 2, 80, 3, 504, 24, None, [10, 255, 504]),        # g = 16
    (32, 1, 16, 3, 208, 16, None, [10, 100, 208]),        # g = 32: FP32 pipe
])
def test_paged_decode_bf16_body_edges(cuda, nh, nkv, d, b, s, bs, window,
                                      pos):
    """Kernel 1's bf16 body: the contig body's split walk reading keys
    through the block table, at any block size, its block, tile and split
    edges, short windows, B = 1, g = 1 ... 16 and every head dim."""
    rng = np.random.RandomState(8)
    dt = torch.bfloat16
    pk, pv, tbl = _pool(rng, b, s // bs, bs, nkv, d, dt, cuda)
    tbl[-1] = 0                                 # dead row on the trash block
    q = _rand(rng, (b, 1, nh, d), dt, cuda)
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    out = ops.decode_attention_paged(q, pk, pv, tbl, pos, window=window)
    ref = _ref(da.decode_attention_paged_plain, q, pk, pv, tbl, pos,
               window=window)
    torch.testing.assert_close(out.float(), ref, **_tol(dt))


@pytest.mark.parametrize("kind", ["flash", "paged_chunk", "contig_chunk",
                                  "paged_decode", "contig_decode"])
@pytest.mark.parametrize("nh,nkv,d,window", [(12, 4, 32, None),
                                             (12, 2, 128, 50),
                                             (14, 2, 64, None),
                                             (24, 2, 80, None),
                                             (12, 1, 16, 50)])
def test_bf16_groups_not_dividing_128(cuda, kind, nh, nkv, d, window):
    """g = 3, 6, 7 and 12 query heads per KV head through the bf16 bodies:
    the prefill body packs 128 // g query positions a CTA and pads the
    last 128 % g rows; the decode body pads g rows to 16."""
    rng = np.random.RandomState(9)
    dt, b, c, s, bs = torch.bfloat16, 2, 77, 500, 24
    if kind == "flash":
        q, k, v = (_rand(rng, (b, 300, n, d), dt, cuda)
                   for n in (nh, nkv, nkv))
        out = ops.flash_attention(q, k, v, causal=True, window=window)
        ref = _ref(fa.flash_attention_plain, q, k, v, causal=True,
                   window=window)
        torch.testing.assert_close(out.float(), ref, **_tol(dt))
        return
    paged = kind.startswith("paged")
    cols = 1 if kind.endswith("decode") else c
    q = _rand(rng, (b, cols, nh, d), dt, cuda)
    if paged:
        kv = _pool(rng, b, -(-s // bs), bs, nkv, d, dt, cuda)
        s = kv[2].shape[1] * bs
    else:
        kv = tuple(_rand(rng, (b, s, nkv, d), dt, cuda) for _ in range(2))
    at = torch.tensor([0, s - cols], dtype=torch.int32, device=cuda)
    if kind == "paged_decode":
        out = ops.decode_attention_paged(q, *kv, at, window=window)
        ref = _ref(da.decode_attention_paged_plain, q, *kv, at, window=window)
    elif kind == "contig_decode":
        out = ops.decode_attention(q, *kv, at, window=window)
        ref = _ref(da.decode_attention_plain, q, *kv, at, window=window)
    elif kind == "paged_chunk":
        out = ops.chunk_attention_paged(q, *kv, at, window=window)
        ref = _ref(ca.chunk_attention_paged_plain, q, *kv, at, window=window)
    else:
        out = ops.chunk_attention(q, *kv, at, window=window)
        ref = _ref(ca.chunk_attention_plain, q, *kv, at, window=window)
    torch.testing.assert_close(out.float(), ref, **_tol(dt))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["flash", "paged_chunk", "contig_chunk",
                                  "paged_decode", "contig_decode", "ring",
                                  "probe"])
@pytest.mark.parametrize("g,window", [(1, None), (4, 20), (4, 4096)])
def test_head_dim_120_kernels_match_plain(cuda, dtype, kind, g, window):
    """Head dim 120 (h2o-danube-3-4b: 3840 / 32) through every attention
    kernel and the probe, g = 1 and 4 (danube's 32 / 8), windows shorter
    than a tile and of 4096 with positions on both sides of it; the ring
    cache's decode route against the reference's slot_pos mask."""
    rng = np.random.RandomState(12)
    nkv, d, b, c, bs = 2, 120, 2, 77, 24
    nh, s = g * nkv, (4300 if window == 4096 else 500)
    if kind == "flash":
        q, k, v = (_rand(rng, (b, s, n, d), dtype, cuda)
                   for n in (nh, nkv, nkv))
        out = ops.flash_attention(q, k, v, causal=True, window=window)
        ref = _ref(fa.flash_attention_plain, q, k, v, causal=True,
                   window=window)
        torch.testing.assert_close(out.float(), ref, **_tol(dtype))
        return
    if kind == "ring":
        ring = window or 256
        k, v = (_rand(rng, (b, ring, nkv, d), dtype, cuda) for _ in range(2))
        q = _rand(rng, (b, 1, nh, d), dtype, cuda)
        for p in (ring // 3, ring - 1, ring + 5, 3 * ring + 1):
            j = torch.arange(ring, device=cuda)
            slot_pos = torch.where(j <= p, p - (p - j) % ring, -1)
            pos = torch.full((b,), p, dtype=torch.int32, device=cuda)
            out = ops.decode_attention_ring(q, k, v, pos)
            ref = _ref(attn.decode_attention_ring, q, k, v, pos, slot_pos)
            torch.testing.assert_close(out.float(), ref, **_tol(dtype))
        return
    paged = kind.startswith("paged") or kind == "probe"
    cols = 1 if kind.endswith("decode") else c
    q = _rand(rng, (b, cols, nh, d), dtype, cuda)
    if paged:
        kv = _pool(rng, b, -(-s // bs), bs, nkv, d, dtype, cuda)
        s = kv[2].shape[1] * bs
    else:
        kv = tuple(_rand(rng, (b, s, nkv, d), dtype, cuda) for _ in range(2))
    at = torch.tensor([s // 3, s - cols], dtype=torch.int32, device=cuda)
    if kind == "probe":
        out = kvp.kv_probe(*kv, at, c, nh, window=window)
        assert torch.equal(out, kvp.kv_probe_plain(*kv, at, c, nh,
                                                   window=window))
        return
    if kind == "paged_decode":
        out = ops.decode_attention_paged(q, *kv, at, window=window)
        ref = _ref(da.decode_attention_paged_plain, q, *kv, at, window=window)
    elif kind == "contig_decode":
        out = ops.decode_attention(q, *kv, at, window=window)
        ref = _ref(da.decode_attention_plain, q, *kv, at, window=window)
    elif kind == "paged_chunk":
        out = ops.chunk_attention_paged(q, *kv, at, window=window)
        ref = _ref(ca.chunk_attention_paged_plain, q, *kv, at, window=window)
    else:
        out = ops.chunk_attention(q, *kv, at, window=window)
        ref = _ref(ca.chunk_attention_plain, q, *kv, at, window=window)
    torch.testing.assert_close(out.float(), ref, **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("paged,c,window,percol", [(True, 1, None, False),
                                                   (True, 40, 8, True),
                                                   (False, 1, 16, False),
                                                   (False, 13, None, False)])
def test_kv_probe_matches_plain(cuda, dtype, paged, c, window, percol):
    """Kernel 7, the sanitizer probe, equals its plain version exactly (a
    maximum of absolute values does not round), and through the attention
    wrappers' ``probe=True``; poison (as the dtype stores it) in a block
    or position a row reads trips it, poison past every row's reach does
    not."""
    rng = np.random.RandomState(10)
    b, nh, nkv, d, s, bs = 3, 8, 2, 64, 200, 16
    if paged:
        pk, pv, tbl = _pool(rng, b, s // bs, bs, nkv, d, dtype, cuda)
        tbl[-1] = 0                             # dead row on the trash block
    else:
        pk, pv = (_rand(rng, (b, s, nkv, d), dtype, cuda) for _ in range(2))
        tbl = None
    bases = torch.tensor([5, 60, s if c == 1 else 100], dtype=torch.int32,
                         device=cuda)
    cols = (torch.tensor([c, 3, 0], dtype=torch.int32, device=cuda)
            if percol else None)
    stored = torch.tensor(KV_POISON, dtype=dtype).item()
    for poison in (None, "hot", "cold"):
        k = pk.clone()
        last = 5 + c - 1                        # row 0's last position
        if poison == "hot":
            k[tbl[0, last // bs].long() if paged else (0, last)] = stored
        elif poison == "cold":                  # every live row's tail
            if paged:
                k[tbl[:-1, -1].long()] = -stored
            else:
                k[:b - 1 if c == 1 else b, -1] = -stored
        n0 = kvp.launch_counts["kv_probe"]
        got = kvp.kv_probe(k, pv, tbl, bases, c, nh, window=window,
                           cols=cols)
        assert kvp.launch_counts["kv_probe"] == n0 + 1
        want = kvp.kv_probe_plain(k, pv, tbl, bases, c, nh, window=window,
                                  cols=cols)
        assert torch.equal(got, want)
        assert (got.max().item() >= stored) == (poison == "hot")
    q = _rand(rng, (b, c, nh, d), dtype, cuda)
    if paged and c == 1:
        _, got = ops.decode_attention_paged(q, pk, pv, tbl, bases,
                                            window=window, probe=True)
    elif paged:
        _, got = ops.chunk_attention_paged(q, pk, pv, tbl, bases,
                                           window=window, probe=True,
                                           probe_cols=cols)
    elif c > 1:
        _, got = ops.chunk_attention(q, pk, pv, bases, window=window,
                                     probe=True)
    else:
        return                          # contig decode has no probe
    assert torch.equal(got, kvp.kv_probe_plain(pk, pv, tbl, bases, c, nh,
                                               window=window, cols=cols))


_SSD_CASES = [
    (2, 37, 3, 16, 16, 16, False),          # ragged, several chunks, hd < 32
    (2, 100, 8, 64, 128, 64, True),         # ragged, initial state
    (1, 300, 4, 64, 64, 128, False),        # zamba2's N, Q = 128
    (3, 11, 2, 32, 16, 4, True),            # the parity tests' tiny chunks
]
# the bf16 tensor-core body's edges (fp32 runs the FP32-pipe body)
_SSD_BF16_EDGES = [
    (2, 50, 4, 64, 64, 128, False),         # S < Q
    (2, 300, 4, 64, 128, 128, True),        # S % Q != 0, h0
    (2, 200, 4, 64, 16, 64, False),         # N = 16, Q = 64
    (1, 300, 2, 64, 256, 128, True),        # N = 256 (one buffer)
    (2, 150, 3, 80, 64, 64, True),          # hd = 64 + 16: two slices
    (2, 45, 4, 64, 64, 8, False),           # Q = 8
    (1, 8192, 8, 64, 128, 128, False),      # 64 chunks of carried state
    (1, 40, 2, 16, 20, 16, False),          # N % 8 != 0: FP32-pipe body
]


@pytest.mark.parametrize(
    "dtype,b,s,nh,hd,n,chunk,init",
    [(dt,) + c for dt in DTYPES for c in _SSD_CASES]
    + [(torch.bfloat16,) + c for c in _SSD_BF16_EDGES])
def test_ssd_scan_kernel_matches_plain(cuda, dtype, b, s, nh, hd, n, chunk,
                                       init):
    """Kernel 6 on strided views (x, B and C sliced from one buffer, as the
    model gives them), its ragged tail masked in the kernel; in bf16 also
    short sequences, every chunk and state width the tensor-core body
    takes, head dims past one 64-wide slice and one long row."""
    rng = np.random.RandomState(5)
    xbc = _rand(rng, (b, s, nh * hd + 2 * n), dtype, cuda) * 0.5
    x = xbc[..., :nh * hd].reshape(b, s, nh, hd)
    bm, cm = xbc[..., nh * hd:nh * hd + n], xbc[..., nh * hd + n:]
    dt = torch.from_numpy(np.abs(rng.randn(b, s, nh)).astype(np.float32)
                          * 0.1 + 0.01).to(cuda)
    a = torch.from_numpy(-np.abs(rng.randn(nh)).astype(np.float32)
                         - 0.1).to(cuda)
    h0 = (torch.from_numpy(rng.randn(b, nh, hd, n).astype(np.float32)
                           * 0.2).to(cuda) if init else None)
    n0 = ssd.launch_counts["ssd_scan"]
    y, h = ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk, h0=h0)
    assert ssd.launch_counts["ssd_scan"] == n0 + 1
    yr, hr = _ref(ssd.ssd_scan_plain, x, dt, a, bm, cm, chunk=chunk, h0=h0)
    assert y.dtype == dtype and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), yr, **_tol(dtype))
    torch.testing.assert_close(h, hr, **_tol(dtype))


# -- the SSD scan's backward (training) ------------------------------------------
# (b, s, nh, hd, n, chunk, h0, dh_final): mamba2-1.3b's and zamba2-2.7b's
# train shapes (one 2048-token row: 64 heads of 64, N 128; 80 heads of 64,
# N 64), then reduced shapes: ragged S, S < Q, Q 128 / 64 / 12 / 8, N 16 to
# 256, head dims 16 / 32 / 64, an initial state and a final-state gradient
_SSD_BWD_CASES = [
    (1, 2048, 64, 64, 128, 128, False, False),
    (1, 2048, 80, 64, 64, 128, False, False),
    (2, 300, 4, 64, 128, 128, True, True),
    (2, 150, 6, 32, 64, 64, True, False),
    (2, 37, 4, 16, 16, 12, False, True),
    (3, 100, 4, 64, 32, 12, True, True),
    (1, 50, 2, 64, 256, 128, False, True),
    (2, 45, 4, 48, 64, 8, True, True),
]
_SSD_BWD_NAMES = ("dx", "ddt", "da", "db", "dc", "dh0")


def _ssd_bwd_inputs(seed, b, s, nh, hd, n, dtype, dev, init, dhf):
    """The forward's arguments as the model gives them (x, B and C strided
    views of one buffer), h0, dy in x's dtype and an fp32 dh_final."""
    rng = np.random.RandomState(seed)
    xbc = _rand(rng, (b, s, nh * hd + 2 * n), dtype, dev) * 0.5
    x = xbc[..., :nh * hd].reshape(b, s, nh, hd)
    bm, cm = xbc[..., nh * hd:nh * hd + n], xbc[..., nh * hd + n:]
    dt = torch.from_numpy(np.abs(rng.randn(b, s, nh)).astype(np.float32)
                          * 0.1 + 0.01).to(dev)
    a = torch.from_numpy(-np.abs(rng.randn(nh)).astype(np.float32)
                         - 0.1).to(dev)
    h0 = (_rand(rng, (b, nh, hd, n), torch.float32, dev) * 0.2 if init
          else None)
    dy = _rand(rng, (b, s, nh, hd), dtype, dev)
    dh = _rand(rng, (b, nh, hd, n), torch.float32, dev) if dhf else None
    return (x, dt, a, bm, cm), h0, dy, dh


def _check_ssd_grads(got, refs, bf16_outputs: bool, rel: float = 1e-4):
    """Each gradient within ``rel`` of its reference's largest element
    (fp32 sums in another order); dx, dB and dC in bf16 also within one
    bf16 rounding of it (2^-8 of the largest element)."""
    for i, (g, r) in enumerate(zip(got, refs)):
        name = _SSD_BWD_NAMES[i]
        if r is None:
            assert g is None, name
            continue
        big = r.abs().max().item()
        lim = rel * big + (2 ** -8 * big if bf16_outputs and i in (0, 3, 4)
                           else 0.0) + 1e-7
        err = (g.float() - r.float()).abs().max().item()
        assert g.shape == r.shape and np.isfinite(err), name
        assert err <= lim, (name, err, lim)


# the tensor-core body's head groups: (b, s, nh, hd, n, chunk, h0,
# dh_final, heads per CTA the plan picks on 132 SMs): groups that leave a
# remainder (nh 80 in 6s, nh 3 in 2s at a ragged S, nh 5 in 2s at Q 8),
# one group holding every head (dB / dC written by the kernel, no shares:
# nh 3 at N 256 and Q 12, nh 4 at Q 8, nh 1 at S < Q with N 256)
_SSD_BWD_GROUPS = [
    (1, 1152, 80, 64, 64, 128, False, False, 6),
    (2, 1450, 3, 32, 64, 64, True, True, 2),
    (2, 109, 5, 48, 64, 8, True, False, 2),
    (1, 1066, 3, 64, 256, 12, True, True, 3),
    (2, 397, 4, 64, 128, 8, True, True, 4),
    (1, 50, 1, 64, 256, 128, False, True, 1),
]


def _bwd_body(args, chunk):
    """(body, heads per CTA) the backward takes for these inputs."""
    return ssd.bwd_plan(args[0], args[3], args[4], chunk)[:2]


def _sm132(dev) -> bool:
    """The card the plan's head groups were chosen on (H100 SXM)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count == 132


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,nh,hd,n,chunk,init,dhf", _SSD_BWD_CASES)
def test_ssd_scan_bwd_kernel_matches_plain(cuda, dtype, b, s, nh, hd, n,
                                           chunk, init, dhf):
    """The backward kernel alone, given the exact chunk entry states
    (``ssd_states_plain`` in fp32), against the plain backward evaluated
    in fp32 on the same input values; bf16 on the tensor-core body, fp32
    on the CUDA-core one."""
    args, h0, dy, dh = _ssd_bwd_inputs(21, b, s, nh, hd, n, dtype, cuda,
                                       init, dhf)
    assert _bwd_body(args, chunk)[0] == (
        "tensor-core" if dtype == torch.bfloat16 else "cuda-core")
    states = _ref(ssd.ssd_states_plain, *args, chunk, h0)
    n0 = ssd.launch_counts["ssd_scan_bwd"]
    got = ssd.ssd_scan_bwd(*args, chunk, states, dy, dh, want_dh0=init)
    assert ssd.launch_counts["ssd_scan_bwd"] == n0 + 1
    refs = _ref(ssd.ssd_scan_bwd_plain, *args, chunk, h0, dy, dh)
    assert [None if t is None else t.dtype for t in got] == [
        dtype, torch.float32, torch.float32, dtype, dtype,
        torch.float32 if init else None]
    _check_ssd_grads(got, refs, dtype == torch.bfloat16)


@pytest.mark.parametrize("b,s,nh,hd,n,chunk,init,dhf,group",
                         _SSD_BWD_GROUPS)
def test_ssd_scan_bwd_tensor_core_groups(cuda, b, s, nh, hd, n, chunk,
                                         init, dhf, group):
    """The tensor-core body at the heads per CTA its plan picks: head
    counts the group leaves a remainder of, one group (no dB / dC shares),
    N 256, Q 12 and 8, S < Q, ragged S; x, B and C strided views of one
    buffer. The groups are asserted on a 132-SM card."""
    args, h0, dy, dh = _ssd_bwd_inputs(25, b, s, nh, hd, n, torch.bfloat16,
                                       cuda, init, dhf)
    body, got_group = _bwd_body(args, chunk)
    assert body == "tensor-core"
    if _sm132(cuda):
        assert got_group == group
    states = _ref(ssd.ssd_states_plain, *args, chunk, h0)
    got = ssd.ssd_scan_bwd(*args, chunk, states, dy, dh, want_dh0=init)
    refs = _ref(ssd.ssd_scan_bwd_plain, *args, chunk, h0, dy, dh)
    _check_ssd_grads(got, refs, True)


def test_ssd_scan_bwd_route_rule(cuda):
    """bf16 inputs that fail the forward's route rule take the CUDA-core
    body: N 20 (not a multiple of 8), and x copied to an odd offset. The
    train shapes take the tensor-core body with 8 and 10 heads a CTA on
    132 SMs (one wave of 128 CTAs)."""
    args, h0, dy, dh = _ssd_bwd_inputs(26, 1, 40, 2, 16, 20,
                                       torch.bfloat16, cuda, True, True)
    assert _bwd_body(args, 16)[0] == "cuda-core"
    states = _ref(ssd.ssd_states_plain, *args, 16, h0)
    got = ssd.ssd_scan_bwd(*args, 16, states, dy, dh, want_dh0=True)
    _check_ssd_grads(got, _ref(ssd.ssd_scan_bwd_plain, *args, 16, h0, dy,
                               dh), True)
    args, h0, dy, dh = _ssd_bwd_inputs(26, 1, 40, 2, 16, 16,
                                       torch.bfloat16, cuda, False, False)
    buf = torch.empty(args[0].numel() + 1, dtype=torch.bfloat16,
                      device=cuda)
    x_odd = buf[1:].view(args[0].shape)
    x_odd.copy_(args[0])
    assert _bwd_body((x_odd,) + args[1:], 16)[0] == "cuda-core"
    if _sm132(cuda):
        for nh, n, g in ((64, 128, 8), (80, 64, 10)):
            args = _ssd_bwd_inputs(27, 1, 2048, nh, 64, n, torch.bfloat16,
                                   cuda, False, False)[0]
            assert _bwd_body(args, 128) == ("tensor-core", g)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_scan_bwd_kernel_repeats(cuda, dtype):
    """Two calls on one input agree bit for bit, on both bodies (bf16: the
    tensor-core one, with head groups; fp32: the CUDA-core one): the
    heads' and groups' dB / dC shares and the da partials are summed in a
    fixed order, with no atomics."""
    args, h0, dy, dh = _ssd_bwd_inputs(22, 1, 2048, 64, 64, 128, dtype,
                                       cuda, True, True)
    assert _bwd_body(args, 128)[0] == (
        "tensor-core" if dtype == torch.bfloat16 else "cuda-core")
    states = _ref(ssd.ssd_states_plain, *args, 128, h0)
    one = ssd.ssd_scan_bwd(*args, 128, states, dy, dh, want_dh0=True)
    two = ssd.ssd_scan_bwd(*args, 128, states, dy, dh, want_dh0=True)
    assert all(torch.equal(p, q) for p, q in zip(one, two))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,nh,hd,n,chunk,init", [
    (1, 2048, 64, 64, 128, 128, False), (2, 300, 4, 64, 128, 128, True),
    (2, 100, 4, 32, 20, 12, True), (2, 150, 3, 80, 64, 64, True)])
def test_ssd_scan_states_output(cuda, dtype, b, s, nh, hd, n, chunk, init):
    """The forward with the chunk entry states gives the same y and final
    state as without them, and the states equal ``ssd_states_plain``
    within the forward's own tolerance (both bodies: N 20 takes the FP32
    one in bf16)."""
    args, h0, _, _ = _ssd_bwd_inputs(23, b, s, nh, hd, n, dtype, cuda,
                                     init, False)
    states = torch.empty((b, -(-s // chunk), nh, hd, n), device=cuda)
    y0, h_0 = ssd.ssd_scan(*args, chunk=chunk, h0=h0)
    y1, h_1 = ssd.ssd_scan(*args, chunk=chunk, h0=h0, states=states)
    assert torch.equal(y0, y1) and torch.equal(h_0, h_1)
    ref = _ref(ssd.ssd_states_plain, *args, chunk, h0)
    torch.testing.assert_close(states, ref, **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("use_h", [False, True])
def test_ssd_scan_trains_through_ssdscanfn(cuda, dtype, use_h):
    """``ops.ssd_scan`` with inputs that require grad runs ``SsdScanFn``:
    one forward and one backward launch, gradients of every input (h0
    too) against the plain backward evaluated in fp32, with the final
    state's gradient None (discarded, as ``LM.loss`` does) or given; no
    backward without a recorded gradient. bf16 within 1e-2 of each leaf's
    largest element: the forward's tensor-core body computes the saved
    states with tf32 products (about 1e-3 relative)."""
    args, h0, dy, dh = _ssd_bwd_inputs(24, 2, 150, 4, 64, 64, dtype, cuda,
                                       True, use_h)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in args + (h0,)]
    n_f = ssd.launch_counts["ssd_scan"]
    n_b = ssd.launch_counts["ssd_scan_bwd"]
    y, h = ops.ssd_scan(*leaves[:5], chunk=64, h0=leaves[5])
    assert y.grad_fn is not None
    outs, grads = ((y, h), (dy, dh)) if use_h else ((y,), (dy,))
    got = torch.autograd.grad(outs, leaves, grads)
    assert ssd.launch_counts["ssd_scan"] == n_f + 1
    assert ssd.launch_counts["ssd_scan_bwd"] == n_b + 1
    refs = _ref(ssd.ssd_scan_bwd_plain, *args, 64, h0, dy, dh)
    assert [t.dtype for t in got] == [dtype, torch.float32, torch.float32,
                                      dtype, dtype, torch.float32]
    _check_ssd_grads(got, refs, dtype == torch.bfloat16,
                     rel=1e-4 if dtype == torch.float32 else 1e-2)
    with torch.no_grad():
        assert ops.ssd_scan(*leaves[:5], chunk=64)[0].grad_fn is None
    assert ssd.launch_counts["ssd_scan_bwd"] == n_b + 1


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_ssm_loss_gradients_match_cpu(cuda, arch):
    """Reduced mamba2 / zamba2 ``LM.loss`` and every gradient leaf in fp32
    on the card (the SSD scan through ``SsdScanFn``, zamba2's shared
    attention through ``FlashAttentionFn``) against the CPU, chunks of 12
    over 32 tokens (two full chunks and a ragged one of 8): each leaf
    within 1e-4 of its largest CPU element + 1e-6, as in
    ``tests/test_torch_train.py``."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import DataConfig, SyntheticLM
    from repro_torch.train.data import to_torch
    cfg = get_config(arch).reduced()
    params = build_model(cfg, device="cpu").init(seed=0)
    batch = SyntheticLM(cfg, DataConfig(2, 32, 0)).batch_at(1)
    batch["mask"][1, 20:] = 0.0

    def run(dev):
        model = build_model(cfg, device=dev, ssd_chunk=12)
        leaves = {}

        def to(tree, path=""):
            if isinstance(tree, dict):
                return {k: to(v, f"{path}/{k}") for k, v in tree.items()}
            leaves[path] = tree.detach().to(dev).requires_grad_(True)
            return leaves[path]
        tree = to(params)
        loss = model.loss(tree, to_torch(batch, dev))
        names = sorted(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        return loss.item(), {k: g.cpu() for k, g in zip(names, grads)}

    n_b = ssd.launch_counts["ssd_scan_bwd"]
    loss, grads = run(cuda)
    assert ssd.launch_counts["ssd_scan_bwd"] > n_b
    ref_loss, ref = run("cpu")
    assert abs(loss - ref_loss) <= 2e-5 * abs(ref_loss)
    for k, r in ref.items():
        err = (grads[k] - r).abs().max().item()
        assert err <= 1e-4 * r.abs().max().item() + 1e-6, (k, err)


@pytest.mark.parametrize("arch,kw", [
    ("qwen3-32b", dict(max_batch=4, max_len=64, prefill_chunk=8)),
    ("qwen3-32b", dict(max_batch=4, max_len=64, prefill_chunk=8,
                       kv_layout="contig")),
    ("phi3.5-moe-42b-a6.6b", dict(max_batch=2, max_len=64)),
    ("mamba2-1.3b", dict(max_batch=2, max_len=64,
                         model_kw={"ssd_chunk": 8})),
    ("zamba2-2.7b", dict(max_batch=2, max_len=64,
                         model_kw={"ssd_chunk": 8})),
    ("qwen3-32b", dict(max_batch=4, max_len=64, prefill_chunk=8,
                       admission="legacy")),
])
def test_engine_tokens_match_cpu(cuda, arch, kw):
    """fp32 greedy tokens and counters: Engine on the card == on the CPU,
    paged, contig, MoE, SSM, hybrid and legacy admission."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import Engine, ServeRequest
    cfg = get_config(arch).reduced()
    cpu_params = build_model(cfg, device="cpu").init(seed=0)

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev)

    outs = []
    for dev, params in ((cuda, to(cpu_params, cuda)), ("cpu", cpu_params)):
        eng = Engine(cfg, params, device=dev, **kw)
        rs = [ServeRequest(prompt=list(range(1 + i, 6 + 9 * i)),
                           max_new_tokens=6) for i in range(4)]
        left = rs
        while left:                         # more requests than MoE slots
            taken = {id(r) for r in eng.admit_many(left)}
            left = [r for r in left if id(r) not in taken]
            eng.drain()
        outs.append(([r.generated for r in rs], eng.stats))
    assert outs[0] == outs[1]


def test_server_scenario_matches_cpu(cuda):
    """The fp32 server scenario of ``chip_smoke.py`` phase 4 (a reduced
    qwen3-32b behind a GlobalServer: two paged pipelines with placements,
    cost dispatch, KV migration through a budgeted store, one interruption)
    on the card against the CPU: identical tokens per request, events and
    store state, at least one KV attach and one budget eviction."""
    import importlib.util
    from pathlib import Path

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = get_config("qwen3-32b").reduced()
    cpu = build_model(cfg, device="cpu").init(seed=0)
    card = smoke.server_scenario(cfg, smoke._tree_to(cpu, cuda), cuda)
    host = smoke.server_scenario(cfg, cpu, "cpu")
    assert card == host
    assert card["ok"] and card["attached"] and card["evicted"]


def _smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("sanitize", [False, True])
def test_prefix_scenario_matches_cpu(cuda, sanitize):
    """The prefix scenarios of ``chip_smoke.py`` phase 4 (donor / sharer
    waves with full-block sharing, deferred and admission-time
    copy-on-write; sanitized too) on the card against the CPU: identical
    tokens, counters and pool state, the tokens of the engine without
    sharing, 8 hits and 5 copies."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    smoke = _smoke()
    cfg = get_config("qwen3-32b").reduced()
    cpu = build_model(cfg, device="cpu").init(seed=0)
    card = smoke.prefix_scenario(cfg, smoke._tree_to(cpu, cuda), cuda,
                                 sanitize=sanitize)
    assert card == smoke.prefix_scenario(cfg, cpu, "cpu", sanitize=sanitize)
    assert card["tokens"] == smoke.prefix_scenario(cfg, cpu, "cpu",
                                                   share=False)["tokens"]
    assert card["stats"]["prefix_hits"] == 8
    assert card["stats"]["cow_copies"] == 5


def test_server_prefix_scenario_matches_cpu(cuda):
    """``use_prefix_share=True`` behind a GlobalServer on the card against
    the CPU: identical tokens, events, clock and store accounting."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    smoke = _smoke()
    cfg = get_config("qwen3-32b").reduced()
    cpu = build_model(cfg, device="cpu").init(seed=0)
    card = smoke.server_prefix_scenario(cfg, smoke._tree_to(cpu, cuda), cuda)
    assert card == smoke.server_prefix_scenario(cfg, cpu, "cpu")
    assert card["prefix"][1][1] >= 1 and card["no_leak"]


# -- the flash backward (training) ---------------------------------------------
def _bwd_inputs(seed, b, sq, sk, nh, nkv, d, dtype, dev):
    rng = np.random.RandomState(seed)
    return (_rand(rng, (b, sq, nh, d), dtype, dev),
            _rand(rng, (b, sk, nkv, d), dtype, dev),
            _rand(rng, (b, sk, nkv, d), dtype, dev),
            _rand(rng, (b, sq, nh, d), dtype, dev))


def _plain_bf16_grads(q, k, v, dout, causal, window):
    """The plain version's gradient in bf16 itself (its own error)."""
    with torch.enable_grad():
        qs = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = fa.flash_attention_plain(*qs, causal=causal, window=window)
        return torch.autograd.grad(out, qs, dout)


def _check_bwd(q, k, v, dout, causal, window):
    """The forward kernel's log-sum-exp against the plain one, then the
    backward kernel's (dq, dk, dv) against the plain gradient in fp32:
    fp32 within 1e-4 of each gradient's largest element (another summation
    order), bf16 within 3x the plain version's own bf16 error."""
    b, sq, nh, _ = q.shape
    lse = torch.empty((b, nh, sq), dtype=torch.float32, device=q.device)
    out = fa.flash_attention(q, k, v, causal=causal, window=window, lse=lse)
    lse_ref = fa.flash_lse_plain(q, k, causal=causal, window=window)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-4)
    n0 = fa.launch_counts["flash_attention_bwd"]
    got = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                 window=window)
    assert fa.launch_counts["flash_attention_bwd"] == n0 + 1
    refs = fa.flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                        window=window)
    own = (_plain_bf16_grads(q, k, v, dout, causal, window)
           if q.dtype == torch.bfloat16 else None)
    for i, (g, r) in enumerate(zip(got, refs)):
        assert g.dtype == q.dtype and g.shape == r.shape
        err = (g.float() - r).abs().max().item()
        assert np.isfinite(err)
        if own is None:
            assert err <= 1e-4 * r.abs().max().item() + 1e-7, (i, err)
        else:
            lim = 3 * (own[i].float() - r).abs().max().item()
            assert err <= lim, ("dq dk dv".split()[i], err, lim)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [16, 32, 64, 80, 120, 128])
@pytest.mark.parametrize("g", [1, 2, 6, 8, 12])
def test_flash_bwd_kernel_head_dims_and_groups(cuda, dtype, d, g):
    """Every head dim and GQA group on a ragged causal sequence of 37."""
    nkv = 2 if g < 8 else 1
    args = _bwd_inputs(11, 2, 37, 37, g * nkv, nkv, d, dtype, cuda)
    _check_bwd(*args, causal=True, window=None)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sq,sk,nh,nkv,d,causal,window", [
    (37, 37, 4, 2, 64, False, None),        # non-causal
    (300, 300, 4, 2, 64, True, 50),         # window across tiles, causal
    (200, 200, 4, 2, 32, False, 40),        # window without causal
    (13, 37, 6, 6, 64, False, None),        # Sq != Sk (cross attention)
    (37, 13, 6, 6, 64, False, None),        # Sq > Sk
    (37, 13, 4, 2, 64, True, None),         # causal with Sq > Sk
    (13, 1500, 6, 6, 64, False, None),      # whisper's 1500 encoder frames
    (333, 333, 8, 2, 120, True, 100),       # danube's head dim, windowed
    (257, 257, 16, 8, 128, True, None),     # internlm2's heads, ragged
    (130, 130, 12, 1, 80, True, None),      # g = 12 at d = 80
])
def test_flash_bwd_kernel_masks(cuda, dtype, sq, sk, nh, nkv, d, causal,
                                window):
    args = _bwd_inputs(12, 2, sq, sk, nh, nkv, d, dtype, cuda)
    _check_bwd(*args, causal=causal, window=window)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sq,sk,causal,window", [
    (127, 127, True, None),                 # one short of a 128-key tile
    (128, 128, True, None),
    (129, 129, True, None),                 # one key into the second tile
    (255, 255, True, None),
    (257, 257, True, None),
    (129, 257, False, None),                # Sq != Sk at the edges
    (257, 127, False, None),
    (255, 128, True, None),
    (128, 257, True, None),
    (300, 300, True, 37),                   # window edges inside key tiles
    (257, 257, True, 130),                  # ... and across a tile boundary
    (255, 255, False, 70),                  # a window without causal
])
def test_flash_bwd_kernel_tile_edges(cuda, dtype, sq, sk, causal, window):
    """Lengths and windows that end inside or just past the bf16 body's
    128-key tiles and 64-query steps."""
    args = _bwd_inputs(15, 2, sq, sk, 8, 2, 128, dtype, cuda)
    _check_bwd(*args, causal=causal, window=window)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nh,nkv", [(12, 2), (24, 2), (16, 1)])
def test_flash_bwd_kernel_head_split(cuda, dtype, nh, nkv):
    """g = 6, 12 and 16 at B 1, S 1024: 8 key tiles x nkv CTAs would leave
    most SMs idle, so the bf16 body splits each key tile's (query head,
    query tile) steps over CTAs (fp32 partial dK / dV summed in split
    order); fp32 never splits."""
    args = _bwd_inputs(16, 1, 1024, 1024, nh, nkv, 128, dtype, cuda)
    nsplit = fa.bwd_plan(args[0], args[1], causal=True)[1]
    assert (nsplit > 1) == (dtype == torch.bfloat16)
    _check_bwd(*args, causal=True, window=None)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nh,nkv,s,d,causal", [(12, 2, 1024, 128, True),
                                               (8, 8, 2048, 64, False)])
def test_flash_bwd_kernel_repeats(cuda, dtype, nh, nkv, s, d, causal):
    """Two calls on the same inputs, with a split (causal) and without:
    dK and dV bitwise equal (no atomics; split partials summed in a fixed
    order), dQ within one bf16 unit in the last place of its largest
    element (the bf16 body reduce-adds dQ in fp32 in the order the CTAs
    finish); fp32 all bitwise."""
    q, k, v, dout = _bwd_inputs(17, 1, s, s, nh, nkv, d, dtype, cuda)
    lse = torch.empty((1, nh, s), dtype=torch.float32, device=cuda)
    out = fa.flash_attention(q, k, v, causal=causal, lse=lse)
    one = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal)
    two = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal)
    assert torch.equal(one[1], two[1]) and torch.equal(one[2], two[2])
    if dtype == torch.float32:
        assert torch.equal(one[0], two[0])
    else:
        big = one[0].float().abs().max().item()
        assert (one[0].float() - two[0].float()).abs().max() <= 2 ** -7 * big


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_autograd_through_kernels(cuda, dtype):
    """``ops.flash_attention`` with inputs that require grad runs
    ``FlashAttentionFn``: one forward and one backward launch, the
    gradient of a non-contiguous upstream (a transposed output
    gradient), and no launch without a recorded gradient."""
    q, k, v, dout = _bwd_inputs(13, 1, 64, 64, 8, 2, 64, dtype, cuda)
    qs = [t.detach().requires_grad_(True) for t in (q, k, v)]
    n_f = fa.launch_counts["flash_attention"]
    n_b = fa.launch_counts["flash_attention_bwd"]
    out = ops.flash_attention(*qs, causal=True)
    assert out.grad_fn is not None
    dnc = dout.transpose(1, 2).contiguous().transpose(1, 2)
    got = torch.autograd.grad(out, qs, dnc)
    assert fa.launch_counts["flash_attention"] == n_f + 1
    assert fa.launch_counts["flash_attention_bwd"] == n_b + 1
    refs = fa.flash_attention_bwd_plain(q, k, v, dout, causal=True)
    for g, r in zip(got, refs):
        tol = 1e-4 if dtype == torch.float32 else 3e-2
        assert (g.float() - r).abs().max().item() <= tol * r.abs().max()
    with torch.no_grad():
        assert ops.flash_attention(*qs).grad_fn is None


def _guard_calls(dev):
    """One call of every serving kernel wrapper through ``ops`` on CUDA
    inputs, q (or the cache) requiring grad."""
    rng = np.random.RandomState(14)
    f32 = torch.float32
    q = _rand(rng, (2, 1, 4, 16), f32, dev).requires_grad_(True)
    qc = _rand(rng, (2, 3, 4, 16), f32, dev).requires_grad_(True)
    ck, cv = (_rand(rng, (2, 32, 2, 16), f32, dev) for _ in range(2))
    pk, pv, tbl = _pool(rng, 2, 2, 16, 2, 16, f32, dev)
    return {
        "decode_attention_paged": lambda: ops.decode_attention_paged(
            q, pk, pv, tbl, 5),
        "decode_attention": lambda: ops.decode_attention(q, ck, cv, 5),
        "chunk_attention_paged": lambda: ops.chunk_attention_paged(
            qc, pk, pv, tbl, 4),
        "chunk_attention": lambda: ops.chunk_attention(qc, ck, cv, 4),
        "kv_probe": lambda: kvp.kv_probe(ck.requires_grad_(True), cv, None,
                                         0, 3, 4),
    }


@pytest.mark.parametrize("name", ["decode_attention_paged",
                                  "decode_attention",
                                  "chunk_attention_paged", "chunk_attention",
                                  "kv_probe"])
def test_kernel_wrappers_refuse_gradients_on_card(cuda, name):
    """No kernel without a backward returns an output that silently drops
    the gradient: each serving kernel raises while autograd records, and
    runs under ``torch.no_grad()`` (the SSD scan trains through
    ``SsdScanFn``: ``test_ssd_scan_trains_through_ssdscanfn``)."""
    call = _guard_calls(cuda)[name]
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    with torch.no_grad():
        call()


# -- fp8 KV caches: the contiguous decode kernel --------------------------------
FP8 = [torch.float8_e4m3fn, torch.float8_e5m2]


def _fp8_cache(rng, shape, fp8, dev):
    """A cache cast by ``astype`` from values of scale 2 with 2% of them
    at +-448 (float8_e4m3fn's largest) and 2% in both formats' subnormal
    ranges."""
    x = rng.randn(*shape).astype(np.float32) * 2
    flat = x.reshape(-1)
    idx = rng.permutation(flat.size)[: flat.size // 25]
    half = len(idx) // 2
    flat[idx[:half]] = rng.choice([-448.0, 448.0], half)
    flat[idx[half:]] = rng.uniform(-1, 1, len(idx) - half) * rng.choice(
        [2.0 ** -7, 2.0 ** -15], len(idx) - half)
    return astype(torch.from_numpy(x).to(dev), fp8)


@pytest.mark.parametrize("fp8", FP8)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [16, 32, 64, 80, 120, 128])
@pytest.mark.parametrize("nh,nkv,window", [(8, 2, None), (16, 1, 40),
                                           (32, 1, None)])
def test_fp8_decode_equals_the_kernel_on_the_upcast_cache(cuda, fp8, dtype,
                                                          d, nh, nkv,
                                                          window):
    """On an fp8 cache the kernel reads the codes as stored and computes,
    bit for bit, what it computes on the cache upcast to q's dtype (the
    same body and splits: g = 4 and 16 the bf16 tensor-core body, g = 32
    the FP32-pipe body); and it lies within tolerance of its plain version
    (atol scaled by the largest |V|: the cache spans +-448)."""
    rng = np.random.RandomState(d + nh)
    b, s = 4, 300
    q = _rand(rng, (b, 1, nh, d), dtype, cuda)
    k, v = (_fp8_cache(rng, (b, s, nkv, d), fp8, cuda) for _ in range(2))
    pos = torch.tensor([0, 131, 257, s], dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    out = da.decode_attention(q, k, v, pos, window=window)
    up = da.decode_attention(q, k.to(dtype), v.to(dtype), pos, window=window)
    torch.cuda.synchronize()
    assert ops.decode_launches_by_cache_dtype() == {
        str(fp8).removeprefix("torch."): 1,
        str(dtype).removeprefix("torch."): 1}
    assert torch.equal(out.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       up.view(torch.int16 if dtype == torch.bfloat16
                               else torch.int32))
    ref = _ref(da.decode_attention_plain, q, k, v, pos, window=window)
    tol = _tol(dtype)
    vmax = v.float().abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol["rtol"],
                               atol=tol["atol"] * vmax)


@pytest.mark.parametrize("fp8", FP8)
def test_fp8_decode_refuses_other_kernels_and_mixed_dtypes(cuda, fp8):
    rng = np.random.RandomState(0)
    q = _rand(rng, (2, 1, 8, 64), torch.bfloat16, cuda)
    k = _fp8_cache(rng, (2, 64, 2, 64), fp8, cuda)
    with pytest.raises(ValueError, match="one fp8 dtype"):
        da.decode_attention(q, k, k.to(torch.bfloat16), 3)
    pk = k.reshape(8, 16, 2, 64)
    tbl = torch.arange(1, 5, dtype=torch.int32, device=cuda).reshape(2, 2)
    with pytest.raises(ValueError, match="contiguous decode kernel"):
        da.decode_attention_paged(q, pk, pk, tbl, 3)


@pytest.mark.parametrize("fp8", FP8)
def test_fp8_cast_on_the_card_equals_the_cpu(cuda, fp8):
    """``common.astype`` on CUDA tensors gives the CPU's bytes on every
    bf16 bit pattern and around the formats' edges in fp32."""
    bits = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    x16 = bits.view(torch.bfloat16)
    edges = torch.tensor([448.0, 464.0, 466.0, 480.0, 57344.0, 61440.0,
                          2.0 ** -9, 2.0 ** -10, 2.0 ** -16, 2.0 ** -17,
                          float("inf"), float("nan"), 0.0])
    x32 = (edges * (1 + torch.linspace(-0.2, 0.2, 4001)[:, None])
           ).reshape(-1)
    x32 = torch.cat([x32, -x32])
    for x in (x16, x32):
        cpu = astype(x, fp8).view(torch.uint8)
        card = astype(x.to(cuda), fp8).view(torch.uint8).cpu()
        assert torch.equal(card, cpu), str(x.dtype)


@pytest.mark.parametrize("fmt", ["float8_e4m3fn", "float8_e5m2"])
def test_fp8_serve_step_on_the_card_equals_the_cpu(cuda, fmt):
    """``build_step``'s serve step on an fp8 cache, reduced qwen3-32b in
    fp32, prefill + 4 steps: tokens card == CPU, every decode launch on
    the fp8 cache, the written fp8 codes at most one apart (the card's K
    rounds in another summation order and may land across a midpoint)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import mesh_for_rank
    cfg = get_config("qwen3-32b").reduced()
    rng = np.random.RandomState(0)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 9)))
    mesh = mesh_for_rank((1, 1), ("data", "model"), 0)
    shapes = (ShapeSpec("p", 24, 4, "prefill_step"),
              ShapeSpec("d", 24, 4, "serve_step"))
    base = S.build_step(cfg, shapes[0], mesh, device="cpu").init_params(0)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        pre = S.build_step(cfg, shapes[0], mesh, device=dev)
        srv = S.build_step(cfg, shapes[1], mesh, kv_cache_dtype=fmt,
                           device=dev)
        params = _tree_to(base, dev)
        with torch.no_grad():
            ops.reset_launch_counts()
            tok, cache = pre.fn(params, {"tokens": prompt.to(dev)})
            cache = srv.store_cache(cache)
            cur, toks = tok.reshape(4, 1), []
            for _ in range(4):
                cur, cache = srv.fn(params, cache, cur)
                toks.append(cur.cpu())
        out[dev.type] = (torch.cat(toks, 1), cache["k"].cpu(),
                         ops.decode_launches_by_cache_dtype())
    card, host = out["cuda"], out["cpu"]
    assert torch.equal(card[0], host[0])
    assert card[2] == {fmt: 4 * cfg.n_layers}
    assert card[1].dtype == getattr(torch, fmt)
    a = card[1].view(torch.uint8).numpy().astype(np.int32)
    b = host[1].view(torch.uint8).numpy().astype(np.int32)
    order = lambda x: np.where(x & 0x80, -(x & 0x7F), x & 0x7F)  # noqa: E731
    apart = np.abs(order(a) - order(b))
    assert apart.max() <= 1 and (apart > 0).mean() < 1e-3


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)
