"""The port's seven CUDA kernels against their plain PyTorch versions, on
the card, and the engine and the global server on the card against the
same on the CPU.

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
way (it rounds y to bf16 once; it sums in another order).
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


@pytest.mark.parametrize("arch,kw", [
    ("qwen3-32b", dict(max_batch=4, max_len=64, prefill_chunk=8)),
    ("qwen3-32b", dict(max_batch=4, max_len=64, prefill_chunk=8,
                       kv_layout="contig")),
    ("phi3.5-moe-42b-a6.6b", dict(max_batch=2, max_len=64)),
    ("mamba2-1.3b", dict(max_batch=2, max_len=64,
                         model_kw={"ssd_chunk": 8})),
    ("zamba2-2.7b", dict(max_batch=2, max_len=64,
                         model_kw={"ssd_chunk": 8})),
])
def test_engine_tokens_match_cpu(cuda, arch, kw):
    """fp32 greedy tokens and counters: Engine on the card == on the CPU,
    paged, contig, MoE, SSM and hybrid."""
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
