"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test asks for the ``cuda`` fixture, which skips when
there is no card (the check runs inside the fixture, never at import, so
every pytest-xdist worker collects the same tests). On a machine with an
H100 run them with ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_kernels_gpu.py``. Tolerances: bf16 2e-2, fp32 1e-4 (the
kernels sum in another order than the plain versions' einsums).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import chunk_attention as ca
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

pytestmark = pytest.mark.gpu
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _tol(dtype):
    t = 2e-2 if dtype == torch.bfloat16 else 1e-4
    return dict(atol=t, rtol=t)


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
    n0 = da.launch_count
    out = ops.decode_attention_paged(q, pk, pv, tbl, pos, window=window)
    assert da.launch_count == n0 + 1
    ref = da.decode_attention_paged_plain(q, pk, pv, tbl, pos, window=window)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))


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
    ref = ca.chunk_attention_paged_plain(q, pk, pv, tbl, bases,
                                         window=window)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,causal,window", [(64, True, None),
                                             (77, True, 16),
                                             (50, False, None)])
def test_flash_kernel_matches_plain(cuda, dtype, s, causal, window):
    rng = np.random.RandomState(2)
    b, nh, nkv, d = 2, 8, 2, 32
    q = _rand(rng, (b, s, nh, d), dtype, cuda)
    k = _rand(rng, (b, s, nkv, d), dtype, cuda)
    v = _rand(rng, (b, s, nkv, d), dtype, cuda)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))


def test_engine_tokens_match_cpu(cuda):
    """fp32 greedy tokens and counters: Engine on the card == on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import Engine, ServeRequest
    cfg = get_config("qwen3-32b").reduced()
    cpu_params = build_model(cfg, device="cpu").init(seed=0)

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev)

    outs = []
    for dev, params in ((cuda, to(cpu_params, cuda)), ("cpu", cpu_params)):
        eng = Engine(cfg, params, device=dev, max_batch=4, max_len=64,
                     prefill_chunk=8)
        rs = [ServeRequest(prompt=list(range(1 + i, 6 + 9 * i)),
                           max_new_tokens=6) for i in range(4)]
        eng.admit_many(rs)
        eng.drain()
        outs.append(([r.generated for r in rs], eng.stats))
    assert outs[0] == outs[1]
