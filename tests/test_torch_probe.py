"""The KV sanitizer's device probe in the port, against the JAX package.

Kernel level: the probe's plain version (``repro_torch.kernels.kv_probe``,
through the three attention wrappers' ``probe=True``) against the Pallas
kernels' ``probe=True`` output in interpret mode, as
tests/test_kernels.py runs them: paged decode, paged chunk and contiguous
chunk, fp32, ragged positions and bases, sliding windows, a dead row on the
trash table, poison in a readable and in an unreadable block. A maximum of
absolute values has no rounding, so the two must be equal; the attention
outputs beside them are held at the reference's fp32 tolerance (2e-5).

Engine level, the port's counterparts of tests/test_chunk_prefill.py's
probe tests and of tests/test_kv_sanitizer.py's churn test: the probe
trips at the decode step and at the chunk that read a poisoned mapped
block, is dark by default, and a sanitized engine with preemptions emits
the JAX engine's tokens and counters. Then the two deliberate differences
from the reference (ROADMAP.md section C): the threshold in a bf16 pool,
and a chunk probing its real columns only.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.chunk_attention import chunk_attention as jax_chunk
from repro.kernels.chunk_attention import \
    chunk_attention_paged as jax_chunk_paged
from repro.kernels.decode_attention import \
    decode_attention_paged as jax_decode_paged
from repro.models import build_model as jax_build
from repro.serving import Engine as JaxEngine
from repro.serving import ServeRequest as JaxRequest
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.kv_probe import kv_probe_plain
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import Engine, ServeRequest
from repro_torch.serving.kv_blocks import KV_POISON, KVSanitizerError

ATOL = RTOL = 2e-5          # the reference's fp32 kernel tolerance
STATS = ("prefills", "prefill_batches", "prefill_chunks", "chunk_direct",
         "block_grows", "preemptions", "kv_imports", "alloc_failures",
         "decode_steps", "tokens_out", "admit_deferred")


def _both(x):
    """A numpy array as (jax array, CPU torch tensor)."""
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def _pool(rng, b, mb, bs, nkv, d):
    pk = rng.randn(1 + b * mb, bs, nkv, d).astype(np.float32)
    pv = rng.randn(1 + b * mb, bs, nkv, d).astype(np.float32)
    tbl = (rng.permutation(b * mb).reshape(b, mb) + 1).astype(np.int32)
    return pk, pv, tbl


def _poison(pool, block, sign=1.0):
    out = pool.copy()
    out[block] = sign * KV_POISON
    return out


def _same(jax_out, torch_out):
    (jo, jp), (to, tp) = jax_out, torch_out
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL,
                               rtol=RTOL)
    return tp


# (window, poison): poison None, in a block only the last row reads
# ("hot"), or in a block no row reads ("cold")
@pytest.mark.parametrize("window,poison", [(None, None), (None, "hot"),
                                           (None, "cold"), (6, "hot")])
def test_decode_paged_probe_matches_pallas(window, poison):
    """Paged decode: ragged positions (0, mid-block, block edge, the last
    position) and a dead row on the trash table with a frozen position."""
    rng = np.random.RandomState(0)
    b, nh, nkv, d, bs, mb = 5, 4, 2, 16, 8, 4
    pk, pv, tbl = _pool(rng, b, mb, bs, nkv, d)
    tbl[-1] = 0                                 # dead row: trash table
    pos = np.array([0, 11, bs - 1, bs * mb - 1, 17], np.int32)
    if poison == "hot":     # row 3's last block: only row 3 reaches it
        pv = _poison(pv, tbl[3, mb - 1], -1.0)
    elif poison == "cold":  # row 0's third block: past its position
        pk = _poison(pk, tbl[0, 2])
    q = rng.randn(b, 1, nh, d).astype(np.float32)
    args = [_both(x) for x in (q, pk, pv, tbl, pos)]
    jout = jax_decode_paged(*[a[0] for a in args], window=window,
                            probe=True, interpret=True)
    tout = ops.decode_attention_paged(*[a[1] for a in args], window=window,
                                      probe=True)
    pmax = _same(jout, tout)
    assert pmax.shape == (b, nh)
    assert (float(pmax.max()) >= KV_POISON) == (poison == "hot")


@pytest.mark.parametrize("window,vecbase,poison", [
    (None, False, None), (None, True, "hot"), (None, True, "cold"),
    (5, True, "hot")])
def test_chunk_paged_probe_matches_pallas(window, vecbase, poison):
    """Paged chunk: scalar or per-row bases (one row at base 0), a dead
    row on the trash table; every column of the chunk counts, pad columns
    too, as in the Pallas grid."""
    rng = np.random.RandomState(1)
    b, c, nh, nkv, d, bs, mb = 3, 8, 4, 2, 16, 8, 4
    pk, pv, tbl = _pool(rng, b, mb, bs, nkv, d)
    tbl[-1] = 0
    bases = (np.array([0, 13, 24], np.int32) if vecbase
             else np.asarray(9, np.int32))
    if poison == "hot":     # row 1's second block: its queries reach 20
        pk = _poison(pk, tbl[1, 1])
    elif poison == "cold":  # row 0's last block: past every query
        pv = _poison(pv, tbl[0, mb - 1], -1.0)
    q = rng.randn(b, c, nh, d).astype(np.float32)
    args = [_both(x) for x in (q, pk, pv, tbl, bases)]
    jout = jax_chunk_paged(*[a[0] for a in args], window=window, probe=True,
                           interpret=True)
    tout = ops.chunk_attention_paged(*[a[1] for a in args], window=window,
                                     probe=True)
    pmax = _same(jout, tout)
    assert (float(pmax.max()) >= KV_POISON) == (poison == "hot")


@pytest.mark.parametrize("window,poison", [(None, None), (None, "hot"),
                                           (4, "cold")])
def test_chunk_contig_probe_matches_pallas(window, poison):
    """Contiguous chunk: per-row bases; poison at a readable position or
    past every query (and, under the window, before it)."""
    rng = np.random.RandomState(2)
    b, c, s, nh, nkv, d = 2, 8, 32, 4, 2, 16
    ck = rng.randn(b, s, nkv, d).astype(np.float32)
    cv = rng.randn(b, s, nkv, d).astype(np.float32)
    bases = np.array([3, 16], np.int32)
    if poison == "hot":
        cv[1, 20] = KV_POISON
    elif poison == "cold":  # before row 1's window, past its last query
        ck[1, 2], ck[1, 30] = KV_POISON, -KV_POISON
    q = rng.randn(b, c, nh, d).astype(np.float32)
    args = [_both(x) for x in (q, ck, cv, bases)]
    jout = jax_chunk(*[a[0] for a in args], window=window, probe=True,
                     interpret=True)
    tout = ops.chunk_attention(*[a[1] for a in args], window=window,
                               probe=True)
    pmax = _same(jout, tout)
    assert (float(pmax.max()) >= KV_POISON) == (poison == "hot")


def test_probe_cols_limit_the_readable_columns():
    """``probe_cols`` (the engine's real columns) leaves out what only pad
    columns would read, and a row of no column reads nothing."""
    rng = np.random.RandomState(3)
    b, c, nh, nkv, d, bs, mb = 3, 8, 4, 2, 16, 8, 4
    pk, pv, tbl = (torch.from_numpy(x) for x in _pool(rng, b, mb, bs, nkv,
                                                      d))
    pk[tbl[0, 1], 3] = KV_POISON        # row 0, position 11
    bases = torch.tensor([8, 8, 8])
    full = kv_probe_plain(pk, pv, tbl, bases, c, nh)
    cols = torch.tensor([3, 8, 0], dtype=torch.int32)
    real = kv_probe_plain(pk, pv, tbl, bases, c, nh, cols=cols)
    assert float(full[0].max()) == KV_POISON
    assert float(real[0].max()) < KV_POISON          # reads up to 10 only
    assert torch.equal(real[1], full[1]) and not real[2].any()


# -- engine ---------------------------------------------------------------------

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


@pytest.fixture(scope="module")
def setup():
    return _arch("internlm2-1.8b")


def _engine(setup, **kw):
    _, _, tcfg, tparams = setup
    return Engine(tcfg, tparams, device="cpu", max_batch=2, max_len=64,
                  block_size=8, victim_policy="fewest", **kw)


def test_probe_trips_on_corrupted_block(setup):
    """Poison planted in a mapped (readable) pool block raises at the very
    decode step that reads it, before its token is committed."""
    eng = _engine(setup, kv_sanitize=True)
    assert eng._kv_probe
    req = ServeRequest(prompt=[1, 2, 3, 4, 5, 6], max_new_tokens=8)
    assert eng.admit(req)
    eng.step()
    n = len(req.generated)
    slot = next(i for i, r in enumerate(eng.slots) if r is req)
    eng.cache["k"][:, int(eng.bm.table[slot, 0])] = KV_POISON
    with pytest.raises(KVSanitizerError, match="poisoned KV block"):
        eng.step()
    assert len(req.generated) == n


def test_probe_trips_mid_chunk(setup):
    """The chunk dispatch probes too: corrupting an already-written block
    of a mid-prefill slot fires on the next chunk."""
    eng = _engine(setup, prefill_chunk=8, kv_sanitize=True)
    req = ServeRequest(prompt=list(range(1, 42)), max_new_tokens=4)
    assert eng.admit(req)
    eng.step()                                   # first chunk written
    assert not req.generated                     # still mid-prefill
    slot = eng._pending[0].members[0].slot
    eng.cache["v"][:, int(eng.bm.table[slot, 0])] = -KV_POISON
    with pytest.raises(KVSanitizerError, match="poisoned KV block"):
        eng.step()


def test_probe_off_by_default(setup):
    """Without the sanitizer the probe is dark: the same corruption
    decodes without raising, and no probe kernel or plain probe runs."""
    eng = _engine(setup)
    assert not eng._kv_probe and not eng.model.kv_probe
    req = ServeRequest(prompt=[1, 2, 3, 4, 5, 6], max_new_tokens=4)
    assert eng.admit(req)
    eng.step()
    slot = next(i for i, r in enumerate(eng.slots) if r is req)
    eng.cache["k"][:, int(eng.bm.table[slot, 0])] = KV_POISON
    eng.step()                                   # must not raise
    assert eng.model.take_probe() is None


def _churn(eng, Req, vocab):
    """tests/test_kv_sanitizer.py's churn: grows, preemptions, re-attach."""
    rng = np.random.RandomState(11)
    reqs = [Req(prompt=rng.randint(0, vocab, rng.randint(3, 30)).tolist(),
                max_new_tokens=int(rng.randint(2, 12))) for _ in range(8)]
    queue = list(reqs)
    for _ in range(400):
        if not (queue or eng.active() or eng._pending or eng._preempted):
            break
        if queue:
            adm = eng.admit_many(queue[:2])
            taken = {id(r) for r in adm}
            queue = [r for r in queue if id(r) not in taken]
        eng.step()
        for req, _ in eng.take_preempted():
            queue.insert(0, req)
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs]


def test_sanitized_engine_matches_jax_with_churn(setup):
    """A sanitized engine with preemptions: no false positive, and the JAX
    engine's tokens and counters (both with ``kv_sanitize=True``)."""
    jcfg, jparams, tcfg, tparams = setup
    kw = dict(max_batch=4, max_len=64, block_size=8, n_blocks=13,
              kv_overcommit=2.0, kv_sanitize=True, victim_policy="fewest")
    je = JaxEngine(jcfg, jparams, use_pallas=False, **kw)
    te = Engine(tcfg, tparams, device="cpu", **kw)
    assert je._kv_probe and te._kv_probe
    j_out = _churn(je, JaxRequest, jcfg.vocab)
    t_out = _churn(te, ServeRequest, tcfg.vocab)
    assert t_out == j_out
    j_st, t_st = dataclasses.asdict(je.stats), dataclasses.asdict(te.stats)
    assert {k: t_st[k] for k in STATS} == {k: j_st[k] for k in STATS}
    assert t_st["preemptions"] >= 1


def test_bf16_pool_poison_trips():
    """The threshold is KV_POISON as the pool stores it. bf16 stores 1e9
    as 998,244,352: ``float(torch.tensor(KV_POISON,
    dtype=torch.bfloat16)) < KV_POISON``, so the reference's ``worst <
    KV_POISON`` check never fires on a bf16 cache; the port's does."""
    stored = float(torch.tensor(KV_POISON, dtype=torch.bfloat16))
    assert stored == 998244352.0 and stored < KV_POISON
    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(),
                              dtype="bfloat16")
    params = build_model(cfg, device="cpu").init(seed=0)
    eng = Engine(cfg, params, device="cpu", max_batch=2, max_len=64,
                 block_size=8, kv_sanitize=True)
    assert eng.cache["k"].dtype == torch.bfloat16
    req = ServeRequest(prompt=[1, 2, 3, 4, 5, 6], max_new_tokens=8)
    assert eng.admit(req)
    eng.step()
    slot = next(i for i, r in enumerate(eng.slots) if r is req)
    eng.cache["v"][:, int(eng.bm.table[slot, 0])] = KV_POISON
    with pytest.raises(KVSanitizerError, match="poisoned KV block"):
        eng.step()


def test_chunk_probe_skips_pad_columns_of_a_reused_block(setup):
    """A chunked prompt admitted into blocks a finished request released
    (and the sanitizer poisoned): its last chunk's pad columns would read
    the poisoned tail of its last block, past the prompt's end. The JAX
    engine probes pad columns and raises on this clean run; the port
    probes the real columns, does not raise, and emits the tokens of the
    unsanitized JAX engine."""
    jcfg, jparams, tcfg, tparams = setup
    kw = dict(max_batch=2, max_len=64, block_size=8, prefill_chunk=8,
              victim_policy="fewest")

    def run(eng, Req, expect_raise=False):
        first = Req(prompt=list(range(1, 40)), max_new_tokens=20)
        eng.admit(first)
        eng.drain()
        req = Req(prompt=list(range(3, 44)), max_new_tokens=4)
        eng.admit(req)
        if expect_raise:
            with pytest.raises(Exception, match="poisoned KV block"):
                eng.drain()
            return None
        eng.drain()
        return [list(first.generated), list(req.generated)]
    run(JaxEngine(jcfg, jparams, use_pallas=False, kv_sanitize=True, **kw),
        JaxRequest, expect_raise=True)
    ref = run(JaxEngine(jcfg, jparams, use_pallas=False, **kw), JaxRequest)
    te = Engine(tcfg, tparams, device="cpu", kv_sanitize=True, **kw)
    assert run(te, ServeRequest) == ref
    assert te.stats.chunk_direct > 0


def test_probe_kernel_refuses_cpu_tensors():
    """The probe's kernel wrapper raises on a CPU tensor instead of falling
    back; ``ops`` routes a CPU tensor to the plain version, counting no
    launch."""
    from repro_torch.kernels import kv_probe as kvp
    rng = np.random.RandomState(5)
    pk, pv, tbl = (torch.from_numpy(x) for x in _pool(rng, 1, 2, 8, 2, 16))
    with pytest.raises(ValueError):
        kvp.kv_probe(pk, pv, tbl, 5, 1, 4)
    q = torch.from_numpy(rng.randn(1, 1, 4, 16).astype(np.float32))
    n0 = kvp.launch_counts["kv_probe"]
    _, pmax = ops.decode_attention_paged(q, pk, pv, tbl, 5, probe=True)
    assert kvp.launch_counts["kv_probe"] == n0
    assert torch.equal(pmax, kv_probe_plain(pk, pv, tbl, 5, 1, 4))
