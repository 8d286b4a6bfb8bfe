"""Engine parity: the port's Engine (``repro_torch``, plain PyTorch on the
CPU) against the JAX reference Engine (``use_pallas=False``,
``victim_policy="fewest"``) on the same params and requests.

Greedy tokens must be identical and the scheduling counters equal, on
scenarios mirrored from tests/test_engine_v2.py, tests/test_kv_lazy.py and
tests/test_chunk_prefill.py: batched vs solo admission, more requests than
slots, chunked prefill interleaving with decode, lazy grow, overcommit
preemption with KV re-attach, and skip-ahead admission on the paged
layout; batched, more-than-slots and chunked (transient group cache plus
finisher scatters) admission on the contiguous layout; and the MoE family
(granite-moe, phi3.5-moe) on its auto (contiguous) layout with batch-1
exact-length admission.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.serving import Engine as JaxEngine
from repro.serving import ServeRequest as JaxRequest
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import Engine, ServeRequest

STATS = ("prefills", "prefill_batches", "prefill_chunks", "chunk_direct",
         "chunk_scatters", "block_grows", "preemptions", "kv_imports",
         "alloc_failures", "decode_steps", "tokens_out", "admit_deferred")


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


def _engines(setup, **kw):
    jcfg, jparams, tcfg, tparams = setup
    je = JaxEngine(jcfg, jparams, use_pallas=False, victim_policy="fewest",
                   **kw)
    te = Engine(tcfg, tparams, device="cpu", victim_policy="fewest", **kw)
    return (je, JaxRequest), (te, ServeRequest)


# -- scenarios: each takes (engine, request class) and returns the requests --

def _batched(eng, Req):
    rs = [Req(prompt=list(range(1, 4 + 3 * i)), max_new_tokens=4 + i)
          for i in range(5)]
    assert len(eng.admit_many(rs)) == 5
    eng.drain()
    return rs


def _more_than_slots(eng, Req):
    rs = [Req(prompt=[1 + i, 2, 3], max_new_tokens=3) for i in range(5)]
    assert len(eng.admit_many(rs)) == 2
    assert len(eng.drain()) == 2
    left = rs[2:]
    while left:
        adm = eng.admit_many(left)
        taken = {id(r) for r in adm}
        left = [r for r in left if id(r) not in taken]
        eng.drain()
    return rs


def _chunk_interleave(eng, Req):
    live = Req(prompt=[3, 1, 4], max_new_tokens=20)
    eng.admit(live)
    long_req = Req(prompt=list(range(1, 41)), max_new_tokens=4)
    eng.admit(long_req)
    before = len(live.generated)
    for _ in range(3):
        eng.step()
    assert len(live.generated) == before + 3   # live slot never stalled
    assert not long_req.generated
    eng.drain()
    return [live, long_req]


def _staggered_chunks(eng, Req):
    rs = [Req(prompt=list(range(1 + i, 30 + 3 * i)), max_new_tokens=4 + i)
          for i in range(4)]
    eng.admit_many(rs[:2])
    eng.step()
    eng.admit_many(rs[2:])
    eng.drain()
    return rs


def _lazy_grow(eng, Req):
    rs = [Req(prompt=list(range(1, 4 + 3 * i)), max_new_tokens=12)
          for i in range(4)]
    eng.admit_many(rs)
    eng.drain()
    assert eng.bm.check_no_leak() and eng.bm.blocks_in_use() == 0
    return rs


def _preempt(eng, Req):
    rs = [Req(prompt=list(range(1, 10 + 2 * i)), max_new_tokens=20)
          for i in range(3)]
    assert len(eng.admit_many(rs)) == 3
    eng.drain()
    assert eng.bm.check_no_leak() and eng.bm.blocks_in_use() == 0
    return rs


def _preempt_chunked(eng, Req):
    rs = [Req(prompt=list(range(1, 28 + 4 * i)), max_new_tokens=12)
          for i in range(3)]
    assert len(eng.admit_many(rs)) == 3
    eng.drain()
    assert eng.bm.check_no_leak() and eng.bm.blocks_in_use() == 0
    return rs


def _skip_ahead(eng, Req):
    hog = Req(prompt=list(range(1, 25)), max_new_tokens=8)
    assert eng.admit(hog)
    big = Req(prompt=list(range(1, 33)), max_new_tokens=8)
    smalls = [Req(prompt=[7, 8, 9], max_new_tokens=4) for _ in range(2)]
    admitted = eng.admit_many([big] + smalls)
    assert [r.rid for r in admitted] == [r.rid for r in smalls]
    eng.drain()
    assert eng.admit(big)
    eng.drain()
    return [hog, big] + smalls


SCENARIOS = {
    "batched": (_batched, dict(max_batch=8, max_len=64)),
    "more_than_slots": (_more_than_slots, dict(max_batch=2, max_len=64)),
    "chunk_interleave": (_chunk_interleave,
                         dict(max_batch=2, max_len=64, prefill_chunk=8)),
    "staggered_chunks": (_staggered_chunks,
                         dict(max_batch=4, max_len=64, prefill_chunk=8)),
    "lazy_grow": (_lazy_grow, dict(max_batch=4, max_len=64, block_size=8)),
    "upfront": (_lazy_grow, dict(max_batch=4, max_len=64, block_size=8,
                                 kv_alloc="upfront")),
    "preempt": (_preempt, dict(max_batch=4, max_len=64, block_size=8,
                               n_blocks=11, kv_overcommit=2.5)),
    "preempt_chunked": (_preempt_chunked, dict(max_batch=4, max_len=64,
                                       block_size=8, prefill_chunk=8,
                                       n_blocks=15, kv_overcommit=2.5)),
    "skip_ahead": (_skip_ahead, dict(max_batch=4, max_len=64, block_size=8,
                                     n_blocks=9)),
}


def _run_both(setup, scenario, kw):
    (je, JReq), (te, TReq) = _engines(setup, **kw)
    jreqs = scenario(je, JReq)
    treqs = scenario(te, TReq)
    assert [list(r.generated) for r in treqs] == \
        [list(r.generated) for r in jreqs]
    assert all(r.done for r in treqs)
    for field in STATS:
        assert getattr(te.stats, field) == getattr(je.stats, field), field
    assert te.kv_layout == je.kv_layout and te._group == je._group
    return je, te


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_matches_jax(setup, name):
    scenario, kw = SCENARIOS[name]
    _, te = _run_both(setup, scenario, kw)
    if name in ("preempt", "preempt_chunked"):
        assert te.stats.preemptions >= 1 and te.stats.kv_imports >= 1
    if name == "lazy_grow":
        assert te.stats.block_grows >= 1 and te.stats.preemptions == 0
    if "chunk" in name:
        assert te.stats.chunk_direct > 0


CONTIG = dict(kv_layout="contig")
CONTIG_SCENARIOS = {
    "batched": (_batched, dict(max_batch=8, max_len=64, **CONTIG)),
    "more_than_slots": (_more_than_slots,
                        dict(max_batch=2, max_len=64, **CONTIG)),
    "chunk_interleave": (_chunk_interleave,
                         dict(max_batch=2, max_len=64, prefill_chunk=8,
                              **CONTIG)),
    "staggered_chunks": (_staggered_chunks,
                         dict(max_batch=4, max_len=64, prefill_chunk=8,
                              **CONTIG)),
}


@pytest.mark.parametrize("name", sorted(CONTIG_SCENARIOS))
def test_contig_engine_matches_jax(setup, name):
    """Dense family on ``kv_layout="contig"``: no block manager, whole-row
    installs, and chunked groups through a transient cache whose finishers
    are scattered (``chunk_scatters``), token for token with the JAX
    engine."""
    scenario, kw = CONTIG_SCENARIOS[name]
    _, te = _run_both(setup, scenario, kw)
    assert te.bm is None and te.block_stats() == {}
    assert te.stats.chunk_direct == 0
    if "chunk" in name:
        assert te.stats.chunk_scatters > 0


MOE_SCENARIOS = {
    "batched": (_batched, dict(max_batch=8, max_len=64)),
    "more_than_slots": (_more_than_slots, dict(max_batch=2, max_len=64)),
    "long_prompts_not_chunked": (_staggered_chunks,
                                 dict(max_batch=4, max_len=64,
                                      prefill_chunk=8)),
}


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("name", sorted(MOE_SCENARIOS))
def test_moe_engine_matches_jax(arch, name):
    """MoE on ``kv_layout="auto"``: the contiguous layout, batch-1
    exact-length admission (never padded, never chunked), every row
    decoding with dead rows fed token 0 — token for token with the JAX
    engine, whose capacity drops depend on all of that."""
    scenario, kw = MOE_SCENARIOS[name]
    _, te = _run_both(_arch(arch), scenario, kw)
    assert te.kv_layout == "contig" and te._group == 1 and te.bm is None
    assert te.stats.prefill_chunks == 0
    assert te.stats.prefill_batches == te.stats.prefills


def test_moe_batched_matches_solo_in_port():
    """Batch-1 exact-length admission is what makes a MoE request's tokens
    independent of the requests admitted with it, as in the reference."""
    _, _, tcfg, tparams = _arch("phi3.5-moe-42b-a6.6b")
    eng = Engine(tcfg, tparams, device="cpu", max_batch=1, max_len=64)
    rs = [ServeRequest(prompt=list(range(1, 4 + 3 * i)),
                       max_new_tokens=4 + i) for i in range(3)]
    for r in rs:
        eng.admit(r)
        eng.drain()
    for r in rs:
        solo = Engine(tcfg, tparams, device="cpu", max_batch=1, max_len=64)
        r2 = ServeRequest(prompt=list(r.prompt),
                          max_new_tokens=r.max_new_tokens)
        solo.admit(r2)
        solo.drain()
        assert list(r2.generated) == list(r.generated)


def test_moe_refuses_the_paged_layout():
    _, _, tcfg, tparams = _arch("granite-moe-3b-a800m")
    with pytest.raises(ValueError):
        Engine(tcfg, tparams, device="cpu", kv_layout="paged")


def test_batched_matches_solo_in_port(setup):
    """Inside the port, as in the reference: a mixed-length batch gives the
    tokens of per-request solo runs (padding + masked scatter are exact)."""
    _, _, tcfg, tparams = setup
    eng = Engine(tcfg, tparams, device="cpu", max_batch=8, max_len=64)
    rs = _batched(eng, ServeRequest)
    for r in rs:
        solo = Engine(tcfg, tparams, device="cpu", max_batch=2, max_len=64)
        r2 = ServeRequest(prompt=list(r.prompt),
                          max_new_tokens=r.max_new_tokens)
        solo.admit(r2)
        solo.drain()
        assert list(r2.generated) == list(r.generated)


def test_retrace_count_bounded_by_buckets(setup):
    """Distinct prefill dispatch shapes stay within the bucket count across
    a mixed-length workload, as the reference's trace count does."""
    _, _, tcfg, tparams = setup
    eng = Engine(tcfg, tparams, device="cpu", max_batch=4, max_len=64)
    rng = np.random.RandomState(0)
    lens = [4, 7, 11, 15, 17, 23, 30, 33, 40, 47, 55, 60]
    for n in lens:
        r = ServeRequest(prompt=rng.randint(0, tcfg.vocab, n).tolist(),
                         max_new_tokens=1)
        assert eng.admit(r)
        eng.drain()
    assert eng.stats.prefills == len(lens)
    assert eng.stats.prefill_retraces <= len(eng.bucket_lens())


def test_unported_options_raise(setup):
    _, _, tcfg, tparams = setup
    for kw in (dict(victim_policy="cost"), dict(prefix_share=True)):
        with pytest.raises(NotImplementedError):
            Engine(tcfg, tparams, device="cpu", **kw)
    encdec = dataclasses.replace(tcfg, n_encoder_layers=2)   # not ported
    with pytest.raises(NotImplementedError):
        Engine(encdec, tparams, device="cpu")
