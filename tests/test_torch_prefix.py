"""Prefix-sharing KV in the port (``repro_torch.serving.prefix_index``,
``LM.prefill_suffix``, ``Engine(prefix_share=True)``) against the JAX
package, on the CPU.

Every case runs both packages on the same inputs: the reduced
internlm2-1.8b (fp32) with JAX params and the port's params converted from
them (``params_from_jax``), the JAX engines with ``use_pallas=False`` and
the port's with ``device="cpu"``, the same requests (ids included) and the
same traffic. Tokens, every ``EngineStats`` field (the retrace counters
too), the block manager's and the index's state and the store's accounting
must be identical (``==``); logits and pool K/V agree at the reference's
fp32 kernel tolerance (2e-5). Each case keeps the checks of the reference
test it mirrors in tests/test_kv_prefix.py: the block manager's refcounts,
sharing and copy-on-write, the radix index (match, cap, invalidation, the
hit-count LRU of partial tails), the engine's byte identity with sharing
off, boundary and deferred copy-on-write, survival past completion,
seeded churn with ``check_no_leak`` every round, grow hysteresis and
admission headroom, and prefix publication / warm-up with its recompute
fallback (the server's publication and warm-up cases are in
tests/test_torch_server.py). Then the sanitized suffix dispatch: it trips
where the reference trips, and a case shows the one deliberate
difference (ROADMAP.md section C): the port probes a suffix's real
columns, the reference its pad columns too.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as jax_serving
import repro_torch.serving as serving
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.serving.kv_blocks import BlockManager as JaxBlockManager
from repro.serving.prefix_index import PrefixIndex as JaxPrefixIndex
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.kv_blocks import KV_POISON, BlockManager
from repro_torch.serving.prefix_index import PrefixIndex

ATOL = RTOL = 2e-5          # the reference's fp32 kernel tolerance


@functools.lru_cache(maxsize=None)
def _pkgs():
    """The two packages' serving API, config and params (reduced
    internlm2-1.8b, fp32; the port's params converted from the JAX init)."""
    jcfg = jax_config("internlm2-1.8b").reduced()
    jparams = jax_build(jcfg, remat=False, attn_chunk=0).init(
        jax.random.PRNGKey(0))
    tcfg = get_config("internlm2-1.8b").reduced()
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    names = ("Engine", "ServeRequest")
    return {
        "jax": types.SimpleNamespace(
            name="jax", cfg=jcfg, params=jparams, BlockManager=JaxBlockManager,
            PrefixIndex=JaxPrefixIndex, eng_kw={"use_pallas": False},
            **{k: getattr(jax_serving, k) for k in names}),
        "torch": types.SimpleNamespace(
            name="torch", cfg=tcfg, params=tparams, BlockManager=BlockManager,
            PrefixIndex=PrefixIndex, eng_kw={"device": "cpu"},
            **{k: getattr(serving, k) for k in names})}


def _both(case, *args):
    """``case(P, *args)`` in each package; the two results must be equal.
    Returns the port's."""
    out = {name: case(P, *args) for name, P in _pkgs().items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


def _engine(P, **kw):
    kw.setdefault("victim_policy", "fewest")
    return P.Engine(P.cfg, P.params, **P.eng_kw, **kw)


def _reqs(P, prompts, n_new, rid0=0):
    n_new = n_new if isinstance(n_new, list) else [n_new] * len(prompts)
    return [P.ServeRequest(prompt=list(p), max_new_tokens=m, rid=rid0 + i)
            for i, (p, m) in enumerate(zip(prompts, n_new))]


def _bm_state(bm):
    return dict(table=bm.table.tolist(), free=list(bm._free),
                refcount=sorted((b, c) for b, c in bm.refcount.items() if c),
                indexed=sorted(bm.indexed), mapped=sorted(bm._mapped.items()),
                in_use=bm.blocks_in_use(), committed=bm.committed_blocks(),
                no_leak=bm.check_no_leak())


def _idx_state(idx):
    return dict(full=sorted(idx._full.items()),
                partial=sorted((k, sorted(v)) for k, v in
                               idx._partial.items()),
                hits=sorted(idx.hits.items()), pstat=sorted(
                    idx._pstat.items()), hot=idx.hot(1), n=len(idx))


# -- block manager and index: tests/test_kv_prefix.py:47-164 ---------------------

def _refcount_share_and_free(P):
    bm = P.BlockManager(n_blocks=9, block_size=4, max_slots=4,
                        max_blocks_per_slot=6)
    assert bm.reserve(0, 12)
    donor = bm.slot_blocks(0)
    assert all(bm.refcount[b] == 1 for b in donor)
    assert bm.reserve(1, 12, shared=donor[:2])
    assert all(bm.refcount[b] == 2 for b in donor[:2])
    assert bm.slot_blocks(1)[:2] == donor[:2]
    assert bm.shared_blocks(1) == 2 and bm.blocks_in_use() == 4
    mid = _bm_state(bm)
    assert bm.free(0) == 1                    # only its private block
    assert all(bm.refcount[b] == 1 for b in donor[:2])
    assert bm.free(1) == 3
    assert bm.blocks_in_use() == 0 and bm.blocks_free() == 8
    return mid, _bm_state(bm)


def _share_reclaims_free_blocks(P):
    bm = P.BlockManager(n_blocks=9, block_size=4, max_slots=4,
                        max_blocks_per_slot=6)
    assert bm.reserve(0, 8)
    donor = bm.slot_blocks(0)
    bm.free(0)
    assert all(b in bm._free for b in donor)
    assert bm.reserve(1, 12, shared=donor)
    assert bm.slot_blocks(1)[:2] == donor     # same ids, same content
    assert all(bm.refcount[b] == 1 for b in donor)
    return _bm_state(bm)


def _cow_boundary_dest(P):
    bm = P.BlockManager(n_blocks=6, block_size=4, max_slots=4,
                        max_blocks_per_slot=5)
    assert bm.reserve(0, 6)
    full, boundary = bm.slot_blocks(0)
    bm.free(0)
    assert bm.reserve(1, 10, shared=[full], boundary=boundary)
    ids = bm.slot_blocks(1)
    assert ids[0] == full and ids[1] != boundary and boundary in bm._free
    return _bm_state(bm)


def _committed_ledger(P):
    bm = P.BlockManager(n_blocks=9, block_size=4, max_slots=8,
                        max_blocks_per_slot=8)
    assert bm.reserve(0, 16, 8)
    assert bm.outstanding_blocks() == 2
    assert bm.committed_blocks() == bm.blocks_for(16) == 4
    assert bm.grow(0, 12)
    assert bm.committed_blocks() == 4
    donor = bm.slot_blocks(0)
    assert bm.reserve(1, 16, 12, shared=donor[:2])
    assert bm.committed_blocks() == 6
    return _bm_state(bm)


def _index_match_and_cap(P):
    bm = P.BlockManager(n_blocks=12, block_size=4, max_slots=4,
                        max_blocks_per_slot=8)
    idx = P.PrefixIndex(4, bm)
    toks = list(range(1, 11))                 # 2 full blocks + tail 2
    assert bm.reserve(0, len(toks))
    idx.insert(toks, bm.slot_blocks(0))
    ids = bm.slot_blocks(0)
    matches = []
    for q in (toks[:8] + [99, 98, 97], toks[:9] + [55, 54], toks[:8]):
        m = idx.match(q)
        matches.append((m.n_tokens, m.full, m.boundary, m.boundary_tokens))
    assert matches[0] == (8, ids[:2], None, 0)
    assert matches[1] == (9, ids[:2], ids[2], 1)
    assert matches[2][0] == 4                 # capped: one token prefills
    assert bm.reserve(1, len(toks))
    idx.insert(toks, bm.slot_blocks(1))       # the first entry wins
    assert idx.match(toks[:8] + [99]).full == ids[:2]
    return matches, _idx_state(idx), _bm_state(bm)


def _index_invalidation(P):
    bm = P.BlockManager(n_blocks=12, block_size=4, max_slots=4,
                        max_blocks_per_slot=8)
    idx = P.PrefixIndex(4, bm)
    toks = list(range(1, 13))                 # 3 full blocks
    assert bm.reserve(0, len(toks))
    ids = bm.slot_blocks(0)
    idx.insert(toks, ids)
    assert ids[1] in bm.indexed
    idx.invalidate_block(ids[1])              # drops depths 2 and 3
    assert idx.match(toks + [99]).n_tokens == 4
    assert ids[1] not in bm.indexed
    return _idx_state(idx), _bm_state(bm)


def _partial_lru(P):
    bm = P.BlockManager(n_blocks=32, block_size=4, max_slots=16,
                        max_blocks_per_slot=8)
    idx = P.PrefixIndex(4, bm, max_partials=2)
    base = [1, 2, 3, 4]
    assert bm.reserve(0, 6)
    idx.insert(base + [7, 8], bm.slot_blocks(0))
    hot_bid = bm.slot_blocks(0)[1]
    for _ in range(3):
        m = idx.match(base + [7, 8, 9])
        assert m.boundary == hot_bid and m.boundary_tokens == 2
    for i in range(1, 5):                     # one-off tails churn the cap
        assert bm.reserve(i, 6)
        idx.insert(base + [30 + i, 40 + i], bm.slot_blocks(i))
    assert len(idx._partial[tuple(base)]) == 2
    m = idx.match(base + [7, 8, 9])           # the hot tail survived
    assert m is not None and m.boundary == hot_bid
    assert bm.reserve(5, 6)
    idx.insert(base + [7, 8], bm.slot_blocks(5))
    assert len(idx._partial[tuple(base)]) == 2
    assert idx.match(base + [7, 8, 9]).boundary == hot_bid
    return _idx_state(idx), _bm_state(bm)


INDEX_CASES = {f.__name__.lstrip("_"): f for f in (
    _refcount_share_and_free, _share_reclaims_free_blocks,
    _cow_boundary_dest, _committed_ledger, _index_match_and_cap,
    _index_invalidation, _partial_lru)}


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_block_manager_and_index_match_jax(case):
    """Every match, insert, invalidation, hot-run decision and ledger
    state equals the reference's, the hit-count LRU of partial tails
    included."""
    _both(INDEX_CASES[case])


# -- LM.prefill_suffix ------------------------------------------------------------

def test_prefill_suffix_matches_jax():
    """Per-row bases that are not multiples of the block size (one at 0),
    ragged lengths whose pad columns go to the trash block, a shuffled
    table over a pool of random K/V: logits and every real block of the
    pool equal the reference's."""
    jp, tp = _pkgs()["jax"], _pkgs()["torch"]
    cfg = jp.cfg
    rng = np.random.RandomState(5)
    b, c, bs, mb = 4, 9, 4, 8
    n_blocks = 1 + b * mb
    shape = (cfg.n_layers, n_blocks, bs, cfg.n_kv_heads, cfg.hd)
    pool_k = rng.randn(*shape).astype(np.float32)
    pool_v = rng.randn(*shape).astype(np.float32)
    tbl = (rng.permutation(b * mb).reshape(b, mb) + 1).astype(np.int32)
    bases = np.array([0, 5, 13, 22], np.int32)
    lens = np.array([9, 3, 7, 1], np.int32)
    tokens = rng.randint(1, cfg.vocab, (b, c)).astype(np.int32)

    jm = jax_build(jp.cfg, remat=False, attn_chunk=0)
    jcache = jm.init_cache(b, mb * bs, vector_pos=True, kv_layout="paged",
                           n_blocks=n_blocks, block_size=bs)
    jcache = dict(jcache, k=jnp.asarray(pool_k), v=jnp.asarray(pool_v))
    jlog, jout = jm.prefill_suffix(jp.params, jcache, jnp.asarray(tokens),
                                   jnp.asarray(bases), jnp.asarray(tbl),
                                   jnp.asarray(lens))
    tm = build_model(tp.cfg, device="cpu")
    tcache = tm.init_cache(b, mb * bs, kv_layout="paged", n_blocks=n_blocks,
                           block_size=bs)
    tcache["k"].copy_(torch.from_numpy(pool_k))
    tcache["v"].copy_(torch.from_numpy(pool_v))
    tlog, tout = tm.prefill_suffix(
        tp.params, tcache, torch.from_numpy(tokens), torch.from_numpy(bases),
        torch.from_numpy(tbl), torch.from_numpy(lens))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=RTOL)
    for key in ("k", "v"):           # block 0 is the pad columns' trash
        np.testing.assert_allclose(tout[key][:, 1:].numpy(),
                                   np.asarray(jout[key])[:, 1:], atol=ATOL,
                                   rtol=RTOL)
        assert not np.array_equal(tout[key][:, 1:].numpy(),
                                  (pool_k if key == "k" else pool_v)[:, 1:])


def test_prefill_suffix_refuses_recurrent_families():
    cfg = get_config("mamba2-1.3b").reduced()
    m = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="attention-family"):
        m.prefill_suffix({}, {}, torch.zeros((1, 2), dtype=torch.int32),
                         torch.zeros(1), torch.zeros((1, 1)), torch.ones(1))


# -- engine: tests/test_kv_prefix.py:176-317 --------------------------------------

def _drain(eng, reqs, rounds=500, check_leak=False):
    """Admit and step until every request is done, re-queueing (recompute)
    whatever the pool preempts."""
    queue = list(reqs)
    for _ in range(rounds):
        if not (queue or eng.active() or eng._pending or eng._preempted):
            break
        if queue:
            adm = eng.admit_many(queue)
            taken = {id(r) for r in adm}
            queue = [r for r in queue if id(r) not in taken]
        eng.step()
        for req, _ in eng.take_preempted():
            queue.insert(0, req)
        if check_leak:
            assert eng.bm.check_no_leak()
    assert all(r.done for r in reqs)


def _outcome(eng, reqs):
    return dict(tokens=[list(r.generated) for r in reqs],
                stats=dataclasses.asdict(eng.stats),
                blocks=eng.block_stats(),
                bm=_bm_state(eng.bm) if eng.bm is not None else None,
                index=(_idx_state(eng._prefix) if eng._prefix is not None
                       else None))


def _share_pair(P, prompts, max_new=4, **kw):
    """The same workload with sharing off and on; the tokens must agree.
    Returns both outcomes."""
    outs = []
    for share in (False, True):
        eng = _engine(P, max_batch=8, max_len=64, kv_layout="paged",
                      block_size=4, prefix_share=share, **kw)
        reqs = _reqs(P, prompts, max_new)
        _drain(eng, reqs)
        assert eng.bm.check_no_leak()
        outs.append(_outcome(eng, reqs))
    assert outs[0]["tokens"] == outs[1]["tokens"]
    return outs


BASE = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]      # 3 full blocks of 4


def _byte_identity(P):
    off, on = _share_pair(P, [BASE + [10 + i, 20 + i] for i in range(4)])
    st = on["stats"]
    assert st["prefix_hits"] == 3 and st["prefix_shared_tokens"] == 36
    assert st["cow_copies"] == 0
    return off, on


def _deferred_cow(P):
    """Sharers diverging inside the donor's partial boundary block, all
    admitted in the donor's call: every copy waits for the suffix
    dispatch (the donor prefills first)."""
    donor = BASE[:8] + [7, 7]
    prompts = [donor] + [BASE[:8] + [7, 30 + i, 40 + i] for i in range(3)]
    off, on = _share_pair(P, prompts)
    st = on["stats"]
    assert st["cow_copies"] == 3 and st["prefix_hits"] == 3
    return off, on


def _later_cow(P):
    """The donor is drained first; a later call's sharers copy its
    (freed, still indexed) boundary block at admission."""
    eng = _engine(P, max_batch=4, max_len=64, kv_layout="paged",
                  block_size=4, prefix_share=True)
    donor = _reqs(P, [BASE[:8] + [7, 7]], 3)
    _drain(eng, donor)
    sharers = _reqs(P, [BASE[:8] + [7, 30 + i, 40 + i] for i in range(3)],
                    3, rid0=1)
    _drain(eng, sharers)
    assert eng.stats.cow_copies == 3 and eng.stats.prefix_hits == 3
    ref = _engine(P, max_batch=4, max_len=64, kv_layout="paged",
                  block_size=4)
    plain = _reqs(P, [r.prompt for r in sharers], 3, rid0=1)
    _drain(ref, plain)
    assert [r.generated for r in sharers] == [r.generated for r in plain]
    return _outcome(eng, donor + sharers)


def _survives_completion(P):
    eng = _engine(P, max_batch=4, max_len=64, kv_layout="paged",
                  block_size=4, prefix_share=True)
    r1 = _reqs(P, [BASE + [10, 11]], 3)
    _drain(eng, r1)
    assert eng.bm.blocks_in_use() == 0             # wave 1 fully freed
    r2 = _reqs(P, [BASE + [20 + i, 21] for i in range(3)], 3, rid0=1)
    _drain(eng, r2)
    assert eng.stats.prefix_hits == 3
    ref = _engine(P, max_batch=4, max_len=64, kv_layout="paged",
                  block_size=4)
    rr = _reqs(P, [r.prompt for r in r2], 3, rid0=1)
    _drain(ref, rr)
    assert [r.generated for r in r2] == [r.generated for r in rr]
    return _outcome(eng, r1 + r2)


def _seeded_churn(P):
    rng = np.random.RandomState(0)
    vocab = P.cfg.vocab
    base = [int(t) for t in rng.randint(1, vocab, size=10)]
    prompts = []
    for _ in range(12):
        cut = int(rng.choice([4, 8, 10]))          # full / partial overlap
        prompts.append(base[:cut] + [int(t) for t in
                                     rng.randint(1, vocab, size=12 - cut)])
    outs = []
    for share in (False, True):
        eng = _engine(P, max_batch=4, max_len=64, kv_layout="paged",
                      block_size=4, n_blocks=17, kv_overcommit=1.5,
                      prefix_share=share)
        reqs = _reqs(P, prompts, [3 + (i % 5) for i in range(12)])
        _drain(eng, reqs, check_leak=True)
        assert eng.bm.blocks_in_use() == 0
        outs.append(_outcome(eng, reqs))
    assert outs[0]["tokens"] == outs[1]["tokens"]
    assert outs[1]["stats"]["prefix_hits"] > 0
    return outs


def _grow_hysteresis(P):
    outs = {}
    for k in (1, 4):
        eng = _engine(P, max_batch=2, max_len=64, kv_layout="paged",
                      block_size=4, grow_ahead=k)
        reqs = _reqs(P, [[7, 3, 5, 2, 9, 1]], 20)
        _drain(eng, reqs)
        outs[k] = _outcome(eng, reqs)
    assert outs[1]["tokens"] == outs[4]["tokens"]
    assert outs[4]["stats"]["grow_ahead_skips"] > 0
    assert outs[1]["stats"]["grow_ahead_skips"] == 0
    return outs


def _admit_headroom(P):
    out = {}
    for headroom in (True, False):
        eng = _engine(P, max_batch=4, max_len=32, kv_layout="paged",
                      block_size=4, n_blocks=9, kv_overcommit=2.0,
                      admit_headroom=headroom)
        a, b = _reqs(P, [[5, 4, 3, 2, 1, 6, 7], [11] * 24], [9, 4])
        assert eng.admit_many([a])
        assert a.ctx_len == 8                      # boundary on next decode
        queue = [b]
        for _ in range(60):
            if a.done and b.done:
                break
            adm = eng.admit_many(queue)
            taken = {id(r) for r in adm}
            queue = [r for r in queue if id(r) not in taken]
            eng.step()
            for req, _ in eng.take_preempted():
                queue.insert(0, req)
        assert a.done and b.done and eng.bm.check_no_leak()
        out[headroom] = _outcome(eng, [a, b])
    on, off = out[True]["stats"], out[False]["stats"]
    assert on["admit_deferred"] > 0 and on["preemptions"] == 0
    assert off["admit_deferred"] == 0 and off["preemptions"] > 0
    assert out[True]["tokens"] == out[False]["tokens"]
    return out


ENGINE_CASES = {f.__name__.lstrip("_"): f for f in (
    _byte_identity, _deferred_cow, _later_cow, _survives_completion,
    _seeded_churn, _grow_hysteresis, _admit_headroom)}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_prefix_engine_matches_jax(case):
    """Tokens, every EngineStats field (``prefix_hits``,
    ``prefix_shared_tokens``, ``cow_copies``, ``retraces`` and
    ``prefill_retraces`` included), ``block_stats``, the block manager's
    ledger and the prefix index equal the JAX engine's."""
    _both(ENGINE_CASES[case])


def test_prefix_share_constructor_rules():
    """The combinations the reference refuses raise its ValueError; the
    rest construct (sanitizer armed with prefix sharing included)."""
    P = _pkgs()["torch"]
    eng = _engine(P, max_batch=2, max_len=64, prefix_share=True,
                  kv_sanitize=True)
    assert eng.kv_layout == "paged" and eng._prefix is not None
    assert eng._kv_probe and eng.bm.on_reuse == eng._prefix.invalidate_block
    for kw in (dict(kv_layout="contig"), dict(admission="legacy"),
               dict(admission="legacy", kv_layout="paged")):
        for name, Q in _pkgs().items():
            with pytest.raises(ValueError):
                _engine(Q, max_batch=2, max_len=64, prefix_share=True, **kw)


# -- publication and warm-up: tests/test_kv_prefix.py:323-408 --------------------

def _export_and_warm(P):
    """``hot_runs`` / ``export_prefix`` / ``hot_prefixes`` on a donor
    engine, then ``warm_prefix`` into a cold one, whose first request
    maps the warmed blocks; the payloads are returned as numpy."""
    eng = _engine(P, max_batch=4, max_len=64, kv_layout="paged",
                  block_size=4, prefix_share=True)
    _drain(eng, _reqs(P, [BASE + [10 + i, 20 + i] for i in range(4)], 3))
    runs = eng.hot_runs(2)
    assert runs == [tuple(BASE)]
    pays = eng.hot_prefixes(2)
    assert len(pays) == 1 and pays[0]["tokens"] == BASE
    cold = _engine(P, max_batch=4, max_len=64, kv_layout="paged",
                   block_size=4, prefix_share=True)
    assert cold.warm_prefix(pays[0])
    assert not cold.warm_prefix(pays[0])         # already resident
    assert cold.bm.blocks_in_use() == 0          # warm blocks stay free
    reqs = _reqs(P, [BASE + [7, 9]], 3, rid0=10)
    _drain(cold, reqs)
    assert cold.stats.prefix_hits == 1 and cold.stats.prefix_warmups == 1
    kv = {k: np.asarray(pays[0][k]) for k in ("k", "v")}
    return runs, kv, _outcome(eng, []), _outcome(cold, reqs)


def test_export_and_warm_prefix_match_jax():
    out = {name: _export_and_warm(P) for name, P in _pkgs().items()}
    (jr, jkv, jeng, jcold), (tr, tkv, teng, tcold) = out["jax"], out["torch"]
    assert (tr, teng, tcold) == (jr, jeng, jcold)
    for k in ("k", "v"):
        np.testing.assert_allclose(tkv[k], jkv[k], atol=ATOL, rtol=RTOL)


def _fallback(P):
    eng = _engine(P, max_batch=2, max_len=64, kv_layout="paged",
                  block_size=4, prefix_share=True)
    bad = [{"arch": "other", "block_size": 4, "tokens": [1, 2, 3, 4],
            "k": None, "v": None},
           {"arch": P.cfg.name, "block_size": 8, "tokens": [1, 2, 3, 4],
            "k": None, "v": None},
           {"arch": P.cfg.name, "block_size": 4, "tokens": [1, 2, 3],
            "k": None, "v": None}]
    assert not any(eng.warm_prefix(p) for p in bad)
    plain = _engine(P, max_batch=2, max_len=64, kv_layout="paged",
                    block_size=4)
    assert plain.hot_runs() == [] and plain.hot_prefixes() == []
    assert plain.export_prefix(BASE) is None
    assert not plain.warm_prefix({"arch": P.cfg.name, "block_size": 4,
                                  "tokens": BASE, "k": None, "v": None})
    reqs = _reqs(P, [[1, 2, 3, 4, 5]], 4)
    _drain(eng, reqs)
    return _outcome(eng, reqs)


def test_warm_prefix_recompute_fallback_matches_jax():
    """Incompatible payloads (arch, block size, shorter than a block) and
    an engine without an index leave warm-up on the recompute path."""
    _both(_fallback)


# -- the sanitized suffix dispatch ------------------------------------------------

def _sanitized_engine(P):
    return _engine(P, max_batch=4, max_len=64, kv_layout="paged",
                   block_size=4, prefix_share=True, kv_sanitize=True)


def _plant_and_admit(P, where):
    """A donor is drained, then poison is planted in one of its indexed
    (still shared) blocks: the first block, which a sharer's suffix
    reads ("read"), or the donor's last full block, past the sharer's
    shared prefix ("unread"). Returns the message of the error the
    sharer's admission raised, or its tokens."""
    eng = _sanitized_engine(P)
    donor = _reqs(P, [BASE + [10, 11]], 3)
    _drain(eng, donor)
    ids = eng._prefix.full_run(BASE)
    target = ids[0] if where == "read" else ids[2]
    if P.name == "jax":
        eng.cache["k"] = eng.cache["k"].at[:, target].set(KV_POISON)
    else:
        eng.cache["k"][:, target] = KV_POISON
    sharer = _reqs(P, [BASE[:8] + [40, 41, 42]], 3, rid0=1)
    try:
        _drain(eng, sharer)
    except Exception as e:                        # noqa: BLE001
        assert eng.stats.prefix_hits == 1
        assert not sharer[0].generated            # raised before commit
        return "raised" if "poisoned KV block" in str(e) else str(e)
    return [list(r.generated) for r in donor + sharer]


@pytest.mark.parametrize("where", ["read", "unread"])
def test_sanitized_suffix_trips_where_jax_trips(where):
    """Poison in a shared block the suffix dispatch reads raises at that
    dispatch, before the first token is committed, in both packages; in a
    shared block it does not read, neither raises and the tokens agree."""
    out = _both(_plant_and_admit, where)
    assert (out == "raised") == (where == "read")


def test_suffix_probe_skips_pad_columns():
    """A suffix admitted into blocks a finished request released (and the
    sanitizer poisoned): the pad columns of its power-of-2 bucket read the
    poisoned, never-written tail of its last block. The JAX engine probes
    pad columns and raises on this clean run; the port probes the real
    columns, does not raise, and emits the unsanitized JAX engine's
    tokens."""
    def run(P, sanitize):
        eng = _engine(P, max_batch=2, max_len=64, kv_layout="paged",
                      block_size=4, prefix_share=True, kv_sanitize=sanitize)
        # the donor's 16 decode-grown blocks are not indexed: released and
        # (sanitize) poisoned, they are the next fresh blocks handed out
        donor = _reqs(P, [BASE + [10, 11]], 40)
        _drain(eng, donor)
        sharer = _reqs(P, [BASE + list(range(50, 59))], 3, rid0=1)
        eng.admit_many(sharer)
        eng.drain()
        return [list(r.generated) for r in donor + sharer], eng.stats
    jp, tp = _pkgs()["jax"], _pkgs()["torch"]
    with pytest.raises(Exception, match="poisoned KV block"):
        run(jp, True)
    ref, jst = run(jp, False)
    out, tst = run(tp, True)
    assert out == ref and tst.prefix_hits == jst.prefix_hits == 1
    # the suffix (9 tokens) is padded to the 16-token bucket
    assert tst.prefix_shared_tokens == 12
