"""The port's global server and tensor store (``repro_torch.serving.server``,
``tensor_store``) and the engine's cost-aware preemption victim, against
the JAX package's, on the CPU.

Every case runs in both packages on the same inputs: the reduced
internlm2-1.8b (fp32) with JAX params and the port's params converted from
them (``params_from_jax``), the JAX engines with ``use_pallas=False`` and
the port's with ``device="cpu"``, requests with the same ids, and
placements built in each package from the same values. It returns what the
server or store left behind, and the two must be identical: the tokens,
migrations and virtual-clock stamps of every request, ``server.events``
(time, kind, detail), the clock, every pipeline's weight, round length,
liveness, queue and engine counters, and the store's keys (LRU order),
bytes, refcounts and residency. Each case also keeps the checks of the
reference test it mirrors: tests/test_serving.py (the server and store
cases), tests/test_engine_v2.py (interruption equivalence, requeue on a sole
pipeline, the estimator-driven clock), tests/test_kv_paging.py (KV migration
and the store's LRU budget), tests/test_kv_lazy.py (the cost victim, the
pinned-key ``take``, preempt -> publish -> attach, the publish budget),
tests/test_routing.py (bucket-aware and pricing-aware dispatch; prefix
affinity and hot-prefix pinning wait for the prefix index) and
tests/test_store_sanitizer.py.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro.hw as jax_hw
import repro.serving as jax_serving
import repro.serving.tensor_store as jax_ts
import repro_torch.core as core
import repro_torch.hw as hw
import repro_torch.serving as serving
import repro_torch.serving.tensor_store as ts
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax

STATS = ("prefills", "prefill_batches", "prefill_chunks", "chunk_direct",
         "chunk_scatters", "decode_steps", "tokens_out", "alloc_failures",
         "block_grows", "preemptions", "kv_exports", "kv_imports",
         "grow_ahead_skips", "admit_deferred")


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
    jax_pkg = types.SimpleNamespace(
        name="jax", cfg=jcfg, params=jparams, get_config=jax_config,
        core=jax_core, hw=jax_hw,
        ts=jax_ts, srv_kw={}, eng_kw={},
        ones=lambda shape: np.ones(shape, np.float32),
        zeros=lambda n: jnp.zeros((n,), jnp.float32),
        **{k: getattr(jax_serving, k) for k in (
            "Engine", "FTTimes", "GlobalServer", "ServeRequest",
            "TensorStore")})
    torch_pkg = types.SimpleNamespace(
        name="torch", cfg=tcfg, params=tparams, get_config=get_config,
        core=core, hw=hw, ts=ts,
        srv_kw={"device": "cpu"}, eng_kw={"device": "cpu"},
        ones=lambda shape: torch.ones(shape),
        zeros=lambda n: torch.zeros((n,)),
        **{k: getattr(serving, k) for k in (
            "Engine", "FTTimes", "GlobalServer", "ServeRequest",
            "TensorStore")})
    return {"jax": jax_pkg, "torch": torch_pkg}


def _server(P, store, **kw):
    return P.GlobalServer(P.cfg, store, **P.srv_kw, **kw)


def _engine(P, **kw):
    return P.Engine(P.cfg, P.params, **P.eng_kw, **kw)


def _reqs(P, prompts, n_new, rid0=0):
    return [P.ServeRequest(prompt=list(p), max_new_tokens=n_new, rid=rid0 + i)
            for i, p in enumerate(prompts)]


def _store_state(store):
    if store is None:
        return None
    return dict(keys=store.keys(), bytes=sorted(store._bytes.items()),
                refcount=sorted(store._refcount.items()),
                last_used=sorted(store._last_used.items()),
                hits=sorted(store._hits.items()),
                resident=store.resident_bytes(),
                consistent=store.check_consistent())


def _state(srv, reqs):
    """Everything a server run leaves behind that the two packages must
    agree on."""
    return dict(
        tokens=[list(r.generated) for r in reqs],
        migrations=[r.migrations for r in reqs],
        stamps=[(r.first_token_s, r.finish_s) for r in reqs],
        events=list(srv.events), clock=srv.clock,
        completed=[r.rid for r in srv.completed],
        pipes=[(p.pid, list(p.instance_ids), p.weight, p.alive,
                p.down_until, p.round_s, p.pricing,
                [r.rid for r in p.queue],
                [getattr(p.engine.stats, f) for f in STATS])
               for p in srv.pipelines],
        store=_store_state(srv.store))


def _solo(P, prompt, n, rid=1000, **kw):
    eng = _engine(P, max_batch=2, max_len=64, **kw)
    r = P.ServeRequest(prompt=list(prompt), max_new_tokens=n, rid=rid)
    eng.admit(r)
    eng.drain()
    return list(r.generated)


def _kinds(srv):
    return [k for _, k, _ in srv.events]


# -- test_serving.py ------------------------------------------------------------------

def _migration_preserves_output(P):
    prompt = [5, 17, 42, 7, 99]
    ref = _solo(P, prompt, 12)
    srv = _server(P, P.TensorStore(), max_batch=2, max_len=64)
    p0 = srv.add_pipeline(P.params, ["inst-A", "inst-B"])
    srv.add_pipeline(P.params, ["inst-C"])
    (r,) = _reqs(P, [prompt], 12)
    p0.queue.append(r)
    for _ in range(5):
        while p0.queue and p0.engine.free_slots():
            p0.engine.admit(p0.queue.pop(0))
        p0.engine.step()
    pre = list(r.generated)
    assert pre == ref[:len(pre)]
    srv.interrupt_instance("inst-A")
    assert not p0.alive and r.migrations == 1
    assert list(r.generated)[:len(pre)] == pre          # output preserved
    srv.run_until_drained()
    assert len(r.generated) == 12
    # continuation == recompute-from-full-context reference
    eng = _engine(P, max_batch=1, max_len=64)
    (r2,) = _reqs(P, [prompt], 12, rid0=1)
    r2.generated = list(pre)
    eng.admit(r2)
    eng.drain()
    assert list(r.generated) == list(r2.generated)
    return _state(srv, [r])


def _no_migration_loses_progress(P):
    srv = _server(P, P.TensorStore(), use_migration=False, max_batch=2,
                  max_len=64)
    p0 = srv.add_pipeline(P.params, ["inst-A"])
    srv.add_pipeline(P.params, ["inst-B"])
    (r,) = _reqs(P, [[1, 2, 3]], 8)
    p0.queue.append(r)
    while p0.queue and p0.engine.free_slots():
        p0.engine.admit(p0.queue.pop(0))
    p0.engine.step()
    assert len(r.generated) >= 1
    srv.interrupt_instance("inst-A")
    assert r.generated == []          # progress lost (No-Handle baseline)
    return _state(srv, [r])


def _concurrent_init_downtime(P):
    ft = P.FTTimes(grace_period_s=120.0)
    out = []
    for ci in (True, False):
        srv = _server(P, P.TensorStore(), ft=ft, use_concurrent_init=ci,
                      max_batch=2, max_len=64)
        p = srv.add_pipeline(P.params, ["i0"])
        srv.interrupt_instance("i0")
        out.append((p.down_until - srv.clock, _state(srv, [])))
    (d_ci, _), (d_plain, _) = out
    assert d_ci <= ft.grace_period_s + 1e-6
    assert d_plain > ft.grace_period_s + ft.store_load_s
    return out


def _weighted_round_robin(P, max_batch=4):
    srv = _server(P, None, max_batch=max_batch, max_len=64)
    p0 = srv.add_pipeline(P.params, ["a"], weight=3.0)
    p1 = srv.add_pipeline(P.params, ["b"], weight=1.0)
    for r in _reqs(P, [[1]] * 40, 1):
        srv.submit(r)
    assert len(p0.queue) == 30 and len(p1.queue) == 10
    return _state(srv, [])


def _zero_copy_attach(P):
    store = P.TensorStore()
    params = {"w": P.ones((4, 4))}
    store.put("m", "full", params)
    a = store.attach("m", "full")
    b = store.attach("m", "full")
    assert a["w"] is b["w"] is params["w"]          # same tensors, no copy
    assert store.refcount("m", "full") == 2
    store.detach("m", "full")
    store.detach("m", "full")
    assert store.evict_unreferenced() == 1
    assert not store.contains("m", "full")
    return _store_state(store)


def _load_once(P):
    loads = []
    store = P.TensorStore(load_time_model=lambda n: n * 1e-9)

    def loader():
        loads.append(1)
        return {"w": P.ones((8, 8))}
    _, t1 = store.load("m", "p0", loader)
    _, t2 = store.load("m", "p0", loader)
    assert len(loads) == 1            # second load is an attach
    assert t1 > 0 and t2 == 0.0
    return t1, [(r.key, r.cold) for r in store.loads], _store_state(store)


# -- test_engine_v2.py / test_kv_paging.py: interruption through the server -----------

PROMPTS = [[5, 17, 42, 7, 99], [1, 2, 3], [9, 8, 7, 6], [4, 4, 4]]


def _serve(P, interrupt_round, prompts, n_new, **server_kw):
    srv = _server(P, P.TensorStore(), max_batch=2, max_len=64, **server_kw)
    srv.add_pipeline(P.params, ["inst-A", "inst-B"])
    srv.add_pipeline(P.params, ["inst-C"])
    reqs = _reqs(P, prompts, n_new)
    for r in reqs:
        srv.submit(r)
    rounds = 0
    while srv.pending() and rounds < 10_000:
        if rounds == interrupt_round:
            srv.interrupt_instance("inst-A")
        srv.step()
        srv.tick()
        rounds += 1
    return srv, reqs


def _interruption_equivalence(P, prompts=PROMPTS, n_new=12, at=4, **kw):
    _, ref = _serve(P, -1, prompts, n_new)
    srv, out = _serve(P, at, prompts, n_new, **kw)
    assert sum(r.migrations for r in out) >= 1
    for r_ref, r_out in zip(ref, out):
        assert r_out.done
        assert list(r_out.generated) == list(r_ref.generated)
    return _state(srv, out)


def _interruption_chunked_recompute(P):
    return _interruption_equivalence(
        P, [[5, 17, 42, 7, 99, 3, 1, 2, 8, 11], [1, 2, 3, 4, 5, 6]], 14, 6,
        prefill_chunk=4)


def _single_pipeline_requeues(P):
    srv = _server(P, P.TensorStore(), max_batch=2, max_len=64)
    p0 = srv.add_pipeline(P.params, ["solo-inst"])
    reqs = _reqs(P, [[2, 3, 5], [3, 3, 5]], 6)
    for r in reqs:
        srv.submit(r)
    srv.step()
    affected = srv.interrupt_instance("solo-inst")
    assert len(affected) == 2 and len(p0.queue) == 2   # requeued, not dropped
    srv.run_until_drained()
    assert all(r.done and len(r.generated) == 6 for r in reqs)
    return _state(srv, reqs)


_PLAN = {}


def _llama_plan(P):
    """The first two paper-cluster pipelines of llama-3.1-70b, searched
    once per package."""
    if P.name not in _PLAN:
        insts = {n: dataclasses.replace(i, device=P.hw.effective(i.device))
                 for n, i in P.hw.AWS_INSTANCES.items()}
        spec = P.get_config("llama-3.1-70b").to_modelspec()
        _PLAN[P.name] = P.core.populate_cluster(
            spec, P.hw.paper_cluster(), insts, 763, 232, beam_k=1,
            max_pipelines=2)
    return _PLAN[P.name]


def _estimator_driven_clock(P):
    plan = _llama_plan(P)
    assert plan.pipelines
    srv = _server(P, None, max_batch=2, max_len=64)
    pipes = [srv.add_pipeline(P.params, [f"i{i}"], placement=pl)
             for i, pl in enumerate(plan.pipelines[:2])]
    for p in pipes:
        assert p.weight > 0 and p.round_s != 0.01 and p.round_s > 0
    t0 = srv.clock
    srv.step()
    srv.tick()
    assert srv.clock - t0 == max(p.round_s for p in pipes)
    for r in _reqs(P, [[1]] * 20, 1):
        srv.submit(r)
    if len(pipes) == 2 and pipes[0].weight != pipes[1].weight:
        q0, q1 = len(pipes[0].queue), len(pipes[1].queue)
        heavier = 0 if pipes[0].weight > pipes[1].weight else 1
        assert (q0, q1)[heavier] >= (q0, q1)[1 - heavier]
    return _state(srv, [])


def _default_round_s(P):
    srv = _server(P, None, max_batch=2, max_len=64)
    p = srv.add_pipeline(P.params, ["a"])
    assert p.weight == 1.0 and p.round_s == 0.01
    return _state(srv, [])


def _kv_migration_no_reprefill(P):
    _, ref = _serve(P, -1, PROMPTS, 12)
    srv, out = _serve(P, 4, PROMPTS, 12, use_kv_migration=True)
    kinds = _kinds(srv)
    assert kinds.count("kv_publish") >= 1
    assert kinds.count("kv_attach") == kinds.count("kv_publish")
    assert sum(p.engine.stats.kv_imports for p in srv.pipelines) \
        == kinds.count("kv_attach")
    assert sum(r.migrations for r in out) >= 1
    for r_ref, r_out in zip(ref, out):
        assert r_out.done and list(r_out.generated) == list(r_ref.generated)
    assert not [k for k in srv.store._store if k[0] == "__kv__"]
    return _state(srv, out)


def _kv_migration_contig_fallback(P):
    kw = dict(engine_kw={"kv_layout": "contig"})
    _, ref = _serve(P, -1, PROMPTS, 12, **kw)
    srv, out = _serve(P, 4, PROMPTS, 12, use_kv_migration=True, **kw)
    assert "kv_publish" not in _kinds(srv)
    assert sum(p.engine.stats.kv_imports for p in srv.pipelines) == 0
    assert sum(r.migrations for r in out) >= 1
    for r_ref, r_out in zip(ref, out):
        assert list(r_out.generated) == list(r_ref.generated)
    return _state(srv, out)


def _kv_migration_pending_chunked(P):
    prompts = [[5, 17, 42, 7, 99, 3, 1, 2, 8, 11] * 3, [1, 2, 3, 4, 5, 6]]
    return _interruption_equivalence(P, prompts, 10, 1,
                                     use_kv_migration=True, prefill_chunk=8)


# -- tensor store: LRU budget and accounting (test_kv_paging.py, test_kv_lazy.py) -----

def _store_evict_lru_respects_refcounts(P):
    store = P.TensorStore()
    for k in "abc":
        store.put("m", k, {"w": P.zeros(100)})
    store.attach("m", "a")                    # pin a
    store.attach("m", "b")
    store.detach("m", "b")                    # b unreferenced, recently used
    assert store.resident_bytes() == 1200
    assert store.evict_to(900) == 400
    assert not store.contains("m", "c")       # LRU victim: c (never touched)
    assert store.contains("m", "a") and store.contains("m", "b")
    store.take("m", "b")
    assert store.evict_to(0) == 0             # a referenced key stays
    assert store.contains("m", "a") and store.check_consistent()
    return _store_state(store)


def _store_budget_on_insert(P):
    store = P.TensorStore(budget_bytes=1000)
    for k in ("r1", "r2", "r3"):
        store.put("kv", k, {"w": P.zeros(100)})
    assert store.resident_bytes() <= 1000
    assert not store.contains("kv", "r1") and store.contains("kv", "r3")
    return _store_state(store)


def _store_put_and_load_agree(P):
    store = P.TensorStore()
    store.put("m", "pre", {"w": P.zeros(100)})
    assert store.refcount("m", "pre") == 0
    params, _ = store.load("m", "pre", lambda: {"w": P.zeros(2499)})
    assert params["w"].nbytes == 400          # resident key: no loader call
    assert store.refcount("m", "pre") == 1
    assert store.loads[-1].cold is False and store.loads[-1].wall_s == 0.0
    store.load("m", "cold", lambda: {"w": P.zeros(200)})
    assert store.refcount("m", "cold") == 1
    assert store.resident_bytes() == 1200 and store.check_consistent()
    store.detach("m", "cold")
    store.evict_unreferenced()
    assert store.resident_bytes() == 400
    assert store.contains("m", "pre") and not store.contains("m", "cold")
    return _store_state(store)


def _store_attach_missing_raises(P):
    with pytest.raises(KeyError):
        P.TensorStore().attach("m", "nope")
    return None


def _take_pinned_key(P):
    store = P.TensorStore()
    store.put("m", "w", {"x": P.zeros(8)})
    ref = store.attach("m", "w")
    assert store.take("m", "w") is None       # pinned: not consumable
    assert store.contains("m", "w") and store.attach("m", "w") is ref
    store.detach("m", "w")
    store.detach("m", "w")
    assert store.take("m", "w") is not None   # unpinned: consumed
    assert not store.contains("m", "w") and store.check_consistent()
    return _store_state(store)


# -- the cost victim (test_kv_lazy.py) -------------------------------------------------

def _victims(P, first, n_first_steps, second):
    eng = _engine(P, max_batch=4, max_len=64, block_size=8, n_blocks=16,
                  kv_overcommit=2.0)
    assert eng._victim_policy == "cost"       # the default
    a, b = _reqs(P, [first, second], 30)
    eng.admit(a)
    for _ in range(n_first_steps):
        eng.step()
    assert eng.admit(b)
    eng.step()
    sa = next(i for i, r in enumerate(eng.slots) if r is a)
    sb = next(i for i, r in enumerate(eng.slots) if r is b)
    assert len(b.generated) < len(a.generated)
    return (eng._victim_cost(sa), eng._victim_cost(sb),
            eng._pick_victim([sa, sb]) == sa, list(a.generated),
            list(b.generated))


def _cost_victim_cheapest(P):
    """The OLD request, whose context occupies fewer KV blocks, is the
    cheaper re-admission and is picked although it generated more."""
    c_old, c_young, picks_old, *toks = _victims(
        P, list(range(1, 9)), 6, list(range(1, 17)))
    assert c_old < c_young and picks_old
    return c_old, c_young, picks_old, toks


def _cost_victim_tie_break(P):
    """Two slots in the same block bucket cost the same: fewest generated
    breaks the tie."""
    c1, c2, picks_first, *toks = _victims(
        P, list(range(1, 7)), 4, list(range(1, 10)))
    assert c1 == c2 and not picks_first
    return c1, c2, picks_first, toks


# -- server: preempt -> publish -> attach (test_kv_lazy.py) ----------------------------

def _run_server(P, engine_kw, budget=None, use_kv_migration=True):
    srv = _server(P, P.TensorStore(budget_bytes=budget), max_batch=4,
                  max_len=64, use_kv_migration=use_kv_migration,
                  engine_kw=engine_kw)
    srv.add_pipeline(P.params, ["inst-A"])
    reqs = _reqs(P, [list(range(1, 10 + 2 * i)) for i in range(3)], 20)
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    return srv, reqs


OVERCOMMIT = {"block_size": 8, "n_blocks": 11, "kv_overcommit": 2.5}


def _preempt_publish_attach(P):
    _, ref = _run_server(P, {"block_size": 8})
    srv, out = _run_server(P, OVERCOMMIT)
    kinds = _kinds(srv)
    assert kinds.count("preempt") >= 1
    assert kinds.count("kv_publish") >= 1 and kinds.count("kv_attach") >= 1
    assert [list(r.generated) for r in out] \
        == [list(r.generated) for r in ref]
    assert all(r.done for r in out)
    assert not [k for k in srv.store._store if k[0] == "__kv__"]
    assert srv.store.check_consistent()
    return _state(srv, out)


def _preempt_without_store_recomputes(P):
    _, ref = _run_server(P, {"block_size": 8})
    srv, out = _run_server(P, OVERCOMMIT, use_kv_migration=False)
    kinds = _kinds(srv)
    assert kinds.count("preempt") >= 1 and kinds.count("kv_publish") == 0
    assert [list(r.generated) for r in out] \
        == [list(r.generated) for r in ref]
    return _state(srv, out)


def _kv_publish_budget(P):
    store = P.TensorStore()
    srv = _server(P, store, max_batch=4, max_len=64, use_kv_migration=True,
                  engine_kw={"block_size": 8})
    srv.add_pipeline(P.params, ["inst-A", "inst-B"])
    srv.add_pipeline(P.params, ["inst-C"])
    weights_bytes = store.resident_bytes()     # pinned by the pipelines
    reqs = _reqs(P, [list(range(1, 12))] * 4, 16)
    for r in reqs:
        srv.submit(r)
    for _ in range(4):
        srv.step()
        srv.tick()
    live = next(p.engine.export_live_kv() for p in srv.pipelines
                if p.engine.export_live_kv())
    one_kv = next(iter(live.values()))
    kv_bytes = one_kv["k"].nbytes + one_kv["v"].nbytes
    store.budget_bytes = weights_bytes + int(1.5 * kv_bytes)
    srv.interrupt_instance("inst-A")
    at_interrupt = _store_state(store)
    kv_resident = sum(b for k, b in store._bytes.items() if k[0] == "__kv__")
    assert kv_resident <= int(1.5 * kv_bytes) and store.check_consistent()
    srv.run_until_drained()
    assert all(r.done for r in reqs) and store.check_consistent()
    return kv_bytes, weights_bytes, at_interrupt, _state(srv, reqs)


# -- bucket-aware dispatch (test_routing.py) -------------------------------------------

def _route(P):
    spec = P.core.uniform_decoder("route-4l", 4, 2048, 16, 16, 8192, 32000)

    def inst(name, mem_gb, price):
        dev = P.hw.DeviceProfile(f"{name}-dev", mem_gb, 100e12, 800e9, 5e-6,
                                 32e9)
        return P.hw.InstanceProfile(name, dev, 1, 5e-5, 25e9 / 8, price,
                                    price * 0.35, name)

    def single(i):
        return P.core.Placement(spec, (P.core.Stage(
            i, 1, spec.n_layers, first=True, last=True),))
    return single(inst("low-hbm", 1.0, 1.0)), single(inst("high-hbm", 24.0,
                                                          2.0))


def _dispatch_shunts_longs(P):
    low, high = _route(P)
    srv = _server(P, None, max_batch=2, max_len=64, dispatch="cost")
    p_low = srv.add_pipeline(P.params, ["low-0"], placement=low)
    p_high = srv.add_pipeline(P.params, ["high-0"], placement=high)
    longs = _reqs(P, [list(range(1, 1801))] * 10, 900)
    shorts = _reqs(P, [list(range(1, 61))] * 10, 30, rid0=10)
    for r in longs + shorts:
        srv.submit(r)
    long_ids = {r.rid for r in longs}
    assert {r.rid for r in p_low.queue}.isdisjoint(long_ids)
    assert sum(r.rid in long_ids for r in p_high.queue) == len(longs)
    shorts_low = sum(r.rid not in long_ids for r in p_low.queue)
    shorts_high = sum(r.rid not in long_ids for r in p_high.queue)
    assert shorts_low > 0 and shorts_high > 0
    return _state(srv, []), [[list(map(float, row)) for row in p.bucket_tbl
                              .tok_s] for p in srv.pipelines]


def _uniform_dispatch(P):
    srv = _server(P, None, max_batch=2, max_len=64, dispatch="uniform")
    p0 = srv.add_pipeline(P.params, ["a"], weight=5.0)
    p1 = srv.add_pipeline(P.params, ["b"], weight=1.0)
    for r in _reqs(P, [[1]] * 10, 1):
        srv.submit(r)
    assert len(p0.queue) == len(p1.queue) == 5
    return _state(srv, [])


class _Tbl:
    """Stub bucket table with hand-set per-bucket weights."""

    def __init__(self, w):
        self.w = w

    def weight(self, bi, bo, policy="cost", spot=True):
        return self.w.get((bi, bo), 0.0)


def _requeue_preserves_bucket(P):
    srv = _server(P, None, max_batch=2, max_len=64, dispatch="cost")
    p_victim = srv.add_pipeline(P.params, ["victim-0"])
    p_short = srv.add_pipeline(P.params, ["short-0"])
    p_mid = srv.add_pipeline(P.params, ["mid-0"])
    p_victim.bucket_tbl = _Tbl({(0, 0): 0.1, (1, 0): 0.1})
    p_short.bucket_tbl = _Tbl({(0, 0): 100.0, (1, 0): 0.0})
    p_mid.bucket_tbl = _Tbl({(0, 0): 0.0, (1, 0): 100.0})
    (r,) = _reqs(P, [list(range(1, 121))], 60)
    b0 = srv.bucket_for(r)
    assert b0 == (0, 0)
    p_victim.queue.append(r)
    r.generated = [7] * 40
    srv.interrupt_instance("victim-0")
    assert srv.bucket_for(r) == b0                    # sticky
    assert r in p_short.queue and r not in p_mid.queue
    return _state(srv, [r])


def _dispatch_falls_back_without_placements(P):
    srv = _server(P, None, max_batch=2, max_len=64, dispatch="cost")
    p0 = srv.add_pipeline(P.params, ["a"], weight=3.0)
    p1 = srv.add_pipeline(P.params, ["b"], weight=1.0)
    for r in _reqs(P, [[1]] * 40, 1):
        srv.submit(r)
    assert len(p0.queue) == 30 and len(p1.queue) == 10
    return _state(srv, [])


def _pricing_reranks_dispatch(P):
    _, high = _route(P)
    out = []
    for pricing in ("ondemand", "spot"):
        srv = _server(P, None, max_batch=2, max_len=64, dispatch="cost")
        p0 = srv.add_pipeline(P.params, ["s-0"], placement=high)
        p1 = srv.add_pipeline(P.params, ["o-0"], placement=high,
                              pricing=pricing)
        for r in _reqs(P, [list(range(1, 61))] * 20, 30):
            srv.submit(r)
        if pricing == "ondemand":
            assert len(p0.queue) > 2 * len(p1.queue) and len(p1.queue) > 0
        else:
            assert len(p0.queue) == len(p1.queue) == 10
        out.append(_state(srv, []))
    return out


# -- store sanitizer (test_store_sanitizer.py) -----------------------------------------

def _san_params(P, scale=1.0):
    return {"w": P.ones((4, 4)) * scale}   # 64 bytes


def _san_clean_lifecycle(P):
    st = P.TensorStore(sanitize=True)
    st.put("m", "p0", _san_params(P))
    assert tuple(st.attach("m", "p0")["w"].shape) == (4, 4)
    st.detach("m", "p0")
    p, _ = st.load("m", "p1", lambda: _san_params(P))
    assert p is not None
    st.detach("m", "p1")
    st.put_or_attach("m", "p0", _san_params(P))      # hit path
    st.detach("m", "p0")
    assert float(st.take("m", "p1")["w"].sum()) == 16
    assert st.evict_unreferenced() == 1
    assert st.check_consistent()
    return _store_state(st)


def _san_budgeted_eviction(P):
    st = P.TensorStore(budget_bytes=128, sanitize=True)
    for i in range(4):
        st.put("m", f"p{i}", _san_params(P))
    assert st.resident_bytes() <= 128
    at_budget = _store_state(st)
    st.evict_to(0)
    assert st.resident_bytes() == 0
    return at_budget


def _san_detach_underflow(P):
    st = P.TensorStore(sanitize=True)
    st.put("m", "p0", _san_params(P))
    with pytest.raises(P.ts.RefcountUnderflowError):
        st.detach("m", "p0")                  # never attached
    st.attach("m", "p0")
    st.detach("m", "p0")
    with pytest.raises(P.ts.RefcountUnderflowError):
        st.detach("m", "p0")
    return _store_state(st)


def _san_underflow_tolerated_disarmed(P):
    st = P.TensorStore(sanitize=False)
    st.put("m", "p0", _san_params(P))
    st.detach("m", "p0")                      # tolerant no-op
    assert st.refcount("m", "p0") == 0
    return _store_state(st)


def _san_double_evict(P):
    st = P.TensorStore(sanitize=True)
    st.put("m", "p0", _san_params(P))
    st._drop(("m", "p0"))
    with pytest.raises(P.ts.DoubleEvictError):
        st._drop(("m", "p0"))
    return _store_state(st)


def _san_attach_after_evict(P):
    st = P.TensorStore(sanitize=True)
    st.put("m", "p0", _san_params(P))
    st.evict_unreferenced()
    with pytest.raises(P.ts.DoubleEvictError):
        st.attach("m", "p0")
    return _store_state(st)


def _san_pinned_evict(P):
    st = P.TensorStore(sanitize=True)
    st.put("m", "p0", _san_params(P))
    st.attach("m", "p0")
    with pytest.raises(P.ts.PinnedEvictError):
        st._drop(("m", "p0"))
    assert st.evict_unreferenced() == 0 and st.evict_to(0) == 0
    assert st.take("m", "p0") is None
    return _store_state(st)


def _san_divergence(P):
    st = P.TensorStore(sanitize=True)
    st.put("m", "p0", _san_params(P))
    st._refcount[("m", "p0")] += 1            # bug behind the ledger's back
    with pytest.raises(P.ts.StoreSanitizerError, match="refcount"):
        st.put("m", "p1", _san_params(P))
    return None


def _san_env_arms(P):
    mp = pytest.MonkeyPatch()
    try:
        out = []
        for v in ("1", "0", None):
            if v is None:
                mp.delenv("REPRO_KV_SANITIZE", raising=False)
            else:
                mp.setenv("REPRO_KV_SANITIZE", v)
            out.append(P.TensorStore().sanitize)
    finally:
        mp.undo()
    assert out == [True, False, False]
    return out


def _san_on_transfer(P):
    moved = []
    st = P.TensorStore(sanitize=True,
                       on_transfer=lambda kind, n: moved.append((kind, n)))
    st.put("m", "p0", _san_params(P))
    st.put("m", "p1", _san_params(P))
    st.take("m", "p0")
    assert st.take("m", "absent") is None     # a miss fires nothing
    assert moved == [("put", 64), ("put", 64), ("take", 64)]
    return moved


CASES = {f.__name__.lstrip("_"): f for f in (
    _migration_preserves_output, _no_migration_loses_progress,
    _concurrent_init_downtime, _weighted_round_robin, _zero_copy_attach,
    _load_once, _interruption_equivalence, _interruption_chunked_recompute,
    _single_pipeline_requeues, _estimator_driven_clock, _default_round_s,
    _kv_migration_no_reprefill, _kv_migration_contig_fallback,
    _kv_migration_pending_chunked, _store_evict_lru_respects_refcounts,
    _store_budget_on_insert, _store_put_and_load_agree,
    _store_attach_missing_raises, _take_pinned_key, _cost_victim_cheapest,
    _cost_victim_tie_break, _preempt_publish_attach,
    _preempt_without_store_recomputes, _kv_publish_budget,
    _dispatch_shunts_longs, _uniform_dispatch, _requeue_preserves_bucket,
    _dispatch_falls_back_without_placements, _pricing_reranks_dispatch,
    _san_clean_lifecycle, _san_budgeted_eviction, _san_detach_underflow,
    _san_underflow_tolerated_disarmed, _san_double_evict,
    _san_attach_after_evict, _san_pinned_evict, _san_divergence,
    _san_env_arms, _san_on_transfer)}
CASES["weighted_dispatch_max_batch_2"] = functools.partial(
    _weighted_round_robin, max_batch=2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_server_matches_jax(case):
    out = {name: CASES[case](P) for name, P in _pkgs().items()}
    assert out["torch"] == out["jax"]


# -- the port's own entry-point rules -------------------------------------------

def test_server_refuses_prefix_sharing_and_foreign_params():
    P = _pkgs()["torch"]
    with pytest.raises(NotImplementedError, match="A4"):
        _server(P, None, use_prefix_share=True)
    srv = _server(P, None, max_batch=2, max_len=64)
    def to_meta(tree):
        if isinstance(tree, dict):
            return {k: to_meta(v) for k, v in tree.items()}
        return tree.to("meta")
    with pytest.raises(ValueError, match="params live on"):
        srv.add_pipeline(to_meta(P.params), ["a"])
    assert srv.pipelines == []


def test_server_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    P = _pkgs()["torch"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.GlobalServer(P.cfg, None)
