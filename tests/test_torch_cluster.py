"""The port's cluster simulator (``repro_torch.cluster``: workload, events,
network, spot traces, simulator, frontier) and ``configs/shapes.py``
against the JAX package's, number for number.

Each scenario of tests/test_cluster_des.py and tests/test_simulator_spot.py
is built in both packages from the same values (never an object of one
passed to the other) and must give exactly equal results: every
``SimResult`` field (the completed and unfinished requests' timelines,
cost, downtime per pipeline, interruptions, preemptions, link statistics,
transfers) and its derived rates (rps, makespan rps, downtime, mean and
p99 latencies), traces, events, link transfers and frontier points,
floats compared with ``==``. Within the port the reference tests' own
checks hold too: the discrete-event run on an idle topology equals the
closed form, contention serializes warm-ups, the FT configs order as in
the paper's Fig 13.
"""

import dataclasses
import math
import types

import numpy as np
import pytest

import repro.cluster as jax_cluster
import repro.cluster.events as jax_events
import repro.cluster.network as jax_network
import repro.cluster.spot_trace as jax_spot
import repro.configs as jax_configs
import repro.configs.shapes as jax_shapes
import repro.core as jax_core
import repro.core.modelspec as jax_modelspec
import repro.hw as jax_hw
import repro.hw.profiles as jax_profiles
import repro_torch.cluster as cluster
import repro_torch.cluster.events as events
import repro_torch.cluster.network as network
import repro_torch.cluster.spot_trace as spot
import repro_torch.configs as configs
import repro_torch.configs.shapes as shapes
import repro_torch.core as core
import repro_torch.core.modelspec as modelspec
import repro_torch.hw as hw
import repro_torch.hw.profiles as profiles

PKGS = {
    "jax": types.SimpleNamespace(cl=jax_cluster, ev=jax_events,
                                 net=jax_network, spot=jax_spot,
                                 configs=jax_configs, core=jax_core,
                                 ms=jax_modelspec, hw=jax_hw,
                                 prof=jax_profiles),
    "torch": types.SimpleNamespace(cl=cluster, ev=events, net=network,
                                   spot=spot, configs=configs, core=core,
                                   ms=modelspec, hw=hw, prof=profiles),
}
KINDS = ("ttft", "tpot", "e2e")


def plain(x):
    """A result as plain values (dataclasses and other objects as dicts,
    tuples and numpy arrays as lists, NaN as a marker) for an exact
    comparison."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return plain(x.tolist())
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if hasattr(x, "__dict__") and not callable(x):     # e.g. a NetworkLink
        return {"type": type(x).__name__, **plain(vars(x))}
    return x


def summary(res) -> dict:
    """A ``SimResult``'s fields and derived rates."""
    return dict(plain(res), rps=res.rps, makespan_rps=res.makespan_rps,
                total_downtime_s=res.total_downtime_s,
                mean={k: plain(res.mean(k)) for k in KINDS},
                p99={k: plain(res.percentile(k, 0.99)) for k in KINDS})


def both(fn):
    """``fn(ns)`` in each package; asserts the results are equal and
    returns the port's."""
    out = {name: fn(ns) for name, ns in PKGS.items()}
    assert plain(out["torch"]) == plain(out["jax"])
    return out["torch"]


# -- tiny analytical fixtures (tests/test_cluster_des.py's) --------------------
def _inst(ns, name, mem_gb=24.0, tflops=100.0, price=2.0, bw=800e9):
    dev = ns.prof.DeviceProfile(f"{name}-dev", mem_gb, tflops * 1e12, bw,
                                5e-6, 32e9)
    return ns.prof.InstanceProfile(name, dev, 1, 5e-5, 25e9 / 8, price,
                                   price * 0.35, name)


def _tiny(ns):
    return ns.ms.uniform_decoder("des-4l", 4, 2048, 16, 16, 8192, 32000)


def _single(ns, spec, inst):
    return ns.core.Placement(spec, (ns.core.Stage(
        inst, 1, spec.n_layers, first=True, last=True),))


def _pl(ns):
    spec = _tiny(ns)
    return spec, _single(ns, spec, _inst(ns, "des-node"))


def _contention_ft(ns, **kw):
    return ns.cl.FTConfig(grace_period_s=30.0, node_provision_s=40.0,
                          store_load_s=60.0, engine_init_s=30.0, **kw)


_PLANS = {}


def _paper_plan(ns):
    """The paper's qwen3-32b cluster (``populate_cluster`` over
    ``paper_cluster``, beam_k=1, derated instances), once per package."""
    key = id(ns)
    if key not in _PLANS:
        spec = ns.configs.get_config("qwen3-32b").to_modelspec()
        insts = {n: dataclasses.replace(i, device=ns.hw.effective(i.device))
                 for n, i in ns.hw.AWS_INSTANCES.items()}
        plan = ns.core.populate_cluster(spec, ns.hw.paper_cluster(), insts,
                                        763, 232, beam_k=1)
        _PLANS[key] = (spec, plan)
    return _PLANS[key]


def test_the_paper_plan_is_the_same_in_both():
    both(lambda ns: [p.describe() for p in _paper_plan(ns)[1].pipelines])


# -- shapes ---------------------------------------------------------------------
def test_shapes_equal_the_reference():
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert (dataclasses.asdict(getattr(shapes, name))
                == dataclasses.asdict(getattr(jax_shapes, name)))
    assert ([dataclasses.asdict(s) for s in shapes.ALL_SHAPES]
            == [dataclasses.asdict(s) for s in jax_shapes.ALL_SHAPES])
    cfgs = sorted(configs.REGISTRY)
    assert cfgs == sorted(jax_configs.REGISTRY)
    for n in cfgs:
        c, jc = configs.REGISTRY[n], jax_configs.REGISTRY[n]
        assert ([s.name for s in shapes.shapes_for(c)]
                == [s.name for s in jax_shapes.shapes_for(jc)])
        assert ([(s.name, why) for s, why in shapes.skipped_shapes_for(c)]
                == [(s.name, why)
                    for s, why in jax_shapes.skipped_shapes_for(jc)])
    got = shapes.all_cells([configs.REGISTRY[n] for n in cfgs])
    ref = jax_shapes.all_cells([jax_configs.REGISTRY[n] for n in cfgs])
    assert ([(c.name, s.name) for c, s in got]
            == [(c.name, s.name) for c, s in ref])


# -- event core and links -------------------------------------------------------
def test_event_queue_and_dispatch():
    def run(ns):
        q = ns.ev.EventQueue()
        a, b, c = ns.ev.Wake(0), ns.ev.Wake(1), ns.ev.Wake(2)
        q.push(2.0, a)
        q.push(1.0, b)
        q.push(1.0, c)
        order = [q.pop() for _ in range(3)]
        q.push(1.0, ns.ev.Arrive("r"))
        q.push(2.0, ns.ev.Interrupt("pool", 2))
        q.push(50.0, ns.ev.Wake(7))
        seen = []
        handlers = {
            ns.ev.Arrive: lambda t, e: seen.append(("arrive", t, e.req)),
            ns.ev.Interrupt: lambda t, e: seen.append(
                ("int", t, e.pool, e.count)),
            ns.ev.Wake: lambda t, e: seen.append(("wake", t))}
        last = ns.ev.dispatch(q, handlers, until=10.0)
        return order, seen, last
    order, seen, last = both(run)
    assert [e.pid for _, e in order] == [1, 2, 0]
    assert seen == [("arrive", 1.0, "r"), ("int", 2.0, "pool", 2)]
    assert last == 2.0


def test_links_serialize_and_topology_shares_them():
    def run(ns):
        ln = ns.net.NetworkLink("l", bw_bps=100.0, latency_s=1.0)
        trs = [ln.submit(0.0, "a", 200.0), ln.submit(0.0, "b", 100.0),
               ln.submit(10.0, "a", 100.0)]
        inv = ns.net.NetworkLink("l", bw_bps=3.125e9, latency_s=0.05)
        topo = ns.net.Topology({"us": ns.net.LinkSpec(1e9, 0.1)})
        topo.store_link("us").submit(0.0, "warmup", 1e9)
        topo.cross_link("us", "eu")
        return dict(trs=trs, busy=ln.busy_until, q=ln.queue_wait_s(1.0),
                    by_kind=dict(ln.by_kind), wait=ln.wait_s,
                    inv=[inv.bytes_for_duration(d)
                         for d in (0.5, 61.85, 120.0, 0.01)],
                    stats=topo.stats())
    out = both(run)
    assert [(t.start_s, t.end_s) for t in out["trs"]] == [
        (0.0, 3.0), (3.0, 5.0), (10.0, 12.0)]


# -- closed-form parity on an idle topology (the gate) ------------------------
PARITY_FTS = {
    "no_events": (dict(), False),
    "shunt": (dict(), True),
    "no_migration": (dict(request_migration=False), True),
    "no_ci": (dict(concurrent_init=False), True),
    "nohandle": (dict(request_migration=False, concurrent_init=False), True),
    "hybrid_kv": (dict(recovery_policy="hybrid", kv_store_migration=True),
                  True),
    "transfer": (dict(recovery_policy="transfer"), True),
    "kv_pool": (dict(kv_pool_tokens=30_000), True),
    "short_grace": (dict(grace_period_s=30.0), True),
    "prefix_warm": (dict(prefix_warm_bytes=1e9), True),
}


@pytest.mark.parametrize("name", sorted(PARITY_FTS))
def test_des_equals_closed_form_and_the_reference(name):
    kw, with_events = PARITY_FTS[name]

    def run(ns):
        spec, plan = _paper_plan(ns)
        ft = ns.cl.FTConfig(**kw)
        pool = plan.pipelines[0].stages[0].instance.name
        evs = ([(120.0, pool, -1), (300.0, pool, -1)] if with_events
               else ())
        reqs = ns.cl.azure_conversation_like(duration_s=600.0, rate_rps=3.0,
                                             seed=3)
        base = ns.cl.ClusterSim(spec, plan.pipelines, ft).run(
            reqs, 600.0, events=evs)
        des = ns.cl.ClusterSim(spec, plan.pipelines, ft,
                               network=ns.cl.Topology()).run(
            reqs, 600.0, events=evs)
        return summary(base), summary(des)
    base, des = both(run)
    # the reference test's own gate, on the port's numbers
    for key in ("rps", "total_downtime_s", "cost_usd"):
        assert des[key] == pytest.approx(base[key], abs=1e-6), key
    assert len(des["completed"]) == len(base["completed"])
    assert des["interruptions"] == base["interruptions"]
    assert des["kv_preemptions"] == base["kv_preemptions"]
    for k in KINDS:
        if base["mean"][k] != "nan":
            assert des["mean"][k] == pytest.approx(base["mean"][k], abs=1e-6)
    if with_events:
        assert des["interruptions"] > 0 and des["transfers"] > 0


# -- link contention, regions, on-demand ---------------------------------------
@pytest.mark.parametrize("n_events", [-2, -1])
def test_warmup_contention(n_events):
    def run(ns):
        spec, pl = _pl(ns)
        ft = _contention_ft(ns)
        reqs = ns.cl.azure_conversation_like(duration_s=400.0, rate_rps=0.5,
                                             seed=0)
        evs = [(100.0, "des-node", n_events)]
        base = ns.cl.ClusterSim(spec, [pl, pl], ft).run(reqs, 400.0,
                                                         events=evs)
        des = ns.cl.ClusterSim(spec, [pl, pl], ft,
                               network=ns.cl.Topology()).run(
            reqs, 400.0, events=evs)
        return summary(base), summary(des)
    base, des = both(run)
    if n_events == -2:
        assert base["total_downtime_s"] == pytest.approx(140.0, abs=1e-6)
        assert des["total_downtime_s"] == pytest.approx(200.0, abs=1e-6)
        assert des["link_stats"]["store:local"]["wait_s"] > 0.0
    else:
        assert des["total_downtime_s"] == pytest.approx(
            base["total_downtime_s"], abs=1e-6)


def _regions(ns, crunch=0.02):
    pools = {"des-node": dataclasses.replace(
        ns.cl.PAPER_POOLS["g6.12xlarge"], name="des-node", capacity=20)}
    return [ns.cl.RegionSpec("us", pools, crunch_per_min=crunch),
            ns.cl.RegionSpec("eu", pools, crunch_per_min=crunch)]


def test_multi_region_traces_and_correlated_interruptions():
    def run(ns):
        regs = _regions(ns)
        tr = ns.cl.generate_multi_region_trace(regs, minutes=300, seed=5)
        tr3 = ns.cl.generate_multi_region_trace(
            regs + [ns.cl.RegionSpec("ap", regs[0].pools)], minutes=300,
            seed=5)
        pools = {n: dataclasses.replace(pm, capacity=pm.capacity * 8)
                 for n, pm in ns.cl.scaled_pools(1).items()}
        crunch = [ns.cl.RegionSpec("us", pools, crunch_per_min=0.05),
                  ns.cl.RegionSpec("eu", pools, crunch_per_min=0.05)]
        hot = ns.cl.generate_multi_region_trace(crunch, minutes=400, seed=2)
        calm = ns.cl.generate_multi_region_trace(
            [ns.cl.RegionSpec(r.name, r.pools) for r in crunch],
            minutes=400, seed=2)
        return dict(counts=tr.counts, counts3=tr3.counts,
                    events=hot.events()[:200],
                    n_hot=ns.cl.correlated_interruption_count(hot.events()),
                    n_calm=ns.cl.correlated_interruption_count(
                        calm.events()))
    out = both(run)
    assert set(out["counts"]) == {"us/des-node", "eu/des-node"}
    assert (out["counts3"]["us/des-node"] == out["counts"]["us/des-node"]).all()
    assert out["n_hot"] >= 50 and out["n_calm"] < out["n_hot"]


def test_region_scoped_events_cross_links_and_on_demand():
    def run(ns):
        spec, pl = _pl(ns)
        ft = _contention_ft(ns)
        reqs = ns.cl.azure_conversation_like(duration_s=300.0, rate_rps=0.5,
                                             seed=1)
        out = {}
        for ev_pool in ("us/des-node", "des-node"):
            sim = ns.cl.ClusterSim(spec, [pl, pl], ft,
                                   network=ns.cl.Topology(),
                                   regions=["us", "eu"])
            out[ev_pool] = summary(sim.run(reqs, 300.0, events=[
                (100.0, ev_pool, -2)]))
        slow = _single(ns, spec, _inst(ns, "des-slow", tflops=1.0, bw=0.8e9))
        ft_tr = _contention_ft(ns, recovery_policy="transfer")
        fast = ns.cl.azure_conversation_like(duration_s=300.0, rate_rps=2.0,
                                             seed=1)
        sim = ns.cl.ClusterSim(spec, [slow, slow], ft_tr,
                               network=ns.cl.Topology(),
                               regions=["us", "eu"])
        out["xr"] = summary(sim.run(fast, 300.0, events=[
            (100.0, "us/des-slow", -1)]))
        out["xr_log"] = list(sim.transfer_log)
        out["mixed"] = summary(ns.cl.ClusterSim(
            spec, [pl, pl], ft, spot=[True, False]).run(
            reqs, 300.0, events=[(50.0, "des-node", -2)]))
        out["spot"] = summary(ns.cl.ClusterSim(spec, [pl, pl], ft).run(
            reqs, 300.0))
        return out
    out = both(run)
    assert out["us/des-node"]["interruptions"] == 1
    assert out["des-node"]["interruptions"] == 2
    assert out["xr"]["link_stats"]["xr:eu<->us"]["bytes"] > 0
    assert out["mixed"]["interruptions"] == 1
    assert out["mixed"]["cost_usd"] > out["spot"]["cost_usd"]


def test_thousand_node_churn():
    def run(ns):
        spec, pl = _pl(ns)
        n = 1000
        regions = ["us" if i % 2 == 0 else "eu" for i in range(n)]
        sim = ns.cl.ClusterSim(spec, [pl] * n, ns.cl.FTConfig(),
                               network=ns.cl.Topology(), regions=regions)
        reqs = ns.cl.azure_conversation_like(duration_s=120.0, rate_rps=20.0,
                                             seed=6)
        evs = [(30.0 + i, ("us" if i % 2 else "eu") + "/des-node", -1)
               for i in range(60)]
        return summary(sim.run(reqs, 120.0, events=evs))
    out = both(run)
    assert out["interruptions"] == 60 and out["completed"]


# -- the paper's FT configurations and spot traces -----------------------------
def test_ft_config_ordering_and_cost():
    """Paper Fig 13 (tests/test_simulator_spot.py): OnDemand >= ShuntServe
    >= CI, RM >= NoHandle, CI cuts downtime, spot below on-demand."""
    def run(ns):
        spec, plan = _paper_plan(ns)
        pool = plan.pipelines[0].stages[0].instance.name
        evs = [(120.0, pool, -1), (300.0, pool, -1)]
        reqs = ns.cl.azure_conversation_like(duration_s=600.0, rate_rps=8.0,
                                             seed=3)
        variants = {
            "ondemand": (ns.cl.FTConfig(use_spot=False), ()),
            "shunt": (ns.cl.FTConfig(), evs),
            "ci": (ns.cl.FTConfig(request_migration=False), evs),
            "rm": (ns.cl.FTConfig(concurrent_init=False), evs),
            "nohandle": (ns.cl.FTConfig(request_migration=False,
                                        concurrent_init=False), evs)}
        return {k: summary(ns.cl.ClusterSim(spec, plan.pipelines, ft).run(
            reqs, 600.0, events=e)) for k, (ft, e) in variants.items()}
    res = both(run)
    rps = {k: r["rps"] for k, r in res.items()}
    assert rps["ondemand"] >= rps["shunt"] * 0.95
    assert rps["shunt"] >= rps["nohandle"] * 0.99
    assert rps["ci"] >= rps["nohandle"] * 0.99
    assert rps["rm"] >= rps["nohandle"] * 0.98
    assert (res["shunt"]["total_downtime_s"]
            <= res["nohandle"]["total_downtime_s"] + 1e-9)
    assert res["shunt"]["cost_usd"] < res["ondemand"]["cost_usd"] * 0.6


def test_spot_traces_scenarios_and_workload():
    def run(ns):
        tr0 = ns.cl.generate_trace(ns.spot.PAPER_POOLS, minutes=2000, seed=0)
        tr1 = ns.cl.generate_trace(ns.spot.PAPER_POOLS, minutes=2000, seed=1)
        start, score, zero = ns.cl.select_scenario(tr1, dur_min=50)
        reqs = ns.cl.azure_conversation_like(duration_s=3600, rate_rps=4.67,
                                             seed=0)
        peak = ns.cl.azure_conversation_like(
            duration_s=3600.0, rate_rps=4.0, seed=9,
            rate_profile=lambda t: 2.0)
        return dict(
            counts=tr0.counts, scenario=(start, score, zero),
            window=ns.spot.window_score(tr1, 0, 50),
            events=ns.cl.interruption_events_for_window(tr1, start, 50),
            reqs=reqs, n_peak=len(peak),
            hist=ns.cl.length_histogram(reqs),
            diurnal=[ns.cl.diurnal_rate(t) for t in (0.0, 21600.0, 64800.0)])
    out = both(run)
    assert np.mean(out["counts"]["p6.48xlarge"]) < 0.2
    assert out["scenario"][1] >= out["window"]
    assert any(d < 0 for _, _, d in out["events"])
    assert 3.5 < len(out["reqs"]) / 3600.0 < 6.0


def test_frontier_sweep_and_pareto_front():
    def run(ns):
        spec, pl = _pl(ns)
        reqs = ns.cl.azure_conversation_like(duration_s=300.0, rate_rps=1.0,
                                             seed=4)
        evs = [(60.0, "des-node", -1), (150.0, "des-node", -1)]
        pts = ns.cl.sweep_frontier(
            spec, [pl, pl], reqs, 300.0, events=evs, spot_fracs=(0.0, 1.0),
            graces=(30.0, 120.0), policies=("recompute", "hybrid"),
            network_factory=ns.cl.Topology)
        front = ns.cl.pareto_front(pts)
        return pts, [pts.index(f) for f in front]
    pts, front = both(run)
    assert len(pts) == 8 and front
    for i in front:
        assert not any(q.dominates(pts[i]) for q in pts)


def test_replicated_placement_shares_estimator_caches():
    spec, pl = _pl(PKGS["torch"])
    sim = cluster.ClusterSim(spec, [pl] * 64, cluster.FTConfig())
    p0 = sim.pipes[0]
    assert all(p._iter_cache is p0._iter_cache for p in sim.pipes)

    def run(ns):
        spec, pl = _pl(ns)
        sim = ns.cl.ClusterSim(spec, [pl] * 4, ns.cl.FTConfig())
        return [p.t_iter(b) for p in sim.pipes for b in (1, 8)]
    assert min(both(run)) > 0
