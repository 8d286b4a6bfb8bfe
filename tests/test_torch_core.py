"""The port's planning core (``repro_torch.core``, ``hw``, ``cluster.recovery``
and ``ArchConfig.to_modelspec``) against the JAX package's, number for
number.

Each case builds its inputs in both packages from the same values (never a
JAX-side object passed to the port) and requires exactly equal results:
estimates, search results and scores, bucket tables, recovery decisions and
model specs (floats compared with ``==``; only search wall times are left
out). The cases mirror tests/test_fast_engine.py (its wall-clock bound
aside), tests/test_routing.py's planning half, the ``decide`` cases of
tests/test_recovery.py and tests/test_kv_paging.py, and the baseline plans
of tests/test_system.py; within the port they also keep the reference
tests' own checks (the fast engine within rel 1e-6 of the reference
scorer). ``calibrate`` runs at tiny sizes on the CPU.
"""

import dataclasses
import functools
import math
import types

import pytest
import torch

import repro.cluster.recovery as jax_recovery
import repro.core as jax_core
import repro.core.baselines as jax_baselines
import repro.core.placement as jax_placement
import repro.hw.profiles as jax_profiles
import repro_torch.cluster.recovery as recovery
import repro_torch.core as core
import repro_torch.core.baselines as baselines
import repro_torch.core.placement as placement
import repro_torch.hw.profiles as profiles
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.hw.calibration import CalibrationResult as JaxCalibrationResult
from repro_torch.configs import REGISTRY
from repro_torch.hw import calibrate
from repro_torch.hw.calibration import CalibrationResult

REL = 1e-6
PKGS = {
    "jax": types.SimpleNamespace(core=jax_core, placement=jax_placement,
                                 hw=jax_profiles, recovery=jax_recovery,
                                 baselines=jax_baselines,
                                 registry=JAX_REGISTRY),
    "torch": types.SimpleNamespace(core=core, placement=placement,
                                   hw=profiles, recovery=recovery,
                                   baselines=baselines, registry=REGISTRY),
}


def plain(x):
    """A result as plain values (dataclasses as dicts, tuples as lists) for
    an exact comparison across the packages; search wall times dropped."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.name != "wall_time_s"}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def both(fn):
    """``fn(ns)`` in each package; asserts the results are equal and
    returns the port's."""
    out = {name: fn(ns) for name, ns in PKGS.items()}
    assert plain(out["torch"]) == plain(out["jax"])
    return out["torch"]


def _effective_insts(ns):
    return {n: dataclasses.replace(i, device=ns.hw.effective(i.device))
            for n, i in ns.hw.AWS_INSTANCES.items()}


_PLANS = {}


def _paper_plan(ns, arch):
    """(spec, populate_cluster plan) of ``arch`` on the paper's 24-GPU
    cluster at beam_k=1, searched once per package."""
    key = (id(ns), arch)
    if key not in _PLANS:
        spec = ns.registry[arch].to_modelspec()
        _PLANS[key] = spec, ns.core.populate_cluster(
            spec, ns.hw.paper_cluster(), _effective_insts(ns), 763, 232,
            beam_k=1)
    return _PLANS[key]


def test_paper_cluster_plan_matches_jax():
    """populate_cluster on the paper's 24-GPU cluster (llama-3.1-70b and
    qwen3-32b, beam_k=1): the same pipelines, throughputs and leftover
    inventory."""
    for arch in ("llama-3.1-70b", "qwen3-32b"):
        plan = both(lambda ns: _paper_plan(ns, arch)[1])
        assert plan.pipelines
        n = REGISTRY[arch].n_layers
        for p in plan.pipelines:
            assert sum(s.n_layers for s in p.stages) == n


# -- to_modelspec -----------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_to_modelspec_matches_jax(arch):
    spec = both(lambda ns: ns.registry[arch].to_modelspec())
    assert hash(spec) == hash(REGISTRY[arch].to_modelspec())   # frozen
    reduced = both(lambda ns: ns.registry[arch].reduced().to_modelspec())
    assert reduced.dtype_bytes == 4


# -- the fast engine against the reference scorer (test_fast_engine.py) -----------

def _specs(ns):
    ud = ns.core.uniform_decoder
    out = [("tiny-dense", ud("tiny", 6, 256, 4, 2, 512, 1000)),
           ("tiny-swa", ud("swa", 6, 256, 4, 2, 512, 1000, window=64)),
           ("tiny-moe", ud("moe", 6, 256, 4, 2, 128, 1000, n_experts=8,
                           top_k=2))]
    for arch in ("qwen3-32b", "mamba2-1.3b", "zamba2-2.7b"):
        out.append((arch, ns.registry[arch].to_modelspec()))
    return out


SPEC_NAMES = [n for n, _ in _specs(PKGS["torch"])]


def _mark(stages):
    return tuple(
        dataclasses.replace(s, first=(i == 0), last=(i == len(stages) - 1))
        for i, s in enumerate(stages))


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_estimate_matches_jax(name):
    """estimate and FastEstimator.estimate on one-, two- and three-stage
    placements across the layer families (dense, SWA, MoE, SSM, hybrid):
    equal to the JAX package's, and the fast engine within rel 1e-6 of the
    reference scorer."""
    def run(ns):
        spec = dict(_specs(ns))[name]
        insts = ns.hw.AWS_INSTANCES
        Stage = ns.core.Stage
        n = spec.n_layers
        cases = [
            (Stage(insts["g6e.xlarge"], 1, n),),
            (Stage(insts["g6.12xlarge"], 4, n // 2),
             Stage(insts["g6e.xlarge"], 1, n - n // 2)),
            (Stage(insts["g6.12xlarge"], 2, n // 3),
             Stage(insts["g5.12xlarge"], 1, n // 3),
             Stage(insts["g6e.xlarge"], 1, n - 2 * (n // 3))),
        ]
        eng = ns.core.FastEstimator(spec, 256, 64)
        out = []
        for stages in cases:
            p = ns.core.Placement(spec, _mark(list(stages)))
            out.append((ns.core.estimate(spec, p, 256, 64), eng.estimate(p),
                         ns.core.estimator.stage_latencies(spec, p, 8, 256,
                                                           64)))
        return out

    for ref, fast, _ in both(run):
        assert fast.batch == ref.batch
        if ref.batch <= 0:
            continue
        for f in ("throughput_rps", "ttft_s", "tpot_s", "e2e_latency_s"):
            assert getattr(fast, f) == pytest.approx(getattr(ref, f),
                                                     rel=REL)
        for a, b in zip(fast.prefill_stage_s + fast.decode_stage_s,
                        ref.prefill_stage_s + ref.decode_stage_s):
            assert a == pytest.approx(b, rel=REL)


SEARCH_MATRIX = [
    ((6, 256, 4, 2, 512, 1000), {"g6e.xlarge": 2, "g6.12xlarge": 1}, 1),
    ((6, 256, 4, 2, 512, 1000), {"g6e.xlarge": 2, "g6.12xlarge": 1}, 3),
    ((8, 512, 8, 4, 2048, 32000), {"g6.12xlarge": 2, "g5.12xlarge": 1}, 3),
    ((8, 512, 8, 4, 2048, 32000), {"g6e.xlarge": 3}, 2),
]


@pytest.mark.parametrize("args,inv,k", SEARCH_MATRIX)
def test_search_matches_jax(args, inv, k):
    """The DP search with the reference scorer, the fast engine without
    pruning and the fast engine with dominance pruning: each equal to the
    JAX package's; within the port, the fast search finds the reference
    scorer's placement or score, and pruning stays within 2% of it."""
    def run(ns):
        spec = ns.core.uniform_decoder("m", *args)
        common = dict(objective=ns.core.Objective(), beam_k=k, max_stages=3)
        opt = functools.partial(ns.core.PlacementOptimizer, spec, inv,
                                ns.hw.AWS_INSTANCES, 128, 32, **common)
        return (opt(use_fast=False).search(),
                opt(prune_dominated=False).search(),
                opt(prune_dominated=True).search())

    ref, fast, pruned = both(run)
    assert (fast.placement is None) == (ref.placement is None)
    if ref.placement is not None:
        assert (fast.placement.describe() == ref.placement.describe()
                or fast.score == pytest.approx(ref.score, rel=REL))
    assert pruned.score >= fast.score * 0.98


def test_pruning_keeps_recoverable_zero_score_partials():
    """A memory-tight cluster where every 2-stage prefix scores 0 until the
    LM head migrates: pruning keeps the recoverable partial (as in the
    reference test), and both searches equal the JAX package's."""
    def run(ns):
        inst = ns.hw.AWS_INSTANCES["g6.12xlarge"]
        tight = dataclasses.replace(
            inst, device=dataclasses.replace(inst.device, mem_gb=4))
        insts = {"g6.12xlarge": tight}
        spec = ns.core.uniform_decoder("m", 4, 8192, 32, 8, 32768, 500000)
        inv = {"g6.12xlarge": 2}
        common = dict(beam_k=3, max_stages=4)
        ref = ns.core.PlacementOptimizer(spec, inv, insts, 32, 8,
                                         use_fast=False, **common).search()
        pruned = ns.core.PlacementOptimizer(spec, inv, insts, 32, 8,
                                            prune_dominated=True,
                                            **common).search()
        return ref, pruned

    ref, pruned = both(run)
    assert ref.placement is not None and pruned.placement is not None
    assert pruned.score == pytest.approx(ref.score, rel=REL)


def test_exhaustive_matches_reference_scoring():
    def run(ns):
        spec = ns.core.uniform_decoder("tiny", 4, 256, 4, 2, 512, 1000)
        inv = {"g6e.xlarge": 2, "g6.12xlarge": 1}
        obj = ns.core.Objective()
        ex = ns.placement.exhaustive_search(spec, inv, ns.hw.AWS_INSTANCES,
                                            128, 32, obj, max_stages=3)
        return ex, obj.score(ex.placement,
                             ns.core.estimate(spec, ex.placement, 128, 32))

    ex, ref_score = both(run)
    assert ex.score == pytest.approx(ref_score, rel=REL)


def test_custom_objective_falls_back_to_reference():
    def run(ns):
        class Doubled(ns.core.Objective):
            def score(self, placement, perf):
                return 2.0 * super().score(placement, perf)

        spec = ns.core.uniform_decoder("tiny", 4, 256, 4, 2, 512, 1000)
        opt = ns.core.PlacementOptimizer(spec, {"g6e.xlarge": 2},
                                         ns.hw.AWS_INSTANCES, 128, 32,
                                         objective=Doubled())
        return opt.use_fast, opt.search()

    use_fast, res = both(run)
    assert not use_fast and res.placement is not None


HIST_MATRIX = [
    ((6, 256, 4, 2, 512, 1000), {"g6e.xlarge": 2, "g6.12xlarge": 1}, 2),
    ((8, 512, 8, 4, 2048, 32000), {"g6.12xlarge": 2, "g5.12xlarge": 1}, 3),
    ((8, 512, 8, 4, 2048, 32000), {"g6e.xlarge": 3}, 2),
]


@pytest.mark.parametrize("args,inv,k", HIST_MATRIX)
def test_histogram_objective_search_matches_jax(args, inv, k):
    """The $/token histogram objective on the fast DP path and on the
    reference scorer: equal to the JAX package's, the same optimum, and the
    fast score equal to the histogram scorer's own number."""
    def run(ns):
        spec = ns.core.uniform_decoder("m", *args)
        hist = ns.core.workload_histogram(
            [(100, 50)] * 6 + [(700, 200)] * 3 + [(1800, 900)])
        obj = ns.core.HistogramCostObjective(hist)
        common = dict(objective=obj, beam_k=k, max_stages=3)
        ref = ns.core.PlacementOptimizer(spec, inv, ns.hw.AWS_INSTANCES,
                                         763, 232, use_fast=False,
                                         **common).search()
        fast_opt = ns.core.PlacementOptimizer(spec, inv, ns.hw.AWS_INSTANCES,
                                              763, 232, **common)
        fast = fast_opt.search()
        rescored = None if fast.placement is None else obj.score(
            fast.placement, ns.core.estimate(spec, fast.placement, 763, 232))
        return fast_opt.use_fast, ref, fast, rescored

    use_fast, ref, fast, rescored = both(run)
    assert use_fast
    assert (fast.placement is None) == (ref.placement is None)
    if ref.placement is not None:
        assert fast.score == pytest.approx(ref.score, rel=REL)
        assert fast.score == pytest.approx(rescored, rel=REL)


def test_slo_objective_matches_jax():
    def run(ns):
        spec = ns.core.uniform_decoder("m", 8, 512, 8, 4, 2048, 32000)
        inv = {"g6e.xlarge": 2, "g6.12xlarge": 1}
        obj = ns.core.Objective(gamma=0.5, slo_s=0.05)
        common = dict(objective=obj, beam_k=2, max_stages=3)
        opt = functools.partial(ns.core.PlacementOptimizer, spec, inv,
                                ns.hw.AWS_INSTANCES, 128, 32, **common)
        return (opt(use_fast=False).search(),
                opt(prune_dominated=False).search())

    ref, fast = both(run)
    assert fast.score == pytest.approx(ref.score, rel=REL)


# -- bucket tables and the $/token objective (test_routing.py) ---------------------

def _route(ns):
    """test_routing.py's fixtures, built in ``ns``'s package: a spec with
    real KV pressure and four single-device instances."""
    spec = ns.core.uniform_decoder("route-4l", 4, 2048, 16, 16, 8192, 32000)

    def inst(name, mem_gb, tflops, price):
        dev = ns.hw.DeviceProfile(f"{name}-dev", mem_gb, tflops * 1e12,
                                  800e9, 5e-6, 32e9)
        return ns.hw.InstanceProfile(name, dev, 1, 5e-5, 25e9 / 8, price,
                                     price * 0.35, name)

    def single(i):
        return ns.core.Placement(
            spec, (ns.core.Stage(i, 1, spec.n_layers, first=True,
                                 last=True),))
    return types.SimpleNamespace(
        spec=spec, single=single, low=inst("low-hbm", 1.0, 100, 1.0),
        high=inst("high-hbm", 24.0, 100, 2.0),
        cheap=inst("cheap-slow", 24.0, 50, 1.0),
        fast=inst("fast-expensive", 24.0, 500, 30.0))


def test_bucket_table_matches_jax():
    """Every cell of the bucket table (tokens/s and $/token) equals the JAX
    package's and, within the port, a direct FastEstimator.estimate at the
    bucket's representative point; the low-HBM long bucket is zero."""
    def run(ns):
        r = _route(ns)
        bk = ns.core.LengthBuckets()
        p = r.single(r.high)
        tbl = ns.core.bucket_table(p, buckets=bk)
        cells = []
        for bi, bo in bk.pairs():
            s_in, s_out = bk.rep(bi, bo)
            est = ns.core.FastEstimator(r.spec, s_in, s_out).estimate(p)
            cells.append((tbl.tok_s[bi][bo], tbl.cost_per_token(bi, bo),
                          est.throughput_rps * s_out if est.batch > 0
                          else 0.0, p.price_hr(spot=True)))
        return cells, ns.core.bucket_table(r.single(r.low)).tok_s, \
            tbl.tok_s

    cells, low, high = both(run)
    for tok_s, cost, want, price in cells:
        assert tok_s == pytest.approx(want, rel=1e-9)
        assert cost == (price / 3600.0 / want if want > 0 else math.inf)
    assert low[0][0] > 0 and low[-1][-1] == 0.0 and high[-1][-1] > 0


def test_workload_histogram_matches_jax():
    hist = both(lambda ns: ns.core.workload_histogram(
        [(100, 50)] * 3 + [(2000, 1000)] * 1, ns.core.LengthBuckets()))
    assert hist[0][0] == pytest.approx(0.75)
    assert hist[-1][-1] == pytest.approx(0.25)


def test_cost_objective_ranks_cheap_above_fast():
    def run(ns):
        r = _route(ns)
        hist = ns.core.workload_histogram([(100, 50)] * 6
                                          + [(1500, 800)] * 4)
        cost_obj = ns.core.HistogramCostObjective(hist)
        p_cheap, p_fast = r.single(r.cheap), r.single(r.fast)
        est = ns.core.BucketEstimator(r.spec)
        tps = ns.core.Objective(per_cost=False)
        return (cost_obj.score(p_cheap, None), cost_obj.score(p_fast, None),
                cost_obj.cost_per_token(p_cheap),
                cost_obj.cost_per_token(p_fast),
                tps.score(p_cheap, est.estimator(2, 2).estimate(p_cheap)),
                tps.score(p_fast, est.estimator(2, 2).estimate(p_fast)))

    s_cheap, s_fast, c_cheap, c_fast, t_cheap, t_fast = both(run)
    assert s_cheap > s_fast and c_cheap < c_fast and t_fast > t_cheap


def test_optimizer_picks_cheap_mix_under_cost_objective():
    def run(ns):
        r = _route(ns)
        hist = ns.core.workload_histogram([(100, 50)] * 8
                                          + [(1500, 800)] * 2)
        insts = {r.cheap.name: r.cheap, r.fast.name: r.fast}
        inv = {r.cheap.name: 1, r.fast.name: 1}
        opt = ns.core.PlacementOptimizer(
            r.spec, inv, insts, 763, 232,
            objective=ns.core.HistogramCostObjective(hist), beam_k=2,
            max_stages=2)
        res_t = ns.core.PlacementOptimizer(
            r.spec, inv, insts, 763, 232,
            objective=ns.core.Objective(per_cost=False), beam_k=2,
            max_stages=2).search()
        return opt.use_fast, opt.search(), res_t

    use_fast, res, res_t = both(run)
    assert use_fast
    assert {s.instance.name for s in res.placement.stages} == {"cheap-slow"}
    assert "fast-expensive" in {s.instance.name
                                for s in res_t.placement.stages}


def test_tokens_per_req_matches_jax():
    def run(ns):
        r = _route(ns)
        insts = {r.cheap.name: r.cheap, r.high.name: r.high}
        inv = {r.cheap.name: 1, r.high.name: 1}
        opt = functools.partial(ns.core.PlacementOptimizer, r.spec, inv,
                                insts, 256, 64, beam_k=2, max_stages=2)
        obj = ns.core.Objective(tokens_per_req=232.0)
        fast = opt(objective=obj, use_fast=True, prune_dominated=False)
        return (fast.use_fast, fast.search(),
                opt(objective=obj, use_fast=False).search(),
                opt(objective=ns.core.Objective()).search())

    use_fast, rf, rr, plain_res = both(run)
    assert use_fast
    assert rf.score == pytest.approx(rr.score, rel=1e-6)
    assert rf.placement.describe() == rr.placement.describe()
    assert rf.score == pytest.approx(plain_res.score * 232.0, rel=1e-6)


# -- recovery decisions (test_recovery.py, test_kv_paging.py) ---------------------

DECIDE = {
    "short_ctx_recomputes": dict(ctx=512, remaining_grace_s=120.0,
                                 policy="hybrid"),
    "long_ctx_transfers": dict(ctx=32768, remaining_grace_s=300.0,
                               policy="hybrid", efficiency=0.05),
    "grace_forces_recompute": dict(ctx=32768, remaining_grace_s=0.5,
                                   policy="transfer", efficiency=0.05),
    "policy_recompute": dict(ctx=65536, remaining_grace_s=1e9,
                             policy="recompute", efficiency=1e-3),
    "store_lacks_kv": dict(ctx=4096, remaining_grace_s=120.0,
                           policy="hybrid", efficiency=0.05, chunk=16),
    "store_holds_kv": dict(ctx=4096, remaining_grace_s=120.0,
                           policy="hybrid", efficiency=0.05, chunk=16,
                           store_has_kv=True),
}
WANT = {"short_ctx_recomputes": "recompute",
        "long_ctx_transfers": "transfer",
        "grace_forces_recompute": "recompute",
        "policy_recompute": "recompute", "store_holds_kv": "kv_restore"}


@pytest.mark.parametrize("case", sorted(DECIDE))
def test_decide_matches_jax(case):
    """recovery.decide on the paper-cluster plan's first pipeline
    (llama-3.1-70b): the same mechanism and the same seconds for every
    branch; with blocks in the store, kv_restore beats the other two."""
    def run(ns):
        spec, plan = _paper_plan(ns, "llama-3.1-70b")
        return ns.recovery.decide(spec, plan.pipelines[0], **DECIDE[case])

    d = both(run)
    if case in WANT:
        assert d.mechanism == WANT[case]
    if case == "short_ctx_recomputes":
        assert d.recompute_s < d.transfer_s
    if case == "grace_forces_recompute":
        assert not d.fits_grace
    if case == "store_lacks_kv":
        assert d.mechanism != "kv_restore"
    if case == "store_holds_kv":
        assert d.kv_restore_s < min(d.recompute_s, d.transfer_s)


def test_recovery_costs_match_jax():
    """The per-branch prices the engine's cost victim policy and the
    simulator read: KV bytes, recompute, transfer, restore and preemption
    seconds over a range of contexts."""
    def run(ns):
        spec, plan = _paper_plan(ns, "llama-3.1-70b")
        p, r = plan.pipelines[0], ns.recovery
        return [(r.kv_bytes_for_ctx(spec, c),
                 r.recompute_seconds(spec, p, c, chunk=512, max_len=4096),
                 r.transfer_seconds(spec, p, c),
                 r.kv_restore_seconds(spec, c),
                 r.preemption_seconds(spec, c))
                for c in (16, 512, 2048, 32768)]

    rows = both(run)
    assert rows[-1][0] > rows[1][0]            # KV bytes grow with context


# -- baseline plans (test_system.py) ------------------------------------------------

def test_baselines_match_jax():
    """vLLM-even, AlpaServe-DP and HexGen-genetic plans for qwen3-32b on the
    paper cluster: the same pipelines as the JAX package's, each covering
    every layer."""
    def run(ns):
        spec = ns.registry["qwen3-32b"].to_modelspec()
        insts, inv = _effective_insts(ns), ns.hw.paper_cluster()
        return (ns.baselines.vllm_even(spec, inv, insts, 763, 232),
                ns.baselines.alpaserve_dp(spec, inv, insts, 763, 232),
                ns.baselines.hexgen_genetic(spec, inv, insts, 763, 232,
                                            pop_size=6, generations=3,
                                            seed=0))

    n = REGISTRY["qwen3-32b"].n_layers
    even, dp, gen = both(run)
    assert even.pipelines and dp.pipelines
    for plan in (even, dp, gen):
        for p in plan.pipelines:
            assert sum(s.n_layers for s in p.stages) == n


# -- calibration ---------------------------------------------------------------------

def test_calibrate_on_the_cpu_and_apply_matches_jax():
    """The PyTorch calibration pass at tiny sizes on the CPU: positive
    rates, the median of its samples, and ``apply`` on the H100 profile
    equal to the JAX package's ``apply`` of the same numbers."""
    res = calibrate(device_name="cpu-rehearsal", gemm_sizes=(32, 64, 96),
                    gemv_sizes=(64, 128, 256), net_sizes=(1024, 8192),
                    device="cpu")
    assert res.eff_flops > 0 and res.eff_mem_bw > 0
    assert res.eff_net_bps > 0 and res.net_alpha_s > 0
    assert res.eff_flops == sorted(res.samples["gemm_flops"])[1]
    assert res.eff_mem_bw == sorted(res.samples["gemv_bps"])[1]
    bf16 = calibrate(gemm_sizes=(32,), gemv_sizes=(64,), net_sizes=(64, 512),
                     dtype=torch.bfloat16, device="cpu")
    assert bf16.eff_flops > 0 and bf16.eff_mem_bw > 0
    fields = {f.name: getattr(res, f.name)
              for f in dataclasses.fields(CalibrationResult)}
    ref = JaxCalibrationResult(**fields)
    assert plain(res.apply(profiles.H100)) == plain(
        ref.apply(jax_profiles.H100))
    assert res.apply(profiles.H100).flops_bf16 == res.eff_flops
