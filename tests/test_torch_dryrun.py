"""The port's dry-run plane on fake ranks (``launch/op_costs.py``,
``launch/dryrun.py``, ``launch/roofline.py``, ``launch/hillclimb.py``)
against the JAX package's and against real gloo ranks.

Every fake world runs in a subprocess of its own (``dryrun.run_traced``,
all at once) at the reference's small-mesh shapes
(``tests/test_dryrun_small.py``): reduced internlm2-1.8b at (data, model)
= (2, 4) for a train step ``ShapeSpec("t", 64, 8)``, a prefill ``("p",
64, 4)`` and a serve step ``("d", 64, 8)``, (pod, data, model) = (2, 2,
2) serving with and without ``serve_pp``, and zamba2 serving. Checks:

- (a) a rank's argument bytes (params, AdamW's m and v, the batch every
  rank is given) equal the local shard sizes the reference's
  ``repro.sharding.rules.resolve`` gives for the same specs under the
  reference's ``build_rules`` (internlm2 with 4 KV heads, which the
  model axis divides: where it does not, the port keeps only the KV
  heads a rank's queries read, a documented difference);
- (b) the collectives a fake rank counts equal, call for call (kind,
  bytes, group size) and in order, what a real gloo rank of
  ``run_ranks`` counts for the same step (train, prefill, serve) at (1,
  2) and (2, 2);
- (c) the FLOPs of a reduced dense prefill equal a closed form;
- the train step's scaled counts (traced at 2 and 3 depth units and at
  1 and 2 microbatches) equal a full trace at test size, the peak too
  (internlm2's 4 layers with and without the ``seq`` rule, zamba2 at 5
  depth units), and the ``seq`` rule lowers the peak;
- (d) ``model_flops_for``, ``analytic_min_bytes`` and ``n_chips`` equal
  the reference's with ``==`` over every (architecture x shape);
- (e) ``hillclimb.CELLS`` equal the reference's (read from its source:
  importing it would set ``XLA_FLAGS`` in this process);
- (f) one ``hillclimb.measure`` variant and ``python -m
  repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k --mesh
  single`` run.
"""

import ast
import dataclasses
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import repro.launch.roofline as jroof
import repro.launch.steps as jsteps
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import get_config as jax_config
from repro.configs.shapes import shapes_for as jax_shapes_for
from repro.models import build_model as jax_build
from repro.sharding import rules as JR
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.device import dtype_of
from repro_torch.launch import dryrun, hillclimb, op_costs, roofline
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.api import input_specs

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DM = ("data", "model")
POD = ("pod", "data", "model")
T = [64, 8, "train_step"]
P = [64, 4, "prefill_step"]
D = [64, 8, "serve_step"]
KV4 = {"n_kv_heads": 4}
SEQ = {"extra_rules": {"seq": ["model"]}}


def _spec(arch, shape, mesh, axes, rank=0, step_kw=None, overrides=None,
          full=True):
    return {"arch": arch, "shape": shape, "mesh": [list(mesh), list(axes)],
            "rank": rank, "step_kw": step_kw or {}, "reduced": True,
            "overrides": overrides or {}, "full": full}


# name -> worker spec: every fake world of the file, run at once
SPECS = {
    # (a), and the train step's scaling
    "a_t": _spec("internlm2-1.8b", T, (2, 4), DM, overrides=KV4),
    "a_p": _spec("internlm2-1.8b", P, (2, 4), DM, overrides=KV4),
    "t_full": _spec("internlm2-1.8b", T, (2, 4), DM),
    "t_scaled": _spec("internlm2-1.8b", T, (2, 4), DM, full=False),
    "t_seq_full": _spec("internlm2-1.8b", T, (2, 4), DM, step_kw=SEQ),
    "t_seq_scaled": _spec("internlm2-1.8b", T, (2, 4), DM, step_kw=SEQ,
                          full=False),
    "hy_full": _spec("zamba2-2.7b", T, (2, 4), DM, overrides={
        "n_layers": 10}),
    "hy_scaled": _spec("zamba2-2.7b", T, (2, 4), DM, overrides={
        "n_layers": 10}, full=False),
    # (c)
    "c_p": _spec("internlm2-1.8b", P, (2, 4), DM),
    # the reference's small-mesh cells
    "d_24": _spec("internlm2-1.8b", D, (2, 4), DM),
    "d_dp": _spec("internlm2-1.8b", D, (2, 2, 2), POD),
    "d_pp0": _spec("internlm2-1.8b", D, (2, 2, 2), POD,
                   step_kw={"serve_pp": True}),
    "d_pp1": _spec("internlm2-1.8b", D, (2, 2, 2), POD, rank=4,
                   step_kw={"serve_pp": True}),
    "zamba_d": _spec("zamba2-2.7b", D, (2, 4), DM),
}
# (b): the same steps on real gloo ranks
B_MESHES = ((1, 2), (2, 2))
B_STEPS = (T, P, D)
for _m in B_MESHES:
    for _s in B_STEPS:
        SPECS[f"b_{_m[0]}{_m[1]}_{_s[2]}"] = _spec("internlm2-1.8b", _s, _m,
                                                  DM)


def _cli():
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-0.5b", "--shape", "decode_32k", "--mesh", "single"],
        env=dict(os.environ, PYTHONPATH=SRC), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs():
    """Every fake world, the CLI and one hill-climb variant at once, then
    the real gloo worlds."""
    cli = _cli()
    measured = {}

    def climb():
        cell = hillclimb.CELLS["qwen3_decode"]
        name, _, kw = cell["variants"][1]
        measured[name] = hillclimb.measure(cell["arch"], cell["shape"],
                                           multi_pod=cell["multi_pod"],
                                           **kw)
    th = threading.Thread(target=climb)
    th.start()
    names = list(SPECS)
    got = dict(zip(names, dryrun.run_traced([SPECS[k] for k in names])))
    cfg = get_config("internlm2-1.8b").reduced()
    real = {}
    for m in B_MESHES:
        cases = [(cfg, dryrun._shape(s), {}) for s in B_STEPS]
        ranks = run_ranks(op_costs.rank_costs, m, DM, args=(cases,))
        for i, s in enumerate(B_STEPS):
            real[f"b_{m[0]}{m[1]}_{s[2]}"] = [r[i] for r in ranks]
    out, err = cli.communicate(timeout=600)
    th.join(timeout=600)
    return {"fake": got, "real": real, "cli": (cli.returncode, out, err),
            "measured": measured}


def _jmesh(shape, axes):
    class _M:
        pass
    m = _M()
    m.shape = dict(zip(axes, shape))
    return m


def _numel(shape):
    n = 1
    for d in shape:
        n *= d
    return n


def _ref_param_numel(name: str, step: str) -> int:
    """The rank's param elements by the reference's ``resolve`` under its
    ``build_rules``."""
    spec = SPECS[name]
    jcfg = dataclasses.replace(jax_config("internlm2-1.8b").reduced(),
                               **spec["overrides"])
    seq_len, batch, _ = spec["shape"]
    jm = _jmesh(*spec["mesh"])
    rules = jsteps.build_rules(jcfg, jm, step == "train_step", step=step)
    model = jax_build(jcfg)
    specs, shapes = model.param_specs(), model.param_shapes()

    def walk(names, sds):
        if isinstance(names, dict):
            return sum(walk(names[k], sds[k]) for k in names)
        spec = JR.resolve(names, sds.shape, rules, jm)
        return _numel([d // _numel([jm.shape[a] for a in (
            () if e is None else (e,) if isinstance(e, str) else e)])
            for d, e in zip(sds.shape, spec)])
    return walk(specs, shapes)


def _input_bytes(name: str) -> int:
    spec = SPECS[name]
    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(),
                              **spec["overrides"])
    seq_len, batch, step = spec["shape"]
    specs = input_specs(cfg, ShapeSpec(step[0], seq_len, batch, step))
    return sum(_numel(s.shape) * s.dtype.itemsize for s in specs.values())


@pytest.mark.parametrize("name", ["a_t", "a_p"])
def test_argument_bytes_are_the_references_shards(runs, name):
    step = SPECS[name]["shape"][2]
    n = _ref_param_numel(name, step)
    size = dtype_of(get_config("internlm2-1.8b").reduced().dtype).itemsize
    per = size + (8 if step == "train_step" else 0)   # params (+ fp32 m, v)
    got = runs["fake"][name]["costs"]["arg_bytes"]
    assert got == n * per + _input_bytes(name), (got, n, per)


@pytest.mark.parametrize("mesh", B_MESHES, ids=["12", "22"])
@pytest.mark.parametrize("step", [s[2] for s in B_STEPS])
def test_fake_rank_collectives_equal_a_real_ranks(runs, mesh, step):
    key = f"b_{mesh[0]}{mesh[1]}_{step}"
    fake = [tuple(c) for c in runs["fake"][key]["costs"]["log"]]
    real = runs["real"][key]
    assert fake == [tuple(c) for c in real[0].log]
    assert fake, key
    # every real rank makes the same calls
    assert all(r.log == real[0].log for r in real)
    # and the counts by kind are the log's
    coll = runs["fake"][key]["costs"]["collectives"]
    for kind, rec in coll.items():
        mine = [c for c in fake if c[0] == kind]
        assert rec["calls"] == len(mine)
        assert rec["bytes"] == sum(c[1] for c in mine)


def test_dense_prefill_flops_equal_a_closed_form(runs):
    """Rank 0 of (2, 4): 2 of 4 rows, 1 of 4 query heads, both KV heads
    (the prefill's cache is cut by sequence, and a rank then projects
    every KV head), 24 of 96 FFN columns, 126 of 504 vocab columns at
    the last position; attention the full S x S products."""
    cfg = get_config("internlm2-1.8b").reduced()
    seq_len, batch, _ = SPECS["c_p"]["shape"]
    rows, h, kv = batch // 2, cfg.n_heads // 4, cfg.n_kv_heads
    ff, vocab = cfg.d_ff // 4, cfg.padded_vocab // 4
    t, d, hd = rows * seq_len, cfg.d_model, cfg.hd
    proj = 2 * t * d * hd * (h + 2 * kv) + 2 * t * h * hd * d
    ffn = 2 * t * d * ff * (3 if cfg.gated_ffn else 2)
    attn = 2 * 2 * rows * h * seq_len * seq_len * hd
    want = cfg.n_layers * (proj + ffn + attn) + 2 * rows * d * vocab
    assert runs["fake"]["c_p"]["costs"]["flops"] == want


@pytest.mark.parametrize("pair", [("t_scaled", "t_full"),
                                  ("t_seq_scaled", "t_seq_full"),
                                  ("hy_scaled", "hy_full")])
def test_scaled_train_trace_equals_the_full_trace(runs, pair):
    scaled, full = (runs["fake"][k]["costs"] for k in pair)
    assert runs["fake"][pair[0]]["meta"]["scaled"]["traced"] == [
        [2, 1], [2, 2], [3, 1], [3, 2]]
    for key in ("flops", "bytes", "arg_bytes", "peak_bytes"):
        assert scaled[key] == pytest.approx(full[key], rel=1e-12,
                                            abs=1e-6), key
    assert sorted(scaled["collectives"]) == sorted(full["collectives"])
    for kind, rec in full["collectives"].items():
        for f, v in rec.items():
            assert scaled["collectives"][kind][f] == pytest.approx(
                v, rel=1e-12, abs=1e-6), (kind, f)


def test_the_seq_rule_lowers_a_ranks_peak(runs):
    with_rule = runs["fake"]["t_seq_full"]
    assert with_rule["meta"]["seq"] == "model"
    assert runs["fake"]["t_full"]["meta"]["seq"] is None
    assert (with_rule["costs"]["peak_bytes"]
            < runs["fake"]["t_full"]["costs"]["peak_bytes"])


def test_small_mesh_cells_run(runs):
    """The reference's ``test_dryrun_small`` cells: collectives in the
    train and serve steps, the PP split of the reduced config's 4 layers
    over two stages, one hop a microbatch between them, zamba2 serving."""
    fake = runs["fake"]
    assert fake["t_full"]["costs"]["flops"] > 0
    assert fake["t_full"]["costs"]["collectives"]
    assert fake["d_24"]["costs"]["collectives"]
    assert fake["d_dp"]["costs"]["collectives"]
    split = fake["d_pp0"]["meta"]["pp_split"]
    assert sum(split) == 4 and fake["d_pp1"]["meta"]["pp_split"] == split
    m = fake["d_pp0"]["meta"]["n_microbatches"]
    sends = fake["d_pp0"]["costs"]["collectives"]["collective-permute"]
    assert sends["calls"] == m
    assert "collective-permute" not in fake["d_pp1"]["costs"]["collectives"]
    assert fake["zamba_d"]["costs"]["flops"] > 0


def test_roofline_helpers_equal_the_references():
    for name, cfg in JAX_REGISTRY.items():
        for sh in jax_shapes_for(cfg):
            assert (roofline.model_flops_for(name, sh.name)
                    == jroof.model_flops_for(name, sh.name)), (name, sh)
            assert (roofline.analytic_min_bytes(name, sh.name)
                    == jroof.analytic_min_bytes(name, sh.name)), (name, sh)
    for mesh in ("16x16", "2x16x16"):
        assert roofline.n_chips(mesh) == jroof.n_chips(mesh)


def test_hillclimb_cells_equal_the_references():
    path = os.path.join(SRC, "repro", "launch", "hillclimb.py")
    tree = ast.parse(open(path).read())
    node = next(n for n in tree.body if isinstance(n, ast.AnnAssign)
                and getattr(n.target, "id", None) == "CELLS")
    assert hillclimb.CELLS == ast.literal_eval(node.value)


def test_a_hillclimb_variant_and_the_cli_run(runs):
    rc, out, err = runs["cli"]
    assert rc == 0, err[-3000:]
    assert "qwen2-0.5b x decode_32k on 16x16" in out
    assert "1 cells OK, 0 failed" in out
    rec = runs["measured"]["kv_f8"]
    for key in ("compute_s", "memory_s", "collective_s", "total_s"):
        assert np.isfinite(rec[key]) and rec[key] > 0, key
    assert rec["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert rec["peak_mem_gb"] > 0
