"""Training over a mesh (``build_step``'s train step, ``launch/train_mesh.py``;
``train/elastic.py``; ``restore_checkpoint(shardings=)``) against the JAX
package's sharded train step.

The reference's step is its ``build_step(cfg, ShapeSpec("t", 32, 4,
"train_step"), mesh, attn_chunk=0)`` jitted with its ``in_shardings`` on a
``jax.sharding.Mesh`` of four host devices (Auto axes), which needs
``XLA_FLAGS`` before JAX loads: it runs in two subprocesses at once (half
the cases each), which hand their states back through one ``.npz`` per
case. Each case starts from the reference's state after one step of its
own (non-zero moments), converted with ``train_state_from_jax``; the
port's ranks (gloo worlds of ``run_ranks``, one world per mesh running
all its cases) take one step on the next batch and gather the state:
loss and ``grad_norm`` within rtol 1e-5, every ``params``, ``m`` and
``v`` leaf within atol 1e-5 (the fp32 sums run in another order; a
gradient element within rounding of a bf16 tie may round the other way
under the compression), ``step`` equal. The cases: reduced internlm2-1.8b
at (data, model) = (2, 2), (1, 4), (4, 1) and (pod, data, model) = (2,
1, 2); qwen2-vl-2b, granite-moe, mamba2-1.3b, zamba2-2.7b and
whisper-tiny at (2, 2); internlm2 at (2, 2) with ``n_microbatches=2,
gather_weights_once=True`` and with ``remat_policy="save_block_out"``.

The elastic sequence against the reference's own: (2, 2) for 2 steps from
the reference's init, a checkpoint from the mesh (its files those of a
one-process save of the same values), ``resize_mesh`` to 2 devices, then
a (1, 2) world restoring through ``state_shardings`` and taking one step
at the resized batch. ``plan_resize`` equals the reference's over a grid.
Without the bf16 compression the (2, 2) step over two microbatches
equals the port's one-process step.
Every rank records its warnings: a backward through a collective without
an autograd rule warns ("an autograd kernel was not registered"), and the
test fails on it.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.train.elastic as jel
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import mesh_for_rank, run_ranks
from repro_torch.launch.train_mesh import _ix, train_cases
from repro_torch.models import build_model
from repro_torch.models.common import matmul_fp32
from repro_torch.models.convert import train_state_from_jax
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import (AdamWConfig, elastic, init_train_state,
                               make_train_step)
from repro_torch.train.data import DataConfig, SyntheticLM, to_torch
from repro_torch.train.optimizer import leaves

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SEQ, BATCH = 32, 4
DM = ("data", "model")
POD = ("pod", "data", "model")
# case -> (arch, mesh shape, axes, build_step keywords)
CASES = {
    "dense_22": ("internlm2-1.8b", (2, 2), DM, {}),
    "dense_14": ("internlm2-1.8b", (1, 4), DM, {}),
    "dense_41": ("internlm2-1.8b", (4, 1), DM, {}),
    "dense_pod": ("internlm2-1.8b", (2, 1, 2), POD, {}),
    "vlm_22": ("qwen2-vl-2b", (2, 2), DM, {}),
    "moe_22": ("granite-moe-3b-a800m", (2, 2), DM, {}),
    "ssm_22": ("mamba2-1.3b", (2, 2), DM, {}),
    "hybrid_22": ("zamba2-2.7b", (2, 2), DM, {}),
    "encdec_22": ("whisper-tiny", (2, 2), DM, {}),
    "dense_22_once": ("internlm2-1.8b", (2, 2), DM,
                      {"n_microbatches": 2, "gather_weights_once": True}),
    "dense_22_saving": ("internlm2-1.8b", (2, 2), DM,
                        {"remat_policy": "save_block_out"}),
}
# the reference's subprocesses: the elastic sequence rides on dense_22
HALVES = (["dense_22", "dense_41", "dense_pod", "moe_22", "encdec_22",
           "dense_22_saving"],
          ["dense_14", "vlm_22", "ssm_22", "hybrid_22", "dense_22_once"])
NO_RULE = "autograd kernel was not registered"
# no bf16 compression, two microbatches: the ranks' sums run once a step
PLAIN = {"n_microbatches": 2,
         "opt_cfg": AdamWConfig(compress_grads_bf16=False)}

SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys, tempfile
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.configs.shapes import ShapeSpec
    from repro.launch.steps import build_step
    from repro.models import build_model
    from repro.train import checkpoint as ckpt, elastic
    from repro.train.data import DataConfig, SyntheticLM
    from repro.train.train_step import init_train_state

    out_dir, cases = sys.argv[1], json.loads(sys.argv[2])
    SEQ, BATCH = {SEQ}, {BATCH}

    def flat(tree, prefix):
        if isinstance(tree, dict):
            out = {{}}
            for k, v in tree.items():
                out.update(flat(v, prefix + "/" + k))
            return out
        return {{prefix: np.asarray(tree)}}

    def state(st, tag):
        return {{**flat(st.params, tag + "p"), **flat(st.opt.m, tag + "m"),
                 **flat(st.opt.v, tag + "v"),
                 tag + "step": np.asarray(st.opt.step)}}

    def batch(cfg, b, i):
        data = SyntheticLM(cfg, DataConfig(b, SEQ, 0)).batch_at(i)
        return {{k: jnp.asarray(v) for k, v in data.items()}}

    inits = {{}}
    for name, (arch, shape, axes, kw) in cases.items():
        cfg = get_config(arch).reduced()
        n = int(np.prod(shape))
        mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), tuple(axes))
        built = build_step(cfg, ShapeSpec("t", SEQ, BATCH, "train_step"),
                           mesh, attn_chunk=0, **kw)
        if arch not in inits:
            inits[arch] = init_train_state(
                build_model(cfg, remat=False).init(jax.random.PRNGKey(0)))
        fn = jax.jit(built.fn, in_shardings=built.in_shardings)
        # every call's arguments committed to the in_shardings: one compile
        put = lambda st, i: (jax.device_put(st, built.in_shardings[0]),
                             jax.device_put(batch(cfg, BATCH, i),
                                            built.in_shardings[1]))
        with mesh:
            s1, _ = fn(*put(inits[arch], 0))
            s2, met = fn(*put(s1, 1))
        res = {{**state(s1, "a"), **state(s2, "b"),
                "loss": np.asarray(met["loss"]),
                "grad_norm": np.asarray(met["grad_norm"]),
                "nm": np.asarray(built.meta["n_microbatches"])}}
        if name == "dense_22":
            # the elastic sequence: s2 is 2 steps from the init on (2, 2)
            res.update(state(inits[arch], "i"))
            d = tempfile.mkdtemp()
            ckpt.save_checkpoint(d, 2, s2)
            old = elastic.ElasticState(mesh, 4, BATCH)
            new = elastic.resize_mesh(old, 2, 2, devices=jax.devices())
            b2 = build_step(cfg, ShapeSpec("t", SEQ, new.global_batch,
                                           "train_step"),
                            new.mesh, attn_chunk=0)
            got = ckpt.restore_checkpoint(d, 2, s2,
                                          shardings=b2.in_shardings[0])
            with new.mesh:
                s3, met3 = jax.jit(b2.fn, in_shardings=b2.in_shardings)(
                    got, batch(cfg, new.global_batch, 2))
            res.update(state(s3, "e"), eloss=np.asarray(met3["loss"]),
                       egrad_norm=np.asarray(met3["grad_norm"]),
                       eshape=np.asarray(new.mesh.devices.shape),
                       ebatch=np.asarray(new.global_batch))
        np.savez(os.path.join(out_dir, name + ".npz"), **res)
    print("done")
""").format(SEQ=SEQ, BATCH=BATCH)


def _tree(npz, tag: str) -> dict:
    out: dict = {}
    for key in npz.files:
        if not key.startswith(tag + "/"):
            continue
        node, parts = out, key.split("/")[1:]
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = npz[key]
    return out


@dataclasses.dataclass
class _Opt:
    step: np.ndarray
    m: dict
    v: dict


def _state(npz, tag: str, cfg):
    """The reference's state ``tag`` of an ``.npz`` as the port's, on the
    host."""
    return train_state_from_jax(
        _tree(npz, tag + "p"), _Opt(npz[tag + "step"], _tree(npz, tag + "m"),
                                    _tree(npz, tag + "v")), cfg, "cpu")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every case's reference run, from two subprocesses at once."""
    out = tmp_path_factory.mktemp("ref_train_mesh")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(out),
         json.dumps({k: CASES[k] for k in half})], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for half in HALVES]
    for p in procs:
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, err[-4000:]
    return {k: np.load(out / f"{k}.npz") for k in CASES}


def _case(name, npz, **kw):
    """``train_run``'s keywords for case ``name``: a step on batch 1 from
    the reference's state after one step; ``kw`` overrides."""
    cfg = get_config(CASES[name][0]).reduced()
    data = SyntheticLM(cfg, DataConfig(BATCH, SEQ, 0))
    case = dict(cfg=cfg, seq_len=SEQ, step_kw=CASES[name][3],
                batches=[data.batch_at(1)])
    case.update(kw)
    if "state" not in case and "restore" not in case:
        case["state"] = _state(npz, "a", cfg)
    return case


@pytest.fixture(scope="module")
def worlds(ref, tmp_path_factory):
    """The port's side: one gloo world per mesh, each running its cases;
    the (2, 2) world also runs the elastic sequence's first half, the
    (1, 2) world its second."""
    ck = str(tmp_path_factory.mktemp("ckpt_mesh"))
    cfg = get_config("internlm2-1.8b").reduced()
    data = SyntheticLM(cfg, DataConfig(BATCH, SEQ, 0))
    out = {}
    for shape, axes in {(CASES[k][1], CASES[k][2]) for k in CASES}:
        names = [k for k in CASES if CASES[k][1:3] == (shape, axes)]
        cases = [_case(k, ref[k]) for k in names]
        if shape == (2, 2):
            names.append("plain_22")
            cases.append(_case("dense_22", ref["dense_22"], step_kw=PLAIN))
            names.append("elastic_22")
            cases.append(_case(
                "dense_22", ref["dense_22"], state=_state(
                    ref["dense_22"], "i", cfg),
                batches=[data.batch_at(0), data.batch_at(1)], ckpt_dir=ck))
        res = run_ranks(train_cases, shape, axes, args=(cases,))
        for i, k in enumerate(names):
            out[k] = [r[i] for r in res]
    small = SyntheticLM(cfg, DataConfig(2, SEQ, 0))
    res = run_ranks(train_cases, (1, 2), DM, args=([dict(
        cfg=cfg, seq_len=SEQ, batches=[small.batch_at(2)],
        restore=(ck, 2), elastic=(elastic.ElasticState(None, 4, BATCH), 2,
                                  2))],))
    out["elastic_12"] = [r[0] for r in res]
    out["ckpt_dir"] = ck
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _check_state(got, npz, tag, metrics=None):
    """Every leaf of the gathered state ``got`` within 1e-5 of the
    reference's state ``tag``; the metrics within rtol 1e-5."""
    assert got.opt.step == int(npz[tag + "step"])
    for part, tree in (("p", got.params), ("m", got.opt.m),
                       ("v", got.opt.v)):
        ref = _flat(_tree(npz, tag + part))
        mine = _flat(tree)
        assert sorted(ref) == sorted(mine)
        for n in ref:
            np.testing.assert_allclose(mine[n].float().numpy(), ref[n],
                                       atol=1e-5, rtol=0,
                                       err_msg=f"{tag}{part}{n}")
    if metrics is not None:
        pre = "" if tag == "b" else "e"
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(metrics[k], float(npz[pre + k]),
                                       rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_equals_the_reference(ref, worlds, name):
    ranks = worlds[name]
    assert ranks[0]["n_microbatches"] == int(ref[name]["nm"])
    # the metrics are the same on every rank
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    assert all(r["state"] is None for r in ranks[1:])
    _check_state(ranks[0]["state"], ref[name], "b", ranks[0]["metrics"][0])


def test_mesh_step_without_compression_equals_one_process(ref, worlds):
    """Without the bf16 compression (the card's fp32 gate) the ranks sum
    the step's accumulated gradient once: the (2, 2) step over two
    microbatches equals the port's one-process ``make_train_step`` from
    the same state."""
    cfg = get_config("internlm2-1.8b").reduced()
    state = _state(ref["dense_22"], "a", cfg)
    batch = SyntheticLM(cfg, DataConfig(BATCH, SEQ, 0)).batch_at(1)
    want, met = make_train_step(build_model(cfg, device="cpu"),
                                PLAIN["opt_cfg"], 2)(state,
                                                     to_torch(batch, "cpu"))
    got = worlds["plain_22"][0]
    assert got["n_microbatches"] == 2
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][0][k], met[k].item(),
                                   rtol=1e-5, err_msg=k)
    for a, b in ((got["state"].params, want.params),
                 (got["state"].opt.m, want.opt.m),
                 (got["state"].opt.v, want.opt.v)):
        mine, ref_leaves = _flat(a), _flat(b)
        assert sorted(mine) == sorted(ref_leaves)
        for n in mine:
            np.testing.assert_allclose(mine[n].numpy(),
                                       ref_leaves[n].numpy(), atol=1e-5,
                                       rtol=0, err_msg=n)


def test_no_backward_through_a_collective_without_its_rule(worlds):
    said = [w for k, ranks in worlds.items() if k != "ckpt_dir"
            for r in ranks for w in r["warnings"] if NO_RULE in w]
    assert not said, said[:3]
    # the tensor-parallel backward did reduce over model
    assert worlds["dense_14"][0]["stats"]["calls"] > 0


def test_elastic_resize_equals_the_reference(ref, worlds):
    npz = ref["dense_22"]
    first = worlds["elastic_22"][0]
    _check_state(first["state"], npz, "b")
    assert tuple(npz["eshape"]) == (1, 2) and int(npz["ebatch"]) == 2
    last = worlds["elastic_12"][0]
    _check_state(last["state"], npz, "e", last["metrics"][0])


def test_mesh_checkpoint_is_a_one_process_save(worlds, tmp_path):
    """The mesh's checkpoint holds the files a one-process save of the
    same values writes: paths, shapes, dtypes and digests."""
    mesh_dir = os.path.join(worlds["ckpt_dir"], "step_00000002")
    one = ckpt.save_checkpoint(str(tmp_path), 2,
                               worlds["elastic_22"][0]["state"])

    def manifest(d):
        with open(os.path.join(d, "manifest.json")) as f:
            m = json.load(f)
        return m["step"], {leaf["path"]: leaf for leaf in m["leaves"]}
    assert manifest(mesh_dir) == manifest(one)
    assert sorted(os.listdir(mesh_dir)) == sorted(os.listdir(one))


def test_plan_resize_equals_the_reference():
    assert ([f.name for f in dataclasses.fields(elastic.ElasticState)]
            == [f.name for f in dataclasses.fields(jel.ElasticState)])
    for n_old in (1, 2, 4, 8, 16):
        for batch in (1, 3, 4, 8, 256):
            for n_new in (1, 2, 3, 4, 6, 7, 8, 12, 16):
                for model in (1, 2, 4, 8):
                    got = elastic.plan_resize(
                        elastic.ElasticState(None, n_old, batch), n_new, model)
                    want = jel.plan_resize(
                        jel.ElasticState(None, n_old, batch), n_new, model)
                    assert got == want, (n_old, batch, n_new, model)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-moe-3b-a800m",
                                  "mamba2-1.3b", "zamba2-2.7b",
                                  "whisper-tiny"])
@pytest.mark.parametrize("shape,axes", [((2, 2), DM), ((1, 4), DM),
                                        ((2, 1, 2), POD)])
def test_rank_state_layout_cuts_the_full_state(arch, shape, axes):
    """Every rank's ``init_state`` is its ``shard_state`` of the unsplit
    init, each shard is ``full[leaf_index]`` (the indices
    ``gather_state`` places it by), and the ranks' indices cover every
    element (no collective runs: ranks without process groups)."""
    cfg = get_config(arch).reduced()
    full = init_train_state(build_model(cfg, device="cpu").init(seed=3))
    n = int(np.prod(shape))
    seen = {}
    for rank in range(n):
        mesh = mesh_for_rank(shape, axes, rank)
        built = S.build_step(cfg, ShapeSpec("t", SEQ, BATCH, "train_step"),
                             mesh, device="cpu")
        mine = built.init_state(seed=3)
        cut = built.shard_state(full)
        for a, b in zip(leaves(mine.params), leaves(cut.params)):
            assert torch.equal(a, b)
        for path, leaf in built.layout.leaves.items():
            t = full.params
            for k in path:
                t = t[k]
            piece = built.layout.local(path, t)
            assert torch.equal(t[_ix(leaf.index)], piece), path
            mark = seen.setdefault(path, torch.zeros(t.shape, dtype=bool))
            mark[_ix(leaf.index)] = True
    assert all(bool(m.all()) for m in seen.values())


@pytest.mark.parametrize("shapes", [((3, 5, 64), (64, 24)),
                                    ((4, 6, 64), (4, 64, 24))],
                         ids=["2d", "batched"])
def test_matmul_fp32_backward_holds_to_the_upcast_product(shapes):
    """The row-parallel product's derivative (``matmul_fp32`` under
    autograd: bf16 operands, fp32 accumulation) against the upcast fp32
    product's: the forward equal, the input and weight gradients within
    the bf16 rounding of the incoming gradient, in the inputs' dtype."""
    gen = np.random.default_rng(0)
    x0 = torch.from_numpy(gen.standard_normal(shapes[0])).bfloat16()
    w0 = torch.from_numpy(gen.standard_normal(shapes[1])).bfloat16()
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    xu, wu = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    y = matmul_fp32(x, w)
    yu = xu.float() @ wu.float()
    assert y.dtype == torch.float32 and torch.equal(y, yu)
    g = torch.from_numpy(gen.standard_normal(tuple(y.shape))).float()
    dx, dw = torch.autograd.grad(y, (x, w), g)
    dxu, dwu = torch.autograd.grad(yu, (xu, wu), g)
    for got, want in ((dx, dxu), (dw, dwu)):
        assert got.dtype == want.dtype == torch.bfloat16
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 1e-2 * want.float().abs().max().item(), err
