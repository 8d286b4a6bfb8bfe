"""The ``seq`` rule in the port's train step (``build_step`` with
``extra_rules={"seq": ("model",)}`` on a ``train_step`` shape,
``launch/train_mesh.py``) against the JAX package's sharded train step
under the same rule.

The reference's step is its ``build_step(cfg, ShapeSpec("t", 32, 4,
"train_step"), mesh, attn_chunk=0, extra_rules={"seq": ("model",)})``
jitted with its ``in_shardings`` on a ``jax.sharding.Mesh`` of four host
devices, in two subprocesses at once (``XLA_FLAGS`` must be set before JAX
loads), which hand their states back through one ``.npz`` per case. Each
case starts from the reference's state after one step of its own,
converted with ``train_state_from_jax``; the port's ranks (gloo worlds of
``run_ranks``, one world per mesh running all its cases) take one step on
the next batch and gather the state: loss and ``grad_norm`` within rtol
1e-5, every ``params``, ``m`` and ``v`` leaf within atol 1e-5, ``step``
equal. Cases: reduced internlm2-1.8b at (data, model) = (2, 2) and (1,
4), at (2, 2) with ``remat_policy="save_block_out"`` and with
``n_microbatches=2, gather_weights_once=True``; qwen2-vl-2b,
granite-moe-3b-a800m, mamba2-1.3b, zamba2-2.7b and whisper-tiny at (2,
2). Every rank records the cut (the train layout's ``seq`` axes, the
gathers and reduce-scatters of ``Sharder.stats``, the residual stream's
local shape ``train_run`` reports) and its warnings: a backward through a collective without
an autograd rule warns ("an autograd kernel was not registered"), and
the test fails on it.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.train_mesh import train_cases
from repro_torch.models.convert import train_state_from_jax
from repro_torch.train.data import DataConfig, SyntheticLM

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SEQ, BATCH = 32, 4
DM = ("data", "model")
RULE = {"seq": ("model",)}
# case -> (arch, mesh shape, build_step keywords besides the rule)
CASES = {
    "dense_22": ("internlm2-1.8b", (2, 2), {}),
    "dense_14": ("internlm2-1.8b", (1, 4), {}),
    "dense_22_saving": ("internlm2-1.8b", (2, 2),
                        {"remat_policy": "save_block_out"}),
    "dense_22_once": ("internlm2-1.8b", (2, 2),
                      {"n_microbatches": 2, "gather_weights_once": True}),
    "vlm_22": ("qwen2-vl-2b", (2, 2), {}),
    "moe_22": ("granite-moe-3b-a800m", (2, 2), {}),
    "ssm_22": ("mamba2-1.3b", (2, 2), {}),
    "hybrid_22": ("zamba2-2.7b", (2, 2), {}),
    "encdec_22": ("whisper-tiny", (2, 2), {}),
}
HALVES = (["dense_22", "dense_22_saving", "moe_22", "encdec_22",
           "dense_14"],
          ["dense_22_once", "vlm_22", "ssm_22", "hybrid_22"])
NO_RULE = "autograd kernel was not registered"

SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.configs.shapes import ShapeSpec
    from repro.launch.steps import build_step
    from repro.models import build_model
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

    def batch(cfg, i):
        data = SyntheticLM(cfg, DataConfig(BATCH, SEQ, 0)).batch_at(i)
        return {{k: jnp.asarray(v) for k, v in data.items()}}

    inits = {{}}
    for name, (arch, shape, kw) in cases.items():
        cfg = get_config(arch).reduced()
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(shape),
                    ("data", "model"))
        built = build_step(cfg, ShapeSpec("t", SEQ, BATCH, "train_step"),
                           mesh, attn_chunk=0,
                           extra_rules={{"seq": ("model",)}}, **kw)
        if arch not in inits:
            inits[arch] = init_train_state(
                build_model(cfg, remat=False).init(jax.random.PRNGKey(0)))
        fn = jax.jit(built.fn, in_shardings=built.in_shardings)
        put = lambda st, i: (jax.device_put(st, built.in_shardings[0]),
                             jax.device_put(batch(cfg, i),
                                            built.in_shardings[1]))
        with mesh:
            s1, _ = fn(*put(inits[arch], 0))
            s2, met = fn(*put(s1, 1))
        np.savez(os.path.join(out_dir, name + ".npz"),
                 **state(s1, "a"), **state(s2, "b"),
                 loss=np.asarray(met["loss"]),
                 grad_norm=np.asarray(met["grad_norm"]),
                 nm=np.asarray(built.meta["n_microbatches"]),
                 seq=np.asarray(str(built.meta["rules"]["seq"])))
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
    return train_state_from_jax(
        _tree(npz, tag + "p"), _Opt(npz[tag + "step"], _tree(npz, tag + "m"),
                                    _tree(npz, tag + "v")), cfg, "cpu")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every case's reference run under the rule, from two subprocesses."""
    out = tmp_path_factory.mktemp("ref_seq_train")
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


def _case(name, npz):
    arch, _, kw = CASES[name]
    cfg = get_config(arch).reduced()
    data = SyntheticLM(cfg, DataConfig(BATCH, SEQ, 0))
    return dict(cfg=cfg, seq_len=SEQ, step_kw=dict(kw, extra_rules=RULE),
                batches=[data.batch_at(1)], state=_state(npz, "a", cfg))


@pytest.fixture(scope="module")
def worlds(ref):
    out = {}
    for shape in sorted({CASES[k][1] for k in CASES}):
        names = [k for k in CASES if CASES[k][1] == shape]
        res = run_ranks(train_cases, shape, DM,
                        args=([_case(k, ref[k]) for k in names],))
        for i, k in enumerate(names):
            out[k] = [r[i] for r in res]
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("name", list(CASES))
def test_seq_train_step_equals_the_reference(ref, worlds, name):
    npz, ranks = ref[name], worlds[name]
    assert str(npz["seq"]) in ("('model',)", "['model']")
    assert ranks[0]["n_microbatches"] == int(npz["nm"])
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    got = ranks[0]["state"]
    assert got.opt.step == int(npz["bstep"])
    for part, tree in (("p", got.params), ("m", got.opt.m),
                       ("v", got.opt.v)):
        want = _flat(_tree(npz, "b" + part))
        mine = _flat(tree)
        assert sorted(want) == sorted(mine)
        for n in want:
            np.testing.assert_allclose(mine[n].float().numpy(), want[n],
                                       atol=1e-5, rtol=0,
                                       err_msg=f"b{part}{n}")
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(ranks[0]["metrics"][0][k],
                                   float(npz[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_the_rank_runs_cut_by_sequence(worlds, name):
    """Each rank's residual stream is its slice of the positions, and the
    cut's gathers and reduce-scatters ran forward and backward."""
    arch, shape, _ = CASES[name]
    for r in worlds[name]:
        assert r["seq"] == "model"
        assert r["residual"][1] == SEQ // shape[1], r["residual"]
        st = r["stats"]
        assert st["gather_calls"] > 0 and st["rs_calls"] > 0, st
        assert not [w for w in r["warnings"] if NO_RULE in w]
