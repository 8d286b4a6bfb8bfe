"""Training parity, part 2: one ``make_train_step`` step against the JAX
package's from the same ``TrainState``, the reference's training tests
mirrored on the port, checkpoints, and the ``repro_torch.launch.train``
driver, on the CPU.

The step: reduced qwen3-32b (GQA, qk-norm) and granite-moe (the aux loss)
in fp32, the reference's AdamW defaults, 1 and 2 microbatches, gradient
compression on and off, from the state the reference leaves after one
step of its own (non-zero moments, step 1), converted with
``train_state_from_jax``. Loss and ``grad_norm`` agree within rtol 1e-5,
every parameter, ``m`` and ``v`` leaf within 1e-5 absolute (the fp32 sums
run in another order; with compression a gradient element that lands
within rounding of a bf16 tie may round the other way), and ``step`` is
equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.train.data import DataConfig as JDataConfig
from repro.train.data import SyntheticLM as JSyntheticLM
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.train_step import init_train_state as jax_init_state
from repro.train.train_step import make_train_step as jax_make_step
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.convert import train_state_from_jax
from repro_torch.train import (AdamWConfig, DataConfig, SyntheticLM,
                               TrainState, checkpoint as ckpt,
                               init_train_state, make_train_step)
from repro_torch.train.data import to_torch
from repro_torch.train.optimizer import leaves


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module", params=["qwen3-32b", "granite-moe-3b-a800m"])
def stepper(request):
    arch = request.param
    jcfg = jax_config(arch).reduced()
    jm = jax_build(jcfg, remat=True, attn_chunk=0)
    jparams = jm.init(jax.random.PRNGKey(0))
    batch = JSyntheticLM(jcfg, JDataConfig(4, 16, 0)).batch_at(2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tcfg = get_config(arch).reduced()
    return jm, jparams, jbatch, batch, tcfg, build_model(tcfg, device="cpu")


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("compress", [True, False])
def test_train_step_matches_jax(stepper, n_micro, compress):
    jm, jparams, jbatch, batch, tcfg, tm = stepper
    jstep = jax.jit(jax_make_step(
        jm, JAdamWConfig(compress_grads_bf16=compress), n_micro))
    js, _ = jstep(jax_init_state(jparams), jbatch)
    start = jax.tree.map(np.asarray, js)
    js2, jmet = jstep(js, jbatch)
    ts = train_state_from_jax(start.params, start.opt, tcfg, "cpu")
    ts2, tmet = make_train_step(
        tm, AdamWConfig(compress_grads_bf16=compress), n_micro)(
            ts, to_torch(batch, "cpu"))
    np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(tmet["grad_norm"].item(),
                               float(jmet["grad_norm"]), rtol=1e-5)
    assert ts2.opt.step == int(js2.opt.step) == 2
    for jt, tt in ((js2.params, ts2.params), (js2.opt.m, ts2.opt.m),
                   (js2.opt.v, ts2.opt.v)):
        ref, got = _flat(jax.tree.map(np.asarray, jt)), _flat(tt)
        assert sorted(ref) == sorted(got)
        for n in ref:
            np.testing.assert_allclose(got[n].numpy(), ref[n], atol=1e-5,
                                       rtol=0, err_msg=n)


# -- the reference's training tests, mirrored ---------------------------------
@pytest.fixture(scope="module")
def small():
    cfg = get_config("qwen2-0.5b").reduced()
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init(seed=0)


def _batch(cfg, b=4, s=32, step=0):
    return to_torch(SyntheticLM(cfg, DataConfig(b, s)).batch_at(step), "cpu")


def _copy(params):
    return {k: _copy(v) if isinstance(v, dict) else v.clone()
            for k, v in params.items()}


def test_loss_decreases(small):
    cfg, model, params = small
    state = init_train_state(_copy(params))
    step = make_train_step(model, AdamWConfig(lr=1e-2, warmup_steps=1))
    batch = _batch(cfg)                  # same batch => must overfit
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0] - 0.2, losses


def test_grad_accum_equivalent(small):
    """n_micro=2 (no bf16 compression) == n_micro=1 loss / update."""
    cfg, model, params = small
    oc = AdamWConfig(compress_grads_bf16=False)
    batch = _batch(cfg)
    s1, m1 = make_train_step(model, oc, 1)(init_train_state(_copy(params)),
                                           batch)
    s2, m2 = make_train_step(model, oc, 2)(init_train_state(_copy(params)),
                                           batch)
    assert m1["loss"].item() == pytest.approx(m2["loss"].item(), rel=1e-4)
    d = max((a.float() - b.float()).abs().max().item()
            for a, b in zip(leaves(s1.params), leaves(s2.params)))
    assert d < 5e-3


def test_train_step_splits_mrope_positions():
    """The (3, B, S) positions split along their batch axis: qwen2-vl's
    step from ``embeds`` over 2 microbatches equals one of 1 (no
    compression)."""
    cfg = get_config("qwen2-vl-2b").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(seed=0)
    batch = _batch(cfg, b=4, s=12)
    assert batch["positions"].shape == (3, 4, 12)
    oc = AdamWConfig(compress_grads_bf16=False)
    s1, m1 = make_train_step(model, oc, 1)(init_train_state(_copy(params)),
                                           batch)
    s2, m2 = make_train_step(model, oc, 2)(init_train_state(_copy(params)),
                                           batch)
    assert m1["loss"].item() == pytest.approx(m2["loss"].item(), rel=1e-5)
    for a, b in zip(leaves(s1.params), leaves(s2.params)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_train_step_leaves_params_without_grad(small):
    """The step's state never requires grad, so the same params serve
    through the kernels afterwards (whose wrappers refuse gradients)."""
    cfg, model, params = small
    state, _ = make_train_step(model)(init_train_state(_copy(params)),
                                      _batch(cfg))
    assert not any(t.requires_grad for t in leaves(state.params))
    assert not any(t.requires_grad for t in leaves(state.opt.m))


# -- checkpoints --------------------------------------------------------------
def _state(small):
    cfg, model, params = small
    state, _ = make_train_step(model)(init_train_state(_copy(params)),
                                      _batch(cfg))
    return state


def _equal(a, b):
    assert type(a) is type(b) or isinstance(a, tuple)
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (n, x), (_, y) in zip(fa, fb):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and x.device == y.device, n
            assert torch.equal(x, y), n
        else:
            assert x == y, n


def test_checkpoint_roundtrip(tmp_path, small):
    state = _state(small)
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, 7, state)
    assert ckpt.latest_step(d) == 7
    restored = ckpt.restore_checkpoint(d, 7, init_train_state(
        _copy(small[2])))
    assert isinstance(restored, TrainState) and restored.opt.step == 1
    _equal(state, restored)


def test_checkpoint_roundtrip_bf16(tmp_path):
    """bf16 leaves are stored as their 16-bit words, manifest dtype
    ``bfloat16``, and come back bit for bit."""
    cfg = get_config("qwen2-0.5b").reduced()
    cfg = cfg.__class__(**{**cfg.__dict__, "dtype": "bfloat16"})
    model = build_model(cfg, device="cpu")
    state, _ = make_train_step(model)(init_train_state(model.init(seed=1)),
                                      _batch(cfg, b=2, s=8))
    d = str(tmp_path / "ck")
    path = ckpt.save_checkpoint(d, 3, state)
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    kinds = {e["dtype"] for e in manifest["leaves"]}
    assert kinds == {"bfloat16", "float32", "int64"}
    like = init_train_state(model.init(seed=2))
    _equal(state, ckpt.restore_checkpoint(d, 3, like))


def test_checkpoint_rotation_and_atomicity(tmp_path, small):
    state = _state(small)
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4):
        ckpt.save_checkpoint(d, s, state, keep=2)
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]
    assert not [x for x in os.listdir(d) if x.startswith(".tmp")]
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_checkpoint_digest_detects_corruption(tmp_path, small):
    state = _state(small)
    d = str(tmp_path / "ck")
    path = ckpt.save_checkpoint(d, 1, state)
    victim = sorted(f for f in os.listdir(path) if f.endswith(".npy"))[0]
    arr = np.load(os.path.join(path, victim)).copy()
    arr.flat[0] = arr.flat[0] + 1
    np.save(os.path.join(path, victim), arr)
    with pytest.raises(IOError):
        ckpt.restore_checkpoint(d, 1, state)


# -- the launcher --------------------------------------------------------------
def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train --reduced --device cpu`` runs
    three steps with a checkpoint, then ``--resume`` picks up at step 3
    and finishes at 5; the resumed run's state equals an uninterrupted
    five-step run's."""
    d = str(tmp_path / "ck")
    base = ["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu",
            "--batch", "4", "--seq", "16", "--microbatches", "2",
            "--ckpt-every", "2"]
    first = launch_train.main(base + ["--steps", "3", "--ckpt-dir", d])
    assert len(first) == 3 and all(np.isfinite(first))
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000003"]
    launch_train.main(base + ["--steps", "5", "--ckpt-dir", d, "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "[train] done" in out
    assert ckpt.latest_step(d) == 5
    whole = str(tmp_path / "whole")
    launch_train.main(base + ["--steps", "5", "--ckpt-dir", whole])
    cfg = get_config("internlm2-1.8b").reduced()
    like = init_train_state(build_model(cfg, device="cpu").init(seed=3))
    _equal(ckpt.restore_checkpoint(d, 5, like),
           ckpt.restore_checkpoint(whole, 5, like))


def test_launcher_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "internlm2-1.8b", "--reduced",
                           "--steps", "1"])
