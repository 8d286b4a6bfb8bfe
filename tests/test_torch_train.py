"""Training parity, part 1: the port's ``loss`` and its gradients against
the JAX package's ``jax.value_and_grad(model.loss)``, the data pipeline,
the optimizer's pieces and the gradient guard of the kernel wrappers.

Reduced configs in fp32; JAX-initialised params converted through numpy;
batches from ``SyntheticLM`` (the same numpy arrays in both packages),
with and without a ragged mask. The loss agrees within rtol 2e-5; on every
gradient leaf the largest difference is at most 1e-4 x the leaf's largest
reference element + 1e-6 (the float32 sums run in another order; the
1e-6 floor covers leaves whose exact gradient is 0, such as a key bias,
where both packages return rounding noise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.train.data import BinaryTokenFile as JBinary
from repro.train.data import DataConfig as JDataConfig
from repro.train.data import SyntheticLM as JSyntheticLM
from repro.train.optimizer import AdamWConfig as JCfg
from repro.train.optimizer import AdamWState as JState
from repro.train.optimizer import adamw_update as jupdate
from repro.train.train_step import choose_microbatches as jax_choose
from repro_torch.configs import get_config
from repro_torch.kernels import chunk_attention as ca
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kv_probe as kvp
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import build_model
from repro_torch.models.common import lm_cross_entropy
from repro_torch.models.convert import params_from_jax
from repro_torch.train import (AdamWConfig, AdamWState, DataConfig,
                               SyntheticLM, adamw_update, choose_microbatches,
                               init_adamw)
from repro_torch.train.data import BinaryTokenFile, to_torch

ARCHS = ["qwen2-0.5b", "qwen3-32b", "h2o-danube-3-4b",
         "granite-moe-3b-a800m", "qwen2-vl-2b", "mamba2-1.3b",
         "zamba2-2.7b", "whisper-tiny"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg = jax_config(arch).reduced()
    jm = jax_build(jcfg, remat=False, attn_chunk=0)
    jparams = jm.init(jax.random.PRNGKey(0))
    tcfg = get_config(arch).reduced()
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return (jcfg, jm, jparams, jax.jit(jax.value_and_grad(jm.loss)),
            build_model(tcfg, device="cpu"), tparams)


@pytest.mark.parametrize("ragged", [False, True])
def test_loss_and_grads_match_jax(pair, ragged):
    jcfg, jm, jparams, jvg, tm, tparams = pair
    batch = JSyntheticLM(jcfg, JDataConfig(2, 24, 0)).batch_at(1)
    if ragged:
        batch["mask"][0, 19:] = 0.0
        batch["mask"][1, 7:] = 0.0
    jl, jg = jvg(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = _flat(tparams)
    alias = {n: t.detach().requires_grad_(True) for n, t in leaves.items()}

    def tree(node, prefix=""):
        if isinstance(node, dict):
            return {k: tree(v, f"{prefix}/{k}") for k, v in node.items()}
        return alias[prefix]
    tl = tm.loss(tree(tparams), to_torch(batch, "cpu"))
    names = list(alias)
    grads = torch.autograd.grad(tl, [alias[n] for n in names],
                                allow_unused=True)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=2e-5)
    ref = _flat(jax.tree.map(np.asarray, jg))
    assert sorted(ref) == sorted(names)
    for n, g in zip(names, grads):
        r = ref[n]
        got = np.zeros_like(r) if g is None else g.numpy()
        err = np.abs(got - r).max()
        assert err <= 1e-4 * np.abs(r).max() + 1e-6, (n, err)


@pytest.mark.parametrize("arch", ["qwen3-32b", "whisper-tiny"])
def test_remat_changes_no_gradient(arch):
    """``remat`` (the default) recomputes each layer in the backward pass:
    the loss and every gradient equal those of ``remat=False`` exactly."""
    cfg = get_config(arch).reduced()
    params = build_model(cfg, device="cpu").init(seed=0)
    batch = to_torch(SyntheticLM(cfg, DataConfig(2, 12)).batch_at(0), "cpu")
    out = []
    for flag in (True, False):
        alias = {n: t.detach().requires_grad_(True)
                 for n, t in _flat(params).items()}

        def tree(node, prefix=""):
            if isinstance(node, dict):
                return {k: tree(v, f"{prefix}/{k}") for k, v in node.items()}
            return alias[prefix]
        loss = build_model(cfg, device="cpu", remat=flag).loss(
            tree(params), batch)
        out.append((loss, torch.autograd.grad(loss, list(alias.values()))))
    (l1, g1), (l0, g0) = out
    assert torch.equal(l1, l0)
    for a, b in zip(g1, g0):
        assert torch.equal(a, b)


def test_moe_loss_adds_the_load_balancing_term():
    """granite-moe's loss is the cross entropy plus 0.01 x the layers'
    summed load-balancing loss / n_layers (the reference's weighting)."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    m = build_model(cfg, device="cpu")
    params = m.init(seed=0)
    batch = to_torch(SyntheticLM(cfg, DataConfig(2, 16)).batch_at(0), "cpu")
    with torch.no_grad():
        pos = torch.arange(16, dtype=torch.int32)[None].expand(2, 16)
        x, aux = m._run_trunk_full(params, m.embed(params, batch["tokens"]),
                                   pos, collect_kv=False)
        ce = lm_cross_entropy(m.logits(params, m.norm(
            x, params["final_norm"])), batch["targets"], batch["mask"],
            cfg.vocab)
        assert aux["aux"].item() > 0
        torch.testing.assert_close(m.loss(params, batch),
                                   ce + 0.01 * aux["aux"] / cfg.n_layers)


def test_synthetic_batches_equal_the_reference():
    """``SyntheticLM`` draws the reference's numpy batches byte for byte:
    tokens, targets, mask, the enc-dec and vision ``embeds`` and the
    (3, B, S) M-RoPE positions."""
    for arch in ("qwen3-32b", "qwen2-vl-2b", "whisper-tiny"):
        ours = SyntheticLM(get_config(arch).reduced(), DataConfig(3, 20, 7))
        ref = JSyntheticLM(jax_config(arch).reduced(), JDataConfig(3, 20, 7))
        for step in (0, 5):
            a, b = ours.batch_at(step), ref.batch_at(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k])
    it = iter(ours)
    np.testing.assert_array_equal(next(it)["targets"],
                                  ours.batch_at(0)["targets"])


def test_binary_token_file_matches_the_reference(tmp_path):
    path = tmp_path / "toks.bin"
    np.random.RandomState(0).randint(0, 600, 5000).astype(
        np.uint16).tofile(path)
    ours = BinaryTokenFile(str(path), get_config("qwen3-32b").reduced(),
                           DataConfig(4, 32, 3))
    ref = JBinary(str(path), jax_config("qwen3-32b").reduced(),
                  JDataConfig(4, 32, 3))
    for step in (0, 40):
        a, b = ours.batch_at(step), ref.batch_at(step)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("args", [(256, 4096, 256128, 256),
                                  (8, 128, 1000, 256),
                                  (8, 2048, 92544, 1), (64, 4096, 32000, 8),
                                  (3, 100, 50000, 1), (1, 8192, 151936, 1)])
def test_choose_microbatches_equals_the_reference(args):
    assert choose_microbatches(*args) == jax_choose(*args)
    if args == (8, 2048, 92544, 1):
        assert choose_microbatches(*args) == 8


def test_adamw_moments_fp32():
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    st = init_adamw(params)
    assert st.m["w"].dtype == torch.float32 and st.step == 0
    grads = {"w": torch.full((4, 4), 0.1, dtype=torch.bfloat16)}
    # lr large enough that the update survives bf16 rounding near 1.0
    new_p, st2 = adamw_update(AdamWConfig(lr=0.1, warmup_steps=1), grads,
                              st, params)
    assert new_p["w"].dtype == torch.bfloat16
    assert st2.step == 1
    assert not torch.allclose(new_p["w"].float(), torch.ones(4, 4))


def test_adamw_update_equals_the_reference():
    """One update of a matrix and a vector with a clipped gradient
    from a state of step 3, against the reference's ``adamw_update``:
    the clip before the step, warmup on the old step, bias correction on
    the new one, decay on the matrix only."""
    rng = np.random.RandomState(3)
    p = {"w": rng.randn(6, 5).astype(np.float32),
         "b": rng.randn(5).astype(np.float32)}
    g = {k: 3 * rng.randn(*v.shape).astype(np.float32) for k, v in p.items()}
    m = {k: 0.1 * rng.randn(*v.shape).astype(np.float32)
         for k, v in p.items()}
    v = {k: np.abs(0.1 * rng.randn(*x.shape)).astype(np.float32)
         for k, x in p.items()}
    kw = dict(lr=0.02, warmup_steps=10, weight_decay=0.3)
    jp, js = jupdate(JCfg(**kw), {k: jnp.asarray(x) for k, x in g.items()},
                     JState(jnp.asarray(3, jnp.int32),
                            {k: jnp.asarray(x) for k, x in m.items()},
                            {k: jnp.asarray(x) for k, x in v.items()}),
                     {k: jnp.asarray(x) for k, x in p.items()})
    tt = {k: torch.from_numpy(x.copy()) for k, x in p.items()}
    tp, ts = adamw_update(
        AdamWConfig(**kw), {k: torch.from_numpy(x) for k, x in g.items()},
        AdamWState(3, {k: torch.from_numpy(x.copy()) for k, x in m.items()},
                   {k: torch.from_numpy(x.copy()) for k, x in v.items()}),
        tt)
    assert ts.step == int(js.step) == 4
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(ts.m[k].numpy(), np.asarray(js.m[k]),
                                   atol=1e-7, rtol=1e-6)
        np.testing.assert_allclose(ts.v[k].numpy(), np.asarray(js.v[k]),
                                   atol=1e-7, rtol=1e-6)


# -- the gradient guard -------------------------------------------------------
def _wrapper_calls():
    """Every kernel wrapper without a backward, called directly on inputs
    that require grad (the guard runs before the device check, so it
    fires here on the CPU as on the card)."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)
    q, qc = r(2, 1, 4, 16).requires_grad_(), r(2, 3, 4, 16).requires_grad_()
    ck, cv = r(2, 32, 2, 16).requires_grad_(), r(2, 32, 2, 16)
    tbl = torch.ones((2, 2), dtype=torch.int32)
    x = r(1, 8, 2, 16).requires_grad_()
    return {
        "decode_attention_paged": lambda: da.decode_attention_paged(
            q, ck, cv, tbl, 5),
        "decode_attention": lambda: da.decode_attention(q, ck, cv, 5),
        "chunk_attention_paged": lambda: ca.chunk_attention_paged(
            qc, ck, cv, tbl, 4),
        "chunk_attention": lambda: ca.chunk_attention(qc, ck, cv, 4),
        "kv_probe": lambda: kvp.kv_probe(ck, cv, None, 0, 3, 4),
        "ssd_scan": lambda: ssd.ssd_scan(x, r(1, 8, 2), r(2), r(1, 8, 16),
                                         r(1, 8, 16), chunk=4),
        "flash_attention": lambda: fa.flash_attention(qc, ck, cv),
    }


@pytest.mark.parametrize("name", ["decode_attention_paged",
                                  "decode_attention",
                                  "chunk_attention_paged", "chunk_attention",
                                  "kv_probe", "ssd_scan", "flash_attention"])
def test_kernel_wrapper_refuses_gradients(name):
    """A kernel wrapper never returns an output that silently drops the
    gradient: with autograd recording a gradient of an input it raises,
    naming the autograd function that trains through it (the SSD scan's
    is ``SsdScanFn``, flash attention's ``FlashAttentionFn``) or saying
    that it is a serving kernel; under ``torch.no_grad()`` the guard lets
    the call through (to the CUDA device check here)."""
    call = _wrapper_calls()[name]
    missing = {"ssd_scan": "SsdScanFn",
               "flash_attention": "FlashAttentionFn"}.get(name, "serving")
    with pytest.raises(RuntimeError, match=missing):
        call()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        call()


def test_cpu_dispatch_is_differentiable():
    """On the CPU nothing changes: ``ops`` sends CPU tensors to the plain
    versions, whose gradients autograd takes as they are (the flash
    backward's plain version is that gradient)."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(s, generator=g, requires_grad=True)
               for s in ((2, 9, 4, 16), (2, 9, 2, 16), (2, 9, 2, 16)))
    out = ops.flash_attention(q, k, v, causal=True, window=4)
    dout = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad(out, (q, k, v), dout)
    ref = fa.flash_attention_bwd_plain(q, k, v, dout, causal=True, window=4)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b)
    assert fa.launch_counts["flash_attention_bwd"] == 0
    lse = fa.flash_lse_plain(q, k, causal=True, window=4)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(2, 2)) / 4
    keep = torch.ones(9, 9).tril().bool() & ~torch.ones(9, 9).tril(-4).bool()
    nat = torch.logsumexp(s.masked_fill(~keep, -1e30), -1)
    torch.testing.assert_close(lse, nat / np.log(2))
