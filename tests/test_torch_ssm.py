"""SSM parity: the port's SSD scan, Mamba2 block, mamba2 LM and the SSM /
hybrid engines (plain PyTorch on the CPU) against the JAX reference.

* ``ssd_scan_plain`` (the CUDA kernel's plain version) against the Pallas
  ``ssd_scan`` in interpret mode, the reference's ``ssd_chunked`` (with an
  initial state too) and the sequential recurrence, at the shapes of
  tests/test_kernels.py and a ragged one, fp32 2e-5 / bf16 2e-2 (the
  reference's tolerances);
* ``mamba2_prefill`` / ``mamba2_step`` / ``ssd_step`` against
  ``repro.models.ssm`` on JAX-initialised layer params;
* the reduced mamba2-1.3b LM: prefill logits, conv / ssd cache state and a
  chain of decode steps against the JAX LM on params from
  ``params_from_jax`` (fp32 2e-5);
* the Engine on reduced mamba2-1.3b and zamba2-2.7b against the JAX Engine
  (``use_pallas=False``, ``model_kw={"ssd_chunk": 4}`` so prompts span
  several SSD chunks): identical greedy tokens and every scheduling
  counter, with more requests than slots and equal-length prompts batched
  into one group; ``kv_layout="paged"`` and ``prefill_chunk`` raise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ref as kref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro.models import build_model as jax_build
from repro.models import ssm as jssm
from repro.serving import Engine as JaxEngine
from repro.serving import ServeRequest as JaxRequest
from repro_torch.configs import get_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import build_model
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import Engine, ServeRequest

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = dict(atol=2e-5, rtol=2e-5)
STATS = ("prefills", "prefill_batches", "prefill_chunks", "chunk_direct",
         "chunk_scatters", "block_grows", "preemptions", "kv_imports",
         "alloc_failures", "decode_steps", "tokens_out", "admit_deferred")


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else TOL


def _close(t, j, **tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL))


def _ssd_inputs(rng, b, s, nh, hd, n):
    """The reference tests' distributions, as numpy."""
    return (rng.randn(b, s, nh, hd).astype(np.float32) * 0.5,
            (np.abs(rng.randn(b, s, nh)) * 0.1 + 0.01).astype(np.float32),
            (-np.abs(rng.randn(nh)) - 0.1).astype(np.float32),
            rng.randn(b, s, n).astype(np.float32) * 0.3,
            rng.randn(b, s, n).astype(np.float32) * 0.3)


def _both(arrays, name):
    """(jax arrays, torch tensors): x, b, c in the case's dtype, dt and a
    fp32, as the model feeds the scan."""
    jd, td = DTYPES[name]
    x, dt, a, b, c = arrays
    j = (jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(a),
         jnp.asarray(b, jd), jnp.asarray(c, jd))
    t = (torch.from_numpy(x).to(td), torch.from_numpy(dt),
         torch.from_numpy(a), torch.from_numpy(b).to(td),
         torch.from_numpy(c).to(td))
    return j, t


SSD_SHAPES = [(2, 128, 4, 16, 32, 32),
              (1, 100, 8, 64, 128, 64),      # ragged S (padding path)
              (2, 64, 2, 32, 64, 64),        # one chunk
              (2, 37, 3, 16, 16, 16)]        # ragged, several chunks


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,nh,hd,n,chunk", SSD_SHAPES)
def test_ssd_scan_plain_matches_pallas_and_chunked(b, s, nh, hd, n, chunk,
                                                   dtype):
    rng = np.random.RandomState(s + nh)
    j, t = _both(_ssd_inputs(rng, b, s, nh, hd, n), dtype)
    y, h = tssd.ssd_scan_plain(*t, chunk=chunk)
    assert y.dtype == t[0].dtype and h.dtype == torch.float32
    assert tuple(y.shape) == (b, s, nh, hd) and tuple(h.shape) == (b, nh,
                                                                   hd, n)
    for jy, jh in (pallas_ssd_scan(*j, chunk=chunk, interpret=True),
                   kref.ssd_scan_ref(*j, chunk=chunk)):
        _close(y, jy, **_tol(dtype))
        _close(h, jh, **_tol(dtype))
    # the dispatch takes the plain version for CPU tensors, launching nothing
    n0 = tssd.launch_counts["ssd_scan"]
    y2, h2 = tops.ssd_scan(*t, chunk=chunk)
    assert tssd.launch_counts["ssd_scan"] == n0
    torch.testing.assert_close(y2, y, rtol=0, atol=0)
    torch.testing.assert_close(h2, h, rtol=0, atol=0)


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_scan_plain_with_initial_state(chunk):
    """``h0`` carries in as in the reference's ``ssd_chunked``, and a scan
    split at a chunk boundary equals one scan over the whole sequence."""
    rng = np.random.RandomState(7)
    b, s, nh, hd, n = 2, 100, 4, 16, 32
    j, t = _both(_ssd_inputs(rng, b, s, nh, hd, n), "float32")
    h0 = rng.randn(b, nh, hd, n).astype(np.float32) * 0.2
    y, h = tssd.ssd_scan_plain(*t, chunk=chunk, h0=torch.from_numpy(h0))
    jy, jh = jssm.ssd_chunked(*j, chunk=chunk, h0=jnp.asarray(h0))
    _close(y, jy)
    _close(h, jh)
    y_all, h_all = tssd.ssd_scan_plain(*t, chunk=chunk)
    cut = 2 * chunk if 2 * chunk < s else chunk
    first = [a[:, :cut] if a.ndim > 1 else a for a in t]
    rest = [a[:, cut:] if a.ndim > 1 else a for a in t]
    y1, h1 = tssd.ssd_scan_plain(*first, chunk=chunk)
    y2, h2 = tssd.ssd_scan_plain(*rest, chunk=chunk, h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_all, **TOL)
    torch.testing.assert_close(h2, h_all, **TOL)


def test_ssd_scan_plain_matches_sequential():
    """Chunked == the O(S) recurrence, in the port (``ssd_scan_sequential``)
    and against the reference's ``ssd_scan_sequential_ref``."""
    rng = np.random.RandomState(42)
    j, t = _both(_ssd_inputs(rng, 2, 48, 3, 8, 16), "float32")
    yc, hc = tssd.ssd_scan_plain(*t, chunk=16)
    ys, hs = tssd.ssd_scan_sequential(*t)
    torch.testing.assert_close(yc, ys, atol=1e-5, rtol=0)
    torch.testing.assert_close(hc, hs, atol=1e-5, rtol=0)
    jy, jh = kref.ssd_scan_sequential_ref(*j)
    _close(ys, jy)
    _close(hs, jh)


def test_ssd_scan_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back: CPU tensors are the dispatch's
    business, the wrapper takes CUDA tensors only."""
    rng = np.random.RandomState(0)
    _, t = _both(_ssd_inputs(rng, 1, 8, 2, 16, 16), "float32")
    with pytest.raises(ValueError):
        tssd.ssd_scan(*t, chunk=8)
    with pytest.raises(ValueError):
        tssd.ssd_scan(*t, chunk=tssd.MAX_CHUNK + 1)


# -- the Mamba2 block ------------------------------------------------------------

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


def _mixer(name, layer=1):
    jcfg, jparams, tcfg, tparams = _arch(name)
    jp = jax.tree.map(lambda a: a[layer], jparams["layers"]["mixer"])
    tp = {k: v[layer] for k, v in tparams["layers"]["mixer"].items()}
    dims = (tcfg.d_inner, tcfg.ssm_state, tcfg.ssm_heads, tcfg.ssm_head_dim)
    return jp, tp, tcfg, dims


@pytest.mark.parametrize("s,chunk", [(2, 4), (21, 8), (40, 16)])
def test_mamba2_prefill_and_step_match_jax(s, chunk):
    """Prefill (including a prompt shorter than the conv window, whose conv
    state is left-padded) then three recurrent steps."""
    jp, tp, cfg, dims = _mixer("mamba2-1.3b")
    rng = np.random.RandomState(s)
    x = rng.randn(2, s, cfg.d_model).astype(np.float32)
    jy, jst = jssm.mamba2_prefill(jp, jnp.asarray(x), *dims, chunk=chunk)
    ty, tst = tssm.mamba2_prefill(tp, torch.from_numpy(x), *dims,
                                  chunk=chunk)
    _close(ty, jy)
    _close(tst.conv, jst.conv)
    _close(tst.ssd, jst.ssd)
    assert tuple(tst.conv.shape) == (2, cfg.conv_width - 1,
                                     cfg.d_inner + 2 * cfg.ssm_state)
    # the conv state owns its storage: a view would keep the layer's whole
    # in-projection alive until the trunk stacks the layers' states
    assert tst.conv.untyped_storage().nbytes() == \
        tst.conv.numel() * tst.conv.element_size()
    for _ in range(3):
        x1 = rng.randn(2, 1, cfg.d_model).astype(np.float32)
        jy, jst = jssm.mamba2_step(jp, jnp.asarray(x1), jst, *dims)
        ty, tst = tssm.mamba2_step(tp, torch.from_numpy(x1), tst, *dims)
        _close(ty, jy)
        _close(tst.conv, jst.conv)
        _close(tst.ssd, jst.ssd)


def test_ssd_step_matches_jax():
    rng = np.random.RandomState(3)
    b, nh, hd, n = 2, 3, 8, 16
    x = rng.randn(b, nh, hd).astype(np.float32)
    dt = (np.abs(rng.randn(b, nh)) * 0.1 + 0.01).astype(np.float32)
    a = (-np.abs(rng.randn(nh)) - 0.1).astype(np.float32)
    bm, cm = (rng.randn(b, n).astype(np.float32) for _ in range(2))
    h = rng.randn(b, nh, hd, n).astype(np.float32)
    jy, jh = jssm.ssd_step(*(jnp.asarray(v) for v in (x, dt, a, bm, cm, h)))
    ty, th = tssm.ssd_step(*(torch.from_numpy(v)
                             for v in (x, dt, a, bm, cm, h)))
    _close(ty, jy)
    _close(th, jh)


def test_mamba_inits_match_the_reference():
    """``mamba_alog`` is the reference's deterministic linspace; ``mamba_dt``
    draws from the explicit generator with softplus(dt_bias) in
    [1e-3, 1e-1]; a seed fixes both."""
    cfg = get_config("mamba2-1.3b").reduced()
    m = build_model(cfg, device="cpu")
    p, q = m.init(seed=5), m.init(seed=5)
    mix = p["layers"]["mixer"]
    torch.testing.assert_close(mix["dt_bias"], q["layers"]["mixer"]["dt_bias"],
                               rtol=0, atol=0)
    _, jparams, _, _ = _arch("mamba2-1.3b")
    _close(mix["a_log"], jparams["layers"]["mixer"]["a_log"])
    dt = torch.nn.functional.softplus(mix["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    assert torch.all(mix["d_skip"] == 1) and torch.all(mix["conv_b"] == 0)


# -- the mamba2 LM ---------------------------------------------------------------

def _models(name, ssd_chunk=4):
    jcfg, jparams, tcfg, tparams = _arch(name)
    jm = jax_build(jcfg, remat=False, attn_chunk=0, ssd_chunk=ssd_chunk)
    tm = build_model(tcfg, device="cpu", ssd_chunk=ssd_chunk)
    return jm, jparams, tm, tparams


def _lm_parity(name):
    """Prefill into a fresh contiguous cache, then decode steps with per-row
    positions: logits and every cache entry match the JAX LM."""
    jm, jparams, tm, tparams = _models(name)
    rng = np.random.RandomState(11)
    toks = rng.randint(0, tm.cfg.vocab, (2, 13)).astype(np.int32)
    jl, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                            max_len=24, ring=False)
    tl, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                            max_len=24)
    _close(tl, jl)
    assert sorted(tcache) == sorted(jcache)
    for key in tcache:
        _close(tcache[key], jcache[key])
    jcache["pos"] = jnp.asarray(np.asarray(tcache["pos"]))
    for _ in range(4):
        nxt = rng.randint(0, tm.cfg.vocab, (2, 1)).astype(np.int32)
        jl, jcache = jm.decode_step(jparams, jcache, jnp.asarray(nxt))
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(nxt))
        _close(tl, jl)
        for key in tcache:
            _close(tcache[key], jcache[key])
    return tm, tcache


def test_mamba2_lm_prefill_decode_match_jax():
    tm, cache = _lm_parity("mamba2-1.3b")
    c = tm.cfg
    assert sorted(cache) == ["conv", "pos", "ssd"]
    assert cache["ssd"].dtype == torch.float32
    assert tuple(cache["ssd"].shape) == (c.n_layers, 2, c.ssm_heads,
                                         c.ssm_head_dim, c.ssm_state)
    assert cache["pos"].tolist() == [17, 17]


def test_mamba2_param_tree_converts_unchanged():
    """The mamba tree takes ``params_from_jax``'s walk as it is: the same
    names, leaves equal, no ``shared`` block and no attention."""
    _, jparams, tcfg, tparams = _arch("mamba2-1.3b")
    assert sorted(tparams["layers"]) == ["ln", "mixer"]
    assert "shared" not in tparams and "lm_head" not in tparams
    for key, leaf in tparams["layers"]["mixer"].items():
        np.testing.assert_array_equal(
            leaf.numpy(), np.asarray(jparams["layers"]["mixer"][key]))
    m = build_model(tcfg, device="cpu")
    assert jax.tree.map(lambda x: tuple(x.shape), jparams) == \
        m.param_shapes()


# -- the engine, both recurrent families -------------------------------------

RECURRENT = ["mamba2-1.3b", "zamba2-2.7b"]


def _serve_all(eng, reqs):
    left = list(reqs)
    while left:
        taken = {id(r) for r in eng.admit_many(left)}
        left = [r for r in left if id(r) not in taken]
        eng.drain()
    return reqs


def _more_than_slots(eng, Req):
    """Five requests on two slots; the first two share a length and so one
    group."""
    lens = [9, 9, 13, 6, 13]
    return _serve_all(eng, [Req(prompt=[1 + (i + t) % 97 for t in range(n)],
                                max_new_tokens=3 + i)
                            for i, n in enumerate(lens)])


def _equal_length_group(eng, Req):
    """Three prompts of one length become one group of 3 (prefill_batches
    counts 1 for them), next to a solo prompt; then a late arrival while
    the group decodes."""
    rs = [Req(prompt=[3 + i, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], max_new_tokens=6)
          for i in range(3)] + [Req(prompt=[2, 7, 1, 8], max_new_tokens=9)]
    assert len(eng.admit_many(rs)) == 4
    eng.step()
    late = Req(prompt=list(range(5, 22)), max_new_tokens=4)
    assert eng.admit(late)
    eng.drain()
    return rs + [late]


def _long_prompts(eng, Req):
    """Prompts of 30-41 tokens span 8-11 SSD chunks of 4; a
    ``prefill_chunk`` is set and must not chunk them."""
    return _serve_all(eng, [Req(prompt=[(7 * t + i) % 101 + 1
                                        for t in range(30 + 11 * (i % 2))],
                                max_new_tokens=5) for i in range(4)])


ENGINE_SCENARIOS = {
    "more_than_slots": (_more_than_slots, dict(max_batch=2, max_len=48)),
    "equal_length_group": (_equal_length_group,
                           dict(max_batch=5, max_len=48, prefill_group=3)),
    "long_prompts": (_long_prompts, dict(max_batch=3, max_len=64,
                                         prefill_chunk=8)),
}


def _run_both(name, scenario, kw):
    jcfg, jparams, tcfg, tparams = _arch(name)
    model_kw = {"ssd_chunk": 4}
    je = JaxEngine(jcfg, jparams, use_pallas=False, victim_policy="fewest",
                   model_kw=model_kw, **kw)
    te = Engine(tcfg, tparams, device="cpu", victim_policy="fewest",
                model_kw=model_kw, **kw)
    jreqs = scenario(je, JaxRequest)
    treqs = scenario(te, ServeRequest)
    assert [list(r.generated) for r in treqs] == \
        [list(r.generated) for r in jreqs]
    assert all(r.done for r in treqs)
    for field in STATS:
        assert getattr(te.stats, field) == getattr(je.stats, field), field
    assert te.kv_layout == je.kv_layout == "contig"
    assert te._group == je._group
    return te


@pytest.mark.parametrize("arch", RECURRENT)
@pytest.mark.parametrize("name", sorted(ENGINE_SCENARIOS))
def test_recurrent_engine_matches_jax(arch, name):
    scenario, kw = ENGINE_SCENARIOS[name]
    te = _run_both(arch, scenario, kw)
    assert te.bm is None and te.model.ssd_chunk == 4
    assert te.stats.prefill_chunks == 0
    if name == "equal_length_group":
        # 3 equal-length prompts share one dispatch; the solo and the
        # late arrival take one each
        assert te.stats.prefill_batches == 3 and te.stats.prefills == 5
    if name == "more_than_slots":
        assert te.stats.prefill_batches < te.stats.prefills


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_families_refuse_paged_and_chunked_prefill(arch):
    _, _, tcfg, tparams = _arch(arch)
    with pytest.raises(ValueError):
        Engine(tcfg, tparams, device="cpu", kv_layout="paged")
    tm = build_model(tcfg, device="cpu")
    with pytest.raises(ValueError):
        tm.init_cache(2, 16, kv_layout="paged")
    cache = tm.init_cache(2, 16)
    with pytest.raises(ValueError):
        tm.prefill_chunk(tparams, cache, torch.zeros((2, 4),
                                                     dtype=torch.long), 0)
    eng = Engine(tcfg, tparams, device="cpu", max_len=32, prefill_chunk=4)
    assert eng.kv_layout == "contig" and eng._bucket(13) == 13
    assert not eng._use_chunked(20)
