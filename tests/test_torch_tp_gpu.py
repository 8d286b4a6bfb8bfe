"""Tensor parallelism on the card: ``(1, 2)`` gloo worlds of two ranks on
card 0, and a ``(1, 4)`` world serving from a cache cut by sequence. ``build_step``'s prefill and serve steps of the reduced qwen3-32b
in fp32 through the CUDA kernels, against the unsplit model on the same
card; and of reduced mamba2 and zamba2 in bf16 (the SSD scan's
tensor-core body at the ranks' local heads), against the same ranks on
the CPU through the plain versions; and a (2, 1, 1) world of the
rank-side PP step against the in-process PP step on the card; and the
row-parallel product's derivative (``matmul_fp32`` under autograd)
against the upcast product on the card. Marked
``gpu``; each test skips inside
its body when there is no card. Imports no JAX (run it with
``--noconftest``)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.steps import serve_cases, serve_generate
from repro_torch.models import build_model


@pytest.mark.gpu
def test_sequence_split_world_on_the_card_equals_the_unsplit_model():
    """A (1, 4) world of reduced qwen3-32b (4 / 2 heads): the serve cache
    cut by sequence, every decode with the lse output, fp32 tokens and
    logits against the unsplit model on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the ranks launch CUDA kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-32b").reduced()
    prompt = np.random.RandomState(1).randint(0, cfg.vocab, (4, 9)).astype(
        np.int32)
    model = build_model(cfg)
    params = model.init(seed=0)
    with torch.no_grad():
        logits, cache = model.prefill(
            params, {"tokens": torch.from_numpy(prompt).cuda()}, max_len=16)
        cur = model.sample_greedy(logits).reshape(4, 1).to(torch.int32)
        toks, step = [cur], []
        for _ in range(3):
            lg, cache = model.decode_step(params, cache, cur)
            cur = model.sample_greedy(lg).to(torch.int32)
            toks.append(cur)
            step.append(lg)
    outs = run_ranks(serve_generate, (1, 4), ("data", "model"),
                     device="cuda", args=(cfg, {"tokens": prompt}, 3, 16))
    for out in outs:
        np.testing.assert_array_equal(out["tokens"],
                                      torch.cat(toks, 1).cpu().numpy())
        np.testing.assert_allclose(out["logits"],
                                   torch.cat(step, 1).cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)
        assert out["cache"]["k"].shape[2:4] == (16 // 4, cfg.n_kv_heads)
        dec = out["launches"]["decode_attention"]
        assert dec == 3 * cfg.n_layers == out["decode_lse_launches"]


@pytest.mark.gpu
def test_tp_world_on_the_card_equals_the_unsplit_model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the ranks launch CUDA kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-32b").reduced()
    prompt = np.random.RandomState(0).randint(0, cfg.vocab, (4, 9)).astype(
        np.int32)
    model = build_model(cfg)
    params = model.init(seed=0)
    with torch.no_grad():
        logits, cache = model.prefill(
            params, {"tokens": torch.from_numpy(prompt).cuda()}, max_len=16)
        cur = model.sample_greedy(logits).reshape(4, 1).to(torch.int32)
        toks, step = [cur], []
        for _ in range(3):
            lg, cache = model.decode_step(params, cache, cur)
            cur = model.sample_greedy(lg).to(torch.int32)
            toks.append(cur)
            step.append(lg)
    want_toks = torch.cat(toks, 1).cpu().numpy()
    want_logits = torch.cat(step, 1).cpu().numpy()
    outs = run_ranks(serve_generate, (1, 2), ("data", "model"),
                     device="cuda", args=(cfg, {"tokens": prompt}, 3, 16))
    for out in outs:
        np.testing.assert_array_equal(out["tokens"], want_toks)
        np.testing.assert_allclose(out["prefill_logits"],
                                   logits.cpu().numpy(), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(out["logits"], want_logits, atol=1e-4,
                                   rtol=1e-4)
        assert out["n_heads_local"] == cfg.n_heads // 2


@pytest.mark.gpu
def test_tp_world_of_the_recurrent_families_on_the_card_equals_the_cpu():
    """Reduced mamba2 and zamba2 in bf16, a prefill and three serve steps
    fed the same tokens, on (1, 2) worlds from the same weights (the
    seed-0 bf16 init, passed as a full tree): the card's ranks (the SSD
    scan on its tensor-core body, zamba2's shared block through flash and
    decode) against the same ranks on the CPU (the plain versions). As
    the smoke holds a bf16 engine: each rank's prefill and step logits
    on the card at most 3x as far from the CPU ranks evaluated in fp32 on
    the same weights as the CPU ranks in bf16 are; its SSD heads half of
    the model's, one scan a layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the ranks launch CUDA kernels)")
    rng = np.random.RandomState(0)
    cases16, cases32 = [], []
    for arch in ("mamba2-1.3b", "zamba2-2.7b"):
        cfg32 = get_config(arch).reduced()
        cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
        params = _numpy(build_model(cfg16, device="cpu").init(seed=0))
        prompt = rng.randint(0, cfg16.vocab, (4, 9)).astype(np.int32)
        feed = rng.randint(0, cfg16.vocab, (4, 3)).astype(np.int32)
        case = dict(inputs={"tokens": prompt}, steps=3, max_len=16,
                    params=params, feed=feed)
        cases16.append(dict(case, cfg=cfg16))
        cases32.append(dict(case, cfg=cfg32))
    card, host16, host32 = (
        run_ranks(serve_cases, (1, 2), ("data", "model"), device=dev,
                  args=(cases,))
        for dev, cases in (("cuda", cases16), ("cpu", cases16),
                           ("cpu", cases32)))

    def err(a, b):
        return float(np.abs(a - b).max())
    for ranks in zip(card, host16, host32):
        for case, got, plain16, plain32 in zip(cases16, *ranks):
            cfg = case["cfg"]
            assert got["ssm_heads_local"] == cfg.ssm_heads // 2
            assert got["launches"]["ssd_scan"] == cfg.n_layers, cfg.name
            for key in ("prefill_logits", "logits"):
                own = err(plain16[key], plain32[key])
                assert err(got[key], plain32[key]) <= 3 * own, \
                    (cfg.name, key, err(got[key], plain32[key]), own)


@pytest.mark.gpu
def test_pp_rank_world_on_the_card_equals_the_in_process_step():
    """A (pod 2, data 1, model 1) gloo world of the rank-side PP step on
    card 0 (the hop staged through the host), reduced qwen3-32b in fp32
    at ``pod_flops=[1.0, 0.5]``, against the in-process PP step of the
    same split and microbatches on the same card, from one random start
    cache: equal tokens and caches over three steps; each stage launches
    ``decode_attention`` m x split[stage] times a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the ranks launch CUDA kernels)")
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.pipeline import (build_pp_serve_step,
                                             pack_pp_params)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-32b").reduced()
    b, seq, pos, steps, flops = 8, 32, 7, 3, [1.0, 0.5]
    params = build_model(cfg, device="cpu").init(seed=0)
    step, meta = build_pp_serve_step(cfg, ShapeSpec("d", seq, b,
                                                    "serve_step"), 2,
                                     pod_flops=flops)
    split, m = meta["pp_split"], meta["n_microbatches"]
    rng = np.random.RandomState(0)
    kv = (2, max(split), m, b // m, seq, cfg.n_kv_heads, cfg.hd)
    k0, v0 = (rng.randn(*kv).astype(np.float32) for _ in range(2))
    tok0 = rng.randint(0, cfg.vocab, (b, 1)).astype(np.int32)
    cache = {"k": torch.from_numpy(k0).cuda(), "v": torch.from_numpy(
        v0).cuda(), "pos": torch.tensor(pos, dtype=torch.int32).cuda()}
    packed = _tree(pack_pp_params(params, split), lambda t: t.cuda())
    cur, toks = torch.from_numpy(tok0).cuda(), []
    with torch.no_grad():
        for _ in range(steps):
            cur, cache = step(packed, cache, cur)
            toks.append(cur.cpu().numpy())
    case = dict(cfg=cfg, inputs={"tokens": tok0}, steps=steps, max_len=seq,
                params=_numpy(params), serve_pp=True,
                cache={"k": k0, "v": v0, "pos": np.int32(pos)},
                pod_flops=flops)
    outs = run_ranks(serve_cases, (2, 1, 1), ("pod", "data", "model"),
                     device="cuda", args=([case],))
    for (got,) in outs:
        s, n = got["stage"], split[got["stage"]]
        np.testing.assert_array_equal(got["tokens"][:, 1:],
                                      np.concatenate(toks, 1))
        for key in ("k", "v"):
            np.testing.assert_allclose(got["cache"][key],
                                       cache[key][s, :n].cpu().numpy(),
                                       atol=1e-5, rtol=1e-5)
        assert got["launches"]["decode_attention"] == steps * m * n


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _numpy(tree):
    """A param tree as fp32 numpy arrays (bf16 values held exactly)."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.float().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("shapes", [((2, 96, 256), (256, 192)),
                                    ((4, 48, 256), (4, 256, 192))],
                         ids=["2d", "batched"])
def test_row_parallel_product_backward_on_the_card(shapes):
    """``matmul_fp32`` under autograd on the card (cuBLAS's fp32-output
    bf16 products, forward and backward) against the upcast fp32 product
    on the same card: the forward within fp32 summation order, the
    gradients within the bf16 rounding of the incoming gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (cuBLAS's fp32-output product)")
    from repro_torch.models.common import matmul_fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = np.random.default_rng(0)
    x0 = torch.from_numpy(gen.standard_normal(shapes[0])).cuda().bfloat16()
    w0 = torch.from_numpy(gen.standard_normal(shapes[1])).cuda().bfloat16()
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    xu, wu = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    y = matmul_fp32(x, w)
    yu = xu.float() @ wu.float()
    assert y.dtype == torch.float32
    assert (y - yu).abs().max().item() <= 1e-4 * yu.abs().max().item()
    g = torch.from_numpy(gen.standard_normal(tuple(y.shape))).float().cuda()
    dx, dw = torch.autograd.grad(y, (x, w), g)
    dxu, dwu = torch.autograd.grad(yu, (xu, wu), g)
    for got, want in ((dx, dxu), (dw, dwu)):
        assert got.dtype == want.dtype == torch.bfloat16
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 1e-2 * want.float().abs().max().item(), err
