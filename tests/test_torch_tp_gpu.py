"""Tensor parallelism on the card: ``(1, 2)`` gloo worlds of two ranks on
card 0. ``build_step``'s prefill and serve steps of the reduced qwen3-32b
in fp32 through the CUDA kernels, against the unsplit model on the same
card; and of reduced mamba2 and zamba2 in bf16 (the SSD scan's
tensor-core body at the ranks' local heads), against the same ranks on
the CPU through the plain versions. Marked ``gpu``; each test skips inside
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


def _numpy(tree):
    """A param tree as fp32 numpy arrays (bf16 values held exactly)."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.float().numpy()
