"""Tensor parallelism on the card: one ``(1, 2)`` gloo world of two ranks
on card 0, ``build_step``'s prefill and serve steps of the reduced
qwen3-32b in fp32 through the CUDA kernels, against the unsplit model on
the same card. Marked ``gpu``; it skips inside its body when there is no
card. Imports no JAX (run it with ``--noconftest``)."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.steps import serve_generate
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
