"""The plain reference against the port's CPU path at a reduced size:
the prompt's logits of ``LM.prefill_kv`` and a whole tiny run of each cell,
whose served tokens the reference must find greedy."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness, testing, weights  # noqa: E402
from perfbench.testing import one_thread  # noqa: E402,F401
from perfbench.reference.model import Reference  # noqa: E402

CELLS = ("qwen3-32b-pp2.offline", "cmdr-plus-104b-pp4.rag")

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("name", CELLS)
def test_prefill_logits_match_the_port(name):
    """RMSNorm and an untied head (Qwen3), LayerNorm, g = 2 and a tied
    head (Command R+), at fp32."""
    torch.manual_seed(0)
    cell = testing.tiny_cell(name)
    cfg = harness.arch_config(cell)
    from repro_torch.models import build_model
    model = build_model(cfg, device="cpu")
    params = weights.make_weights(cell.model, 11, "cpu", torch.float32, 0.2)
    prompt = torch.randint(0, cfg.vocab, (1, 37))
    got, _ = model.prefill_kv(params, {"tokens": prompt.int()})
    toks = prompt[0].tolist()
    want = Reference(cell.model, params).served_logits(
        [(toks[:-1], toks[-1:] + [0])])[0]
    # the reference's logits at the prompt's last position
    assert torch.allclose(got[0, :cfg.vocab].float(), want[1], atol=1e-4,
                          rtol=1e-4)


@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_is_greedy_by_the_reference(name):
    cell = testing.tiny_cell(name, limit=1e-4)
    out = harness.run(cell, 2 ** 31 + 99, 0.6, False, torch.device("cpu"),
                      0.0)
    assert out["correct"], out["checks"]
    assert out["checks"]["logit_gap"]["value"] <= 1e-4
    assert list(out["checks"]) == ["logit_gap"]
