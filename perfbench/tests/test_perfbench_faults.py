"""A run with its timed path broken underneath must come out not correct:
the harness's look for a card is skipped and the rest of a run is driven
on the CPU at a tiny size, once sound and once for each fault a serving
cell can have (a token altered where it is produced; a decode step that
leaves the KV cache unchanged; half of the batch left out). One card, so
no exchange between cards can be left out."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness, testing  # noqa: E402
from perfbench.testing import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")


def altered_token(drv):
    orig, calls = drv.eng.model.sample_greedy, [0]

    def sample(logits):
        calls[0] += 1
        t = orig(logits)
        return (t + 1) % drv.eng.cfg.vocab if calls[0] % 4 == 0 else t
    drv.eng.model.sample_greedy = sample


def unchanged_cache(drv):
    import repro_torch.models.attention as attn
    drv.restore = (attn, attn.cache_write_token_paged)
    attn.cache_write_token_paged = lambda *a, **k: None


def half_batch(drv):
    model = drv.eng.model
    orig = model.decode_step

    def decode_step(params, cache, tokens):
        logits, cache = orig(params, cache, tokens)
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0
        return logits, cache
    model.decode_step = decode_step


FAULTS = {"altered_token": altered_token, "unchanged_cache": unchanged_cache,
          "half_batch": half_batch}


def run(name, patch=None):
    seen = {}

    def keep(drv):
        seen["drv"] = drv
        if patch is not None:
            patch(drv)
    try:
        cell = testing.tiny_cell(name)
        # every finished request judged: a fault in half of the rows shows
        # in any run, not only where the sample draws from that half
        cell.traffic["check"] = {"served_tokens": 10 ** 6,
                                 "max_requests": 10 ** 6}
        return harness.run(cell,
                           2 ** 32 + 7, 1.5, False,
                           torch.device("cpu"), 0.0, patch=keep)
    finally:
        undo = getattr(seen.get("drv"), "restore", None)
        if undo is not None:
            setattr(undo[0], "cache_write_token_paged", undo[1])


@pytest.mark.parametrize("name", ["qwen3-32b-pp2.offline",
                                  "cmdr-plus-104b-pp4.rag"])
@pytest.mark.parametrize("fault", [None] + sorted(FAULTS))
def test_fault_fails_the_check(name, fault):
    out = run(name, FAULTS.get(fault))
    assert out["correct"] == (fault is None), (fault, out["checks"])
