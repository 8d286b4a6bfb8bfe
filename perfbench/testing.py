"""Cells at a tiny size for the CPU tests: a real cell's configuration and
mix with the model and the traffic shrunk, run by the same harness."""

from __future__ import annotations

import copy

import pytest
import torch

from perfbench import harness

TINY_MODEL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
              "head_dim": 16, "d_ff": 128, "vocab": 512,
              "vocab_pad_multiple": 8}


def tiny_cell(name: str, dtype: str = "float32", std: float = 0.2,
              limit: float = 1e-3) -> harness.Cell:
    """``name``'s cell with the model cut to ``TINY_MODEL`` (in
    ``dtype``), 4 rows of at most 256 positions, and prompts of 8-64
    tokens with 2-16 new ones; the limit of the logit gap is ``limit``."""
    cell = harness.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(TINY_MODEL, dtype=dtype)
    rep = {k: v for k, v in TINY_MODEL.items()}
    cfg["repro_torch"]["replace"] = dict(rep, dtype=dtype)
    cfg["init_std"] = std
    cfg["limits"] = {"logit_gap": limit}
    cfg["engine"].update(max_batch=4, max_len=256)
    mix = copy.deepcopy(cell.traffic)
    mix["input"] = {"mean": 24, "sigma": 0.9, "lo": 8, "hi": 64}
    mix["output"] = {"mean": 8, "sigma": 0.9, "lo": 2, "hi": 16}
    mix["block"] = 16
    mix["check"] = {"served_tokens": 40, "max_requests": 4}
    mix["trace_s"] = 0.3
    if mix["engine"].get("prefill_chunk"):
        mix["engine"]["prefill_chunk"] = 16
    return harness.Cell(cell.name, cell.chips, cfg, mix, cell.e2e,
                        cell.per_layer)


@pytest.fixture
def one_thread():
    """One intra-op thread while a test drives a tiny run: the runs are
    timed, and the test suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
