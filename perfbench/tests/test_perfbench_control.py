"""The control at a size a test run can hold: the port serving in bfloat16 on
the CPU passes the check, and the reference computed in float8 in its place
fails it, on three seeds (the chip's readings at the cells' own sizes are
in PERF.md). The engine drains a fixed set of requests, so what is judged
does not depend on the host's speed."""

import itertools
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import check, harness, loadgen, testing  # noqa: E402
from perfbench import weights as wmod  # noqa: E402
from perfbench.reference.model import Reference  # noqa: E402
from perfbench.testing import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

LIMIT = 0.2     # at this size: sound bf16 runs read 0-0.03, fp8 0.8-1.5


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fp8_control_fails_where_bf16_passes(seed):
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import ServeRequest
    cell = testing.tiny_cell("qwen3-32b-pp2.offline", dtype="bfloat16",
                             limit=LIMIT)
    cfg = harness.arch_config(cell)
    params = wmod.make_weights(cell.model, seed, "cpu", torch.bfloat16,
                               cell.config["init_std"])
    kw = cell.engine_kw
    eng = Engine(cfg, params, max_batch=kw.pop("max_batch"),
                 max_len=kw.pop("max_len"), device="cpu", **kw)
    mix = dict(cell.traffic, residual_first=False)
    reqs = [ServeRequest(prompt=q.prompt, max_new_tokens=q.max_new)
            for q in itertools.islice(
                loadgen.requests(mix, seed, cfg.vocab, 4), 8)]
    queue = list(reqs)
    while queue or eng.busy():
        taken = {id(r) for r in eng.admit_many(queue)}
        queue = [r for r in queue if id(r) not in taken]
        eng.step()
    seqs = [(r.prompt, r.generated) for r in reqs]
    ref = Reference(cell.model, params).served_logits(seqs)
    ctl = Reference(cell.model, params, precision="fp8").served_logits(seqs)
    sound = check.served_gap(ref, [s for _, s in seqs])
    control = check.control_gap(ref, ctl)
    assert check.judge({"logit_gap": sound}, {"logit_gap": LIMIT})[0], sound
    assert not check.judge({"logit_gap": control},
                           {"logit_gap": LIMIT})[0], control
