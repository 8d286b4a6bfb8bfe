"""The traffic generator: deterministic by seed, the same sizes in the same
order for every seed, and its means those of its parameters."""

import itertools
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import loadgen  # noqa: E402

MIXES = {p.stem: json.loads(p.read_text())
         for p in (ROOT / "perfbench" / "traffic").glob("*.json")}


def take(mix, seed, n, vocab=1000, max_batch=8):
    return list(itertools.islice(loadgen.requests(mix, seed, vocab,
                                                  max_batch), n))


def test_same_seed_same_requests():
    for mix in MIXES.values():
        a = take(mix, 2 ** 31 + 17, 40)
        b = take(mix, 2 ** 31 + 17, 40)
        assert [(r.prompt, r.max_new) for r in a] == \
            [(r.prompt, r.max_new) for r in b]


def test_seeds_reorder_the_same_sizes():
    """The seed draws the tokens; the sizes and their order are the mix's,
    so every seed offers the same work (residual outputs included)."""
    for mix in MIXES.values():
        n = mix["block"] * 2
        a, b = take(mix, 1, n), take(mix, 2 ** 33 + 5, n)
        assert [(len(r.prompt), r.max_new) for r in a] == \
            [(len(r.prompt), r.max_new) for r in b]
        assert [r.prompt for r in a] != [r.prompt for r in b]
        # each block holds every quantile once, paired in another order
        block = [len(r.prompt) for r in a[:mix["block"]]]
        assert block != sorted(block)
        assert sorted(block) == sorted(len(r.prompt)
                                       for r in a[mix["block"]:])


def test_means_follow_the_parameters():
    for name, mix in MIXES.items():
        mix = dict(mix, residual_first=False, block=512)
        reqs = take(mix, 5, 512, vocab=50)
        for key, got in (("input", [len(r.prompt) for r in reqs]),
                         ("output", [r.max_new for r in reqs])):
            p = mix[key]
            want = loadgen.clipped_lognormal_mean(**p)
            # quantiles rounded down: at most one token below the mean
            assert abs(np.mean(got) - want) < 0.01 * want + 1, (name, key)
            assert min(got) >= p["lo"] and max(got) <= p["hi"]


def test_unclipped_mean_is_the_parameter():
    q = loadgen.lognormal_quantiles(763, 0.9, 1, 10 ** 9, 20000)
    assert abs(q.mean() / 763 - 1) < 0.01


def test_residual_first_shortens_only_the_first_rows():
    mix = dict(MIXES["offline"], residual_first=True)
    plain = dict(mix, residual_first=False)
    a, b = take(mix, 3, 64, max_batch=8), take(plain, 3, 64, max_batch=8)
    assert all(x.max_new <= y.max_new for x, y in zip(a[:8], b[:8]))
    assert [x.max_new for x in a[8:]] == [y.max_new for y in b[8:]]
    assert [x.prompt for x in a] == [y.prompt for y in b]
