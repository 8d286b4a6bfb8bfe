"""The yardstick's arithmetic against hand counts, and the readers'
reductions."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]

from types import SimpleNamespace  # noqa: E402

from perfbench import devtrace, harness, work  # noqa: E402

# one layer, d 8, 2 query heads and 1 K/V head of 4, FFN 16, vocab 10
S = work.shapes({"n_layers": 1, "d_model": 8, "n_heads": 2,
                 "n_kv_heads": 1, "head_dim": 4, "d_ff": 16, "vocab": 10})


def test_matmul_params_by_hand():
    # wq 8x8, wk 8x4, wv 8x4, wo 8x8, w_gate / w_up 8x16, w_down 16x8
    assert work.layer_matmul_params(S) == 64 + 32 + 32 + 64 + 3 * 128


def test_prefill_flops_by_hand():
    # 3 tokens: 2 * 3 * 576 products; attention 4 * 2 heads * 4 * (1+2+3);
    # the head at the last position 2 * 8 * 10
    assert work.prefill_flops(S, 3) == 2 * 3 * 576 + 4 * 2 * 4 * 6 + 160


def test_decode_flops_by_hand():
    # position 5 sees 6 keys
    assert work.decode_flops(S, 5) == 2 * 576 + 4 * 2 * 4 * 6 + 160


def test_decode_bytes_by_hand():
    # 4 rows, live at positions 15 and 16 (16 and 17 keys), block 16:
    # q + out 2*4*2*4*2, K/V 33 keys * 2*1*4*2, tables 4*(1+2), positions
    # 4*4, the trash block 16 * 16 once (two dead rows)
    want = 128 + 33 * 16 + 12 + 16 + 256
    assert work.decode_call_bytes(S, 4, [15, 16]) == want
    assert work.decode_steps_bytes(S, [(4, [15, 16]), (4, [15, 16])]) == \
        2 * want


def test_kv_pool_used_by_hand():
    read = harness.reader("layers", "kv_pool_used")
    assert read(SimpleNamespace(kv_blocks=200, kv_peak_blocks=50)) == 25.0
    assert read(SimpleNamespace(kv_blocks=0, kv_peak_blocks=0)) is None


def test_union_and_gaps():
    busy, gaps = devtrace.union([(1, 3), (2, 4), (6, 7), (9, 12)], 0, 10)
    assert busy == 3 + 1 + 1
    assert gaps == [(0, 1), (4, 6), (7, 9)]
