"""The yardstick's arithmetic: the card's peaks, a dense decoder's useful
operations, and a paged decode call's bytes.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity; at
the 700 W limit). The byte count follows ``chip_smoke.py``'s
``decode_work``: every input byte read once and every output byte written
once, the keys each row needs (positions 0..pos) and no more.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

PEAK_BYTES_S = 3.35e12          # HBM3, bytes/s
PEAK_FLOPS_S = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


def shapes(model: Dict) -> Dict[str, int]:
    """The sizes the counts need, from a configuration file's ``model``
    block (the repo's ``ArchConfig`` field names)."""
    d = int(model["d_model"])
    nh, nkv = int(model["n_heads"]), int(model["n_kv_heads"])
    hd = int(model.get("head_dim") or d // nh)
    return {"L": int(model["n_layers"]), "d": d, "nh": nh, "nkv": nkv,
            "hd": hd, "ff": int(model["d_ff"]), "V": int(model["vocab"]),
            "gated": bool(model.get("gated_ffn", True))}


def layer_matmul_params(s: Dict[str, int]) -> int:
    """Weights one token multiplies in a layer: q, k, v, o and the FFN."""
    attn = s["d"] * s["nh"] * s["hd"] * 2 + 2 * s["d"] * s["nkv"] * s["hd"]
    ffn = (3 if s["gated"] else 2) * s["d"] * s["ff"]
    return attn + ffn


def prefill_flops(s: Dict[str, int], n: int) -> float:
    """A prompt of ``n`` tokens: every layer's products for every token,
    causal attention (QK^T and PV, 2 operations a multiply-add, key j seen
    by queries j..n-1), and the head at the last position only."""
    mm = 2.0 * n * s["L"] * layer_matmul_params(s)
    att = 4.0 * s["L"] * s["nh"] * s["hd"] * n * (n + 1) / 2.0
    return mm + att + 2.0 * s["d"] * s["V"]


def decode_flops(s: Dict[str, int], pos: int) -> float:
    """One decoded token written at position ``pos`` (it sees pos + 1
    keys)."""
    mm = 2.0 * s["L"] * layer_matmul_params(s)
    att = 4.0 * s["L"] * s["nh"] * s["hd"] * (pos + 1)
    return mm + att + 2.0 * s["d"] * s["V"]


def decode_call_bytes(s: Dict[str, int], rows: int,
                      live_pos: Sequence[int], esz: int = 2,
                      block: int = 16) -> float:
    """One ``decode_attention_paged`` call (one layer) over ``rows`` rows
    of which ``live_pos`` are live at those positions: q and the output of
    every row, each live row's K and V for keys 0..pos and its table
    entries, the positions, and the trash block once where a dead row
    reads it."""
    qo = 2 * rows * s["nh"] * s["hd"] * esz
    kv_row = 2 * s["nkv"] * s["hd"] * esz
    keys = sum(p + 1 for p in live_pos)
    tbl = 4 * sum(-(-(p + 1) // block) for p in live_pos)
    trash = block * kv_row if rows > len(live_pos) else 0
    return float(qo + keys * kv_row + tbl + 4 * rows + trash)


def decode_steps_bytes(s: Dict[str, int], steps: Iterable, esz: int = 2,
                       block: int = 16) -> float:
    """Every layer's decode call over logged steps of ``(rows,
    live_positions)``."""
    return float(sum(s["L"] * decode_call_bytes(s, rows, pos, esz, block)
                     for rows, pos in steps))
