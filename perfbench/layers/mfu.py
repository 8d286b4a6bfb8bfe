"""Model step (``models/transformer.py``, ``attention.py``, ``common.py``):
the window's useful operations over the window's length at the card's
peak, in percent. A prompt's operations count when its first token comes,
a decoded token's when it comes (``work.prefill_flops``,
``work.decode_flops``: products and causal attention from the
configuration's shapes, no padding)."""

from perfbench import work


def read(rec):
    s = rec.shapes
    ops = 0.0
    for tr in rec.tracks:
        for k, t in enumerate(tr.stamps):
            if not rec.t0 < t <= rec.t1:
                continue
            ops += (work.prefill_flops(s, tr.prompt_len) if k == 0 else
                    work.decode_flops(s, tr.prompt_len + k - 1))
    peak = work.PEAK_FLOPS_S[rec.cell.model["dtype"]]
    return 100.0 * ops / ((rec.t1 - rec.t0) * peak)
