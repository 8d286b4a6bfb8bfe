"""Kernels (``kernels/decode_attention.py`` -> ``csrc/decode_attention.cu``):
the paged decode kernel's share of its roofline over the traced span, in
percent: the least time its calls could take (their bytes, from the log of
each call's live rows and positions, at the card's peak bandwidth; the
operations bound lies far below) over their device time in the profile."""

import re

from perfbench import work

KERNELS = re.compile(r"decode_sm90_kernel|decode_split_kernel|"
                     r"decode_combine_kernel|dec::combine_kernel")


def read(rec):
    p = rec.profile
    if not p or not p["decode_log"]:
        return None
    t = sum(e - s for n, s, e in p["kernels"] if KERNELS.search(n))
    if t <= 0:
        return None
    block = int(rec.cell.engine_kw.get("block_size", 16))
    nbytes = work.decode_steps_bytes(rec.shapes, p["decode_log"],
                                     block=block)
    return 100.0 * nbytes / work.PEAK_BYTES_S / t
