"""Scheduler (``serving/engine.py``, ``kv_blocks.py``): the most KV blocks
in use at once over the window, as a share of the pool the engine reserved
(the trash block left out), in percent. The pool takes what the card has
left after the weights; this is the share of it the traffic holds."""


def read(rec):
    if rec.kv_blocks <= 0:
        return None
    return 100.0 * rec.kv_peak_blocks / rec.kv_blocks
