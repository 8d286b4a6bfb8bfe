"""Scheduler (``serving/engine.py``, ``kv_blocks.py``): rows a decode step
carries, the window's decoded tokens (output tokens but first ones) over
its decode steps (``EngineStats.decode_steps``)."""


def read(rec):
    steps = rec.stats1["decode_steps"] - rec.stats0["decode_steps"]
    toks = sum(1 for tr in rec.tracks for k, t in enumerate(tr.stamps)
               if k > 0 and rec.t0 < t <= rec.t1)
    return toks / steps if steps > 0 else None
