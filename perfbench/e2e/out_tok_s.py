"""Output tokens per second: every output token the host received inside
the window, over the window's length (host clock)."""


def read(rec):
    n = sum(1 for tr in rec.tracks for t in tr.stamps if rec.t0 < t <= rec.t1)
    return n / (rec.t1 - rec.t0)
