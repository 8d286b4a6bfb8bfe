"""Device (H100): the share of the traced span in which no kernel, copy or
set ran on the card (one minus the union of the profiler's device
intervals over the span), in percent."""


def read(rec):
    p = rec.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
