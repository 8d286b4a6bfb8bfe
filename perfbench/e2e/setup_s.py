"""Set-up: from the process's start to the window (kernel load or build,
weights, the engine, warm-up of the cell's shapes, filling the engine)."""


def read(rec):
    return rec.setup_s
