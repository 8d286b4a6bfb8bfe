"""Host syncs (``models/common.py`` RoPE, ``serving/engine.py`` uploads):
the syncs PyTorch's sync debug mode reports inside ``Engine.step`` calls
(chunk dispatches included), per call, over a fixed count of steps after
the traced span."""


def read(rec):
    c = rec.census
    if not c or not c["steps"]:
        return None
    return c["counts"].get("step", 0) / c["steps"]
