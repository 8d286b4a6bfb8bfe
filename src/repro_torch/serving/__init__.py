"""Serving data plane of the port: the engine (paged or contiguous KV) and
its host-side request / block-ledger objects."""

from repro_torch.serving.engine import Engine, EngineStats
from repro_torch.serving.request import ServeRequest

__all__ = ["Engine", "EngineStats", "ServeRequest"]
