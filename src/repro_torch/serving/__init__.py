"""Serving plane of the port: the engine (paged or contiguous KV), its
host-side request / block-ledger objects, the shared tensor store and the
global server (dispatch, virtual clock, spot interruption, migration)."""

from repro_torch.serving.engine import Engine, EngineStats
from repro_torch.serving.request import ServeRequest
from repro_torch.serving.server import FTTimes, GlobalServer, ServingPipeline
from repro_torch.serving.tensor_store import TensorStore

__all__ = ["Engine", "EngineStats", "ServeRequest", "FTTimes",
           "GlobalServer", "ServingPipeline", "TensorStore"]
