"""Model construction (port of ``repro/models/api.py``)."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models.transformer import LM


def build_model(cfg: ArchConfig, device: DeviceLike = None,
                ssd_chunk: int = 128, kv_probe: bool = False) -> LM:
    """The executable model on ``device`` (default: the card; raises
    without one unless ``device="cpu"``). ``ssd_chunk`` is the SSD scan's
    chunk length (SSM / hybrid families); ``kv_probe`` arms the KV
    sanitizer's probe on the paged attention calls (see ``LM``)."""
    return LM(cfg, device=device, ssd_chunk=ssd_chunk, kv_probe=kv_probe)
