"""Model construction (port of ``repro/models/api.py``, dense and MoE
families)."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models.transformer import LM


def build_model(cfg: ArchConfig, device: DeviceLike = None) -> LM:
    """The executable model on ``device`` (default: the card; raises
    without one unless ``device="cpu"``)."""
    return LM(cfg, device=device)
