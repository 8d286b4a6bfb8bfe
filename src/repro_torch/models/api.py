"""Model construction (port of ``repro/models/api.py``)."""

from __future__ import annotations

from typing import Union

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import LM

Model = Union[LM, EncDecLM]


def build_model(cfg: ArchConfig, device: DeviceLike = None,
                ssd_chunk: int = 128, kv_probe: bool = False,
                remat: bool = True) -> Model:
    """The executable model on ``device`` (default: the card; raises
    without one unless ``device="cpu"``): ``EncDecLM`` for an
    encoder-decoder config, else ``LM``. ``ssd_chunk`` is the SSD scan's
    chunk length (SSM / hybrid families); ``kv_probe`` arms the KV
    sanitizer's probe on the paged attention calls (see ``LM``; the
    encoder-decoder has no paged cache and refuses it); ``remat``
    recomputes each layer's activations in ``loss``'s backward pass (the
    reference's default)."""
    if cfg.is_encdec:
        if kv_probe:
            raise ValueError(f"{cfg.name}: the KV probe needs a paged cache")
        return EncDecLM(cfg, device=device, remat=remat)
    return LM(cfg, device=device, ssd_chunk=ssd_chunk, kv_probe=kv_probe,
              remat=remat)
