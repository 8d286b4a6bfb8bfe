"""Device and dtype resolution shared by every entry point of the port.

``resolve_device(None)`` means the card: with no card it raises instead of
falling back to the CPU, so a run that was meant for the GPU can never
silently measure the host. Tests pass ``device="cpu"`` explicitly.
``"meta"`` allocates nothing: ``models.api.input_specs`` reads a cache's
shapes and dtypes from it.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch path on the host")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def dtype_of(name: str) -> torch.dtype:
    """Model dtype by config name. fp16 is refused: the KV sanitizer's
    finite poison sentinel (``serving/kv_blocks.py`` ``KV_POISON = 1e9``)
    overflows it."""
    table = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if name not in table:
        raise ValueError(f"dtype {name!r} unsupported by repro_torch "
                         f"(expected one of {sorted(table)})")
    return table[name]


def device_of(params) -> Optional[torch.device]:
    """Device of the first tensor found in a nested param dict."""
    if isinstance(params, torch.Tensor):
        return params.device
    if isinstance(params, dict):
        for v in params.values():
            d = device_of(v)
            if d is not None:
                return d
    return None
