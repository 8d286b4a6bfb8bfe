"""Parameter conversion from the JAX package's param tree.

``params_from_jax(tree, cfg, device)`` takes the reference's params as
numpy arrays (``jax.tree.map(np.asarray, params)``, done by the caller so
this module never imports JAX) and returns the port's params: the same
names, the same ``(d_in, d_out)`` layouts, stacked on the layer axis — a
copy with no transposes. Every leaf is checked against the port's schema.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import LM


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no numpy twin in torch
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(tree: Dict, cfg: ArchConfig,
                    device: DeviceLike = None) -> Dict:
    dev = resolve_device(device)
    shapes = LM(cfg, device=dev).param_shapes()

    def walk(node, ref, path):
        if isinstance(ref, dict):
            got = sorted(node) if isinstance(node, dict) else type(node)
            if got != sorted(ref):
                raise ValueError(f"param tree mismatch at {path or '/'}: "
                                 f"{got} vs {sorted(ref)}")
            return {k: walk(node[k], ref[k], f"{path}/{k}") for k in ref}
        if tuple(node.shape) != tuple(ref):
            raise ValueError(f"{path}: shape {tuple(node.shape)} != "
                             f"{tuple(ref)}")
        return _to_tensor(np.asarray(node), dev)

    return walk(tree, shapes, "")
