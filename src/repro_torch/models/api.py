"""Model construction and input specs (port of ``repro/models/api.py``)."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.device import DeviceLike, dtype_of
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import LM
from repro_torch.sharding.rules import Axes, Sharder

Model = Union[LM, EncDecLM]


def build_model(cfg: ArchConfig, device: DeviceLike = None,
                ssd_chunk: int = 128, kv_probe: bool = False,
                remat: bool = True, sharder: Optional[Sharder] = None,
                batch_axes: Axes = None,
                remat_policy: Optional[str] = None) -> Model:
    """The executable model on ``device`` (default: the card; raises
    without one unless ``device="cpu"``): ``EncDecLM`` for an
    encoder-decoder config, else ``LM``. ``ssd_chunk`` is the SSD scan's
    chunk length (SSM / hybrid families); ``kv_probe`` arms the KV
    sanitizer's probe on the paged attention calls (see ``LM``; the
    encoder-decoder has no paged cache and refuses it); ``remat``
    recomputes each layer's activations in ``loss``'s backward pass (the
    reference's default). ``sharder`` (with a mesh) makes the model run
    this rank's tensor-parallel shards, every family included,
    ``batch_axes`` naming the mesh axes its caller split the batch
    over. ``remat_policy`` (None or ``"save_block_out"``, the decoder-only
    families' attention layers; the encoder-decoder ignores it, as the
    reference's ``build_step`` does) chooses what ``remat`` keeps."""
    if cfg.is_encdec:
        if kv_probe:
            raise ValueError(f"{cfg.name}: the KV probe needs a paged cache")
        return EncDecLM(cfg, device=device, remat=remat, sharder=sharder,
                        batch_axes=batch_axes)
    return LM(cfg, device=device, ssd_chunk=ssd_chunk, kv_probe=kv_probe,
              remat=remat, sharder=sharder, batch_axes=batch_axes,
              remat_policy=remat_policy)


class TensorSpec(NamedTuple):
    """A model input's shape and torch dtype (no storage)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _frontend_embeds(cfg: ArchConfig) -> bool:
    return cfg.frontend in ("vision_embeds",)


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """``TensorSpec`` stand-ins for every model input of the given step,
    the reference's ``input_specs`` in the port's layout:

    train_step   -> {"tokens"/"embeds", "targets", "mask"} (+ "tokens" for
                    enc-dec; "positions" for M-RoPE)
    prefill_step -> prompt inputs
    serve_step   -> {"cache": <cache tree>, "tokens": (B,1)}; the cache is
                    ``init_cache(B, S)`` (ring for a sliding window, as the
                    reference allocates it) with per-row ``pos``, its shapes
                    read from the meta device (nothing is allocated)."""
    b, s = shape.global_batch, shape.seq_len
    dt = dtype_of(cfg.dtype)
    i32 = torch.int32
    if shape.step == "train_step":
        batch: Dict[str, Any] = {}
        if cfg.is_encdec:
            batch["embeds"] = TensorSpec((b, s, cfg.d_model), dt)
            batch["tokens"] = TensorSpec((b, s), i32)
        elif _frontend_embeds(cfg):
            batch["embeds"] = TensorSpec((b, s, cfg.d_model), dt)
        else:
            batch["tokens"] = TensorSpec((b, s), i32)
        if cfg.m_rope:
            batch["positions"] = TensorSpec((3, b, s), i32)
        batch["targets"] = TensorSpec((b, s), i32)
        batch["mask"] = TensorSpec((b, s), torch.float32)
        return batch
    if shape.step == "prefill_step":
        inputs: Dict[str, Any] = {}
        if cfg.is_encdec:
            inputs["embeds"] = TensorSpec((b, s, cfg.d_model), dt)
            inputs["tokens"] = TensorSpec((b, s), i32)
        elif _frontend_embeds(cfg):
            inputs["embeds"] = TensorSpec((b, s, cfg.d_model), dt)
            if cfg.m_rope:
                inputs["positions"] = TensorSpec((3, b, s), i32)
        else:
            inputs["tokens"] = TensorSpec((b, s), i32)
        return inputs
    model = build_model(cfg, device="meta")
    if cfg.is_encdec:
        cache = model.init_cache(b, s, s_enc=s)
    else:
        cache = model.init_cache(b, s, ring=True)
    return {"cache": {k: TensorSpec(tuple(v.shape), v.dtype)
                      for k, v in cache.items()},
            "tokens": TensorSpec((b, 1), i32)}
