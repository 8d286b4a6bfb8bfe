"""Assigned input shapes and (arch x shape) cell enumeration.

  train_4k     seq_len=4096    global_batch=256   -> train_step
  prefill_32k  seq_len=32768   global_batch=32    -> prefill_step
  decode_32k   seq_len=32768   global_batch=128   -> serve_step (1 new token,
                                                     KV cache of seq_len)
  long_500k    seq_len=524288  global_batch=1     -> serve_step; requires
                                                     sub-quadratic attention

Skips (recorded in DESIGN.md §5): ``long_500k`` only for subquadratic archs
(mamba2 / zamba2 / h2o-danube SWA); decode shapes only for archs with a
decoder (all assigned archs have one).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str            # train_step | prefill_step | serve_step


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train_step")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill_step")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "serve_step")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "serve_step")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ArchConfig) -> List[ShapeSpec]:
    out = [TRAIN_4K, PREFILL_32K]
    if cfg.supports_decode:
        out.append(DECODE_32K)
        if cfg.subquadratic:
            out.append(LONG_500K)
    return out


def skipped_shapes_for(cfg: ArchConfig) -> List[Tuple[ShapeSpec, str]]:
    out = []
    if not cfg.supports_decode:
        out.append((DECODE_32K, "encoder-only: no decode step"))
        out.append((LONG_500K, "encoder-only: no decode step"))
    elif not cfg.subquadratic:
        out.append((LONG_500K,
                    "pure full attention: O(S^2) at 524288 not servable"))
    return out


def all_cells(configs) -> List[Tuple[ArchConfig, ShapeSpec]]:
    return [(cfg, sh) for cfg in configs for sh in shapes_for(cfg)]
