"""Training data pipeline (port of ``repro/train/data.py``).

Deterministic, shardable synthetic token stream (seeded per (step, host)) +
a file-backed binary token reader for real corpora. Both yield the batch
dict the models consume: tokens / targets / mask (+ embeds for stubbed
frontends, positions for M-RoPE). The arrays are numpy, from the
reference's numpy RNG and its order of draws, so a batch is the JAX
package's byte for byte; ``to_torch`` moves one onto a device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass
class DataConfig:
    batch: int
    seq_len: int
    seed: int = 0


class SyntheticLM:
    """Zipf-distributed token stream; next-step targets; full mask."""

    def __init__(self, cfg: ArchConfig, dc: DataConfig):
        self.cfg = cfg
        self.dc = dc

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.dc.seed * 1_000_003 + step)
                                    % (2 ** 31 - 1))
        c, dc = self.cfg, self.dc
        toks = rng.zipf(1.3, size=(dc.batch, dc.seq_len + 1))
        toks = np.minimum(toks, c.vocab - 1).astype(np.int32)
        out: Dict[str, np.ndarray] = {
            "targets": toks[:, 1:],
            "mask": np.ones((dc.batch, dc.seq_len), np.float32),
        }
        if c.is_encdec:
            out["tokens"] = toks[:, :-1]
            out["embeds"] = rng.randn(dc.batch, dc.seq_len,
                                      c.d_model).astype(np.float32)
        elif c.frontend == "vision_embeds":
            out["embeds"] = rng.randn(dc.batch, dc.seq_len,
                                      c.d_model).astype(np.float32)
        else:
            out["tokens"] = toks[:, :-1]
        if c.m_rope:
            pos = np.broadcast_to(np.arange(dc.seq_len)[None],
                                  (dc.batch, dc.seq_len))
            out["positions"] = np.broadcast_to(
                pos[None], (3, dc.batch, dc.seq_len)).astype(np.int32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class BinaryTokenFile:
    """Flat uint16/uint32 token file reader with epoch shuffling of
    sequence offsets (the custom raw-binary layout mirrors the paper's §6
    observation: store only the needed partition, stream it directly)."""

    def __init__(self, path: str, cfg: ArchConfig, dc: DataConfig,
                 dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.cfg = cfg
        self.dc = dc
        n_seq = (len(self.tokens) - 1) // dc.seq_len
        rng = np.random.RandomState(dc.seed)
        self.order = rng.permutation(n_seq)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        dc = self.dc
        n = len(self.order)
        idx = [self.order[(step * dc.batch + i) % n]
               for i in range(dc.batch)]
        rows = np.stack([
            self.tokens[j * dc.seq_len: j * dc.seq_len + dc.seq_len + 1]
            for j in idx]).astype(np.int32)
        rows = np.minimum(rows, self.cfg.vocab - 1)
        return {"tokens": rows[:, :-1], "targets": rows[:, 1:],
                "mask": np.ones((dc.batch, dc.seq_len), np.float32)}


def to_torch(batch: Dict[str, np.ndarray], device) -> Dict:
    """A numpy batch as tensors on ``device`` (int32 stays int32)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
