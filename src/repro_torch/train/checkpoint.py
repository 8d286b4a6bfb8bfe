"""Checkpointing: per-leaf ``.npy`` files with a JSON manifest (port of
``repro/train/checkpoint.py``).

Fault tolerance for training on spot / preemptible capacity, as the
reference:

  * every save writes one ``.npy`` file per leaf and a JSON manifest with
    the step and, per leaf, its path, file, shape, dtype and a content
    digest;
  * saves are atomic (a temporary directory renamed into place), so an
    interruption mid-save never corrupts the latest checkpoint;
  * ``keep`` rotation bounds the disk;
  * restore checks every digest and loads into the structure of a
    ``like`` state, onto the device of each of its leaves.

bf16 leaves are stored as their 16-bit words (a uint16 ``.npy``) with the
manifest dtype ``"bfloat16"``. The reference's ``shardings`` argument (an
elastic re-shard on restore) waits for the multi-device plane.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of nested named tuples, dicts and leaves."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _flatten(v, f"{prefix}[{k!r}]")]
    return [(prefix, tree)]


def _unflatten(like, values: dict, prefix: str = ""):
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), values,
                                       f"{prefix}.{f}")
                            for f in like._fields))
    if isinstance(like, dict):
        return {k: _unflatten(v, values, f"{prefix}[{k!r}]")
                for k, v in like.items()}
    return values[prefix]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array stored on disk and its manifest dtype."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _digest(arr: np.ndarray) -> str:
    return hashlib.md5(arr.tobytes()).hexdigest()[:16]


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_step{step}_")
    manifest = {"step": step, "leaves": []}
    for name, leaf in _flatten(tree):
        arr, dtype = _to_numpy(leaf)
        fname = hashlib.md5(name.encode()).hexdigest()[:16] + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "path": name, "file": fname, "shape": list(arr.shape),
            "dtype": dtype, "digest": _digest(arr),
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _rotate(ckpt_dir, keep)
    return final


def _rotate(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like: Any,
                       verify_digest: bool = True) -> Any:
    """Restore into the structure of ``like``: each tensor leaf onto the
    device of ``like``'s leaf, in the saved dtype; a Python number leaf
    (the optimizer's step) as a Python number."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {leaf["path"]: leaf for leaf in manifest["leaves"]}
    values = {}
    for name, leaf in _flatten(like):
        entry = by_path[name]
        arr = np.load(os.path.join(d, entry["file"]))
        if verify_digest and _digest(arr) != entry["digest"]:
            raise IOError(f"digest mismatch for {name}")
        if torch.is_tensor(leaf):
            t = torch.from_numpy(arr)
            if entry["dtype"] == "bfloat16":
                t = t.view(torch.int16).view(torch.bfloat16)
            values[name] = t.to(leaf.device)
        else:
            values[name] = arr.item() if arr.ndim == 0 else arr
    return _unflatten(like, values)
