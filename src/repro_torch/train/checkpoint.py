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
manifest dtype ``"bfloat16"``. Leaves are written and hashed on
``IO_THREADS`` threads at once and read on ``RESTORE_READERS`` (numpy's
file I/O and ``hashlib`` release the GIL), each digest over the array's
own buffer, with no copy.

Over a mesh of ranks (``launch/train_mesh.py``), as in the reference, a
checkpoint holds full arrays and restores onto ANY mesh. A save with
``gather`` (every rank calls it; ``gather=partial(built.gather_state,
dst=0)`` for a ``TrainBuiltStep``) writes the gathered full state from
rank 0, behind a barrier: the files a one-process save of the same values
writes (same paths, shapes, dtypes and digests). ``restore_checkpoint``
with ``shardings`` is the elastic path: it loads each full array and
keeps this rank's part of it, by a tree shaped like ``like`` whose leaves
map a full tensor (on the host) to the rank's part on its device
(``TrainBuiltStep.state_shardings()`` of a step built for the restore
mesh, the port's counterpart of the reference's ``NamedSharding`` tree);
the saved mesh and the restore mesh may differ.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

# threads writing and hashing leaves at once
IO_THREADS = 8
# threads reading, checking and cutting leaves at once in a restore: the
# full arrays in host memory at once
RESTORE_READERS = 2


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
    """md5 of the array's bytes in C order (``arr.tobytes()``), first 16
    hex digits."""
    buf = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return hashlib.md5(buf).hexdigest()[:16]


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    keep: int = 3,
                    gather: Optional[Callable[[Any], Any]] = None) -> str:
    """Write ``tree`` as ``ckpt_dir/step_<step>``; returns that path. With
    ``gather`` (a mesh: every rank calls this) the full tree is
    ``gather(tree)``, which rank 0 writes while the others wait at a
    barrier."""
    if gather is not None:
        import torch.distributed as dist
        full = gather(tree)
        path = os.path.join(ckpt_dir, f"step_{step:08d}")
        if dist.get_rank() == 0:
            path = save_checkpoint(ckpt_dir, step, full, keep)
        del full
        dist.barrier()
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_step{step}_")

    def write(item):
        name, leaf = item
        arr, dtype = _to_numpy(leaf)
        fname = hashlib.md5(name.encode()).hexdigest()[:16] + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        return {"path": name, "file": fname, "shape": list(arr.shape),
                "dtype": dtype, "digest": _digest(arr)}
    with ThreadPoolExecutor(IO_THREADS) as pool:
        manifest = {"step": step,
                    "leaves": list(pool.map(write, _flatten(tree)))}
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
                       shardings: Optional[Any] = None,
                       verify_digest: bool = True) -> Any:
    """Restore into the structure of ``like``: each tensor leaf onto the
    device of ``like``'s leaf, in the saved dtype; a Python number leaf
    (the optimizer's step) as a Python number. ``shardings``: a tree
    shaped like ``like`` of functions from a full tensor (on the host) to
    the tensor to keep (None: keep it whole); each array is then loaded
    full and only its result kept (the elastic path, module docstring).
    Each of the ``RESTORE_READERS`` readers reads, checks and converts
    one array and hands on only what is kept, so at most
    ``RESTORE_READERS`` full arrays are in host memory at once."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {leaf["path"]: leaf for leaf in manifest["leaves"]}
    cut = dict(_flatten(shardings)) if shardings is not None else {}

    def read(item):
        name, leaf = item
        entry = by_path[name]
        arr = np.load(os.path.join(d, entry["file"]))
        if verify_digest and _digest(arr) != entry["digest"]:
            raise IOError(f"digest mismatch for {name}")
        if not torch.is_tensor(leaf):
            return name, arr.item() if arr.ndim == 0 else arr
        t = torch.from_numpy(arr)
        if entry["dtype"] == "bfloat16":
            t = t.view(torch.int16).view(torch.bfloat16)
        fn = cut.get(name)
        return name, fn(t) if fn is not None else t.to(leaf.device)
    with ThreadPoolExecutor(RESTORE_READERS) as pool:
        values = dict(pool.map(read, _flatten(like)))
    return _unflatten(like, values)
