"""Device meshes of ``torch.distributed`` ranks (port of
``repro/launch/mesh.py``), and ``run_ranks``, which starts a world of them.

A ``Mesh`` is the reference's named mesh seen from one rank: ``shape`` is
an ordered dict of axis sizes (``{"data": 2, "model": 2}``), so
``sharding.rules.resolve`` reads it as it reads a JAX mesh; ``coords`` is
this rank's position, row-major over the axes (rank = the flattened
index); ``group(axes)`` is the process group of the ranks that share this
rank's coordinates on every other axis (one ``dist.new_group`` per single
axis and per axis tuple the rule tables use, ``("pod", "data")`` too).
The mesh is the port's own: ``torch.distributed.device_mesh.DeviceMesh``
is not used, since it assumes one device per rank and the one-card runs
put every rank on the same card.

``make_mesh`` and ``make_production_mesh`` build the mesh for the calling
rank of an initialised process group; nothing here initialises anything at
import.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

# axis tuples with a group of their own besides the single axes: the
# multi-axis entries of the rule tables (the batch over pods and data)
MULTI_AXIS_GROUPS = (("pod", "data"),)
# a world that runs longer is stopped and ``run_ranks`` raises
RANKS_TIMEOUT_S = 900.0


@dataclasses.dataclass
class Mesh:
    shape: "collections.OrderedDict[str, int]"
    coords: Dict[str, int]
    groups: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict)

    def group(self, axes: Tuple[str, ...]):
        """The process group of ``axes`` that holds this rank."""
        if tuple(axes) not in self.groups:
            raise KeyError(f"no process group for axes {axes} on a mesh "
                           f"{dict(self.shape)} (built without groups?)")
        return self.groups[tuple(axes)]

    def rank_at(self, **coords: int) -> int:
        """The global rank at this rank's coordinates with ``coords``
        replacing some of them (``rank_at(pod=1)``: the rank of pod 1 that
        shares this rank's data and model coordinates)."""
        rank = 0
        for a, n in self.shape.items():
            c = coords.get(a, self.coords[a])
            if not 0 <= c < n:
                raise ValueError(f"coordinate {a}={c} outside a mesh "
                                 f"{dict(self.shape)}")
            rank = rank * n + c
        return rank


def mesh_coords(shape: Sequence[int], axes: Sequence[str], rank: int
                ) -> Dict[str, int]:
    """The row-major coordinates of ``rank`` on a mesh of ``shape``."""
    out = {}
    for a, n in reversed(list(zip(axes, shape))):
        out[a] = rank % n
        rank //= n
    return {a: out[a] for a in axes}


def mesh_for_rank(shape: Sequence[int], axes: Sequence[str], rank: int
                  ) -> Mesh:
    """A mesh seen from ``rank`` with no process groups: enough to slice
    tensors (``sharding.rules.shard_leaf``), not to reduce them."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} vs axes {tuple(axes)}")
    return Mesh(collections.OrderedDict(zip(axes, shape)),
                mesh_coords(shape, axes, rank))


def _group_axes(axes: Sequence[str]) -> List[Tuple[str, ...]]:
    out = [(a,) for a in axes]
    out += [t for t in MULTI_AXIS_GROUPS if all(a in axes for a in t)]
    return out


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """This rank's view of a mesh over the initialised default process
    group, with a process group per single axis and per multi-axis entry
    of the rule tables. Every rank must call it (``new_group`` is
    collective); raises when the world size does not match the shape."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised")
    shape, axes = tuple(shape), tuple(axes)
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {n} ranks, "
                         f"the world has {world}")
    mesh = mesh_for_rank(shape, axes, dist.get_rank())
    for group_axes in _group_axes(axes):
        others = [a for a in axes if a not in group_axes]
        # every rank creates every group, in one order
        for fixed in itertools.product(*[range(mesh.shape[a])
                                         for a in others]):
            ranks = [r for r in range(world)
                     if all(mesh_coords(shape, axes, r)[a] == v
                            for a, v in zip(others, fixed))]
            g = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                mesh.groups[group_axes] = g
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 = 256 ranks ("data","model"). Multi-pod: 2 pods x
    256 = 512 ranks ("pod","data","model"). The reference's shapes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


# ---------------------------------------------------------------------------
# a world of ranks on this host
# ---------------------------------------------------------------------------
def _rank_main(rank: int, world: int, out_dir: str, mesh_shape, axes,
               backend: str, device: str) -> None:
    import torch.distributed as dist
    try:
        with open(os.path.join(out_dir, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        if device == "cpu":
            torch.set_num_threads(1)
            dev = torch.device("cpu")
        else:
            # nccl needs one card per rank; gloo ranks may share a card
            idx = rank if backend == "nccl" else 0
            torch.cuda.set_device(idx)
            dev = torch.device("cuda", idx)
        kw = {"device_id": dev} if backend == "nccl" else {}
        rdv = os.path.join(out_dir, "rdv")
        dist.init_process_group(backend, init_method=f"file://{rdv}",
                                rank=rank, world_size=world, **kw)
        mesh = make_mesh(mesh_shape, axes)
        out = fn(mesh, dev, *args)
        dist.barrier()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn: Callable, mesh_shape: Sequence[int],
              axes: Sequence[str], *, backend: str = "gloo",
              device: str = "cpu", args: tuple = ()) -> List[Any]:
    """Run ``fn(mesh, device, *args)`` on every rank of a new world of
    ``prod(mesh_shape)`` processes on this host and return each rank's
    result, in rank order (returned through ``torch.save``); ``fn`` and
    ``args`` reach the ranks through a pickle file, so starting a rank
    never waits for the one before to read them.

    The ranks start with the ``spawn`` method (a forked process cannot use
    the card) and meet at a ``file://`` rendezvous in a temporary
    directory, never a fixed TCP port, so several worlds may run at once.
    ``fn`` must be importable by name (a module-level function of a module
    that the ranks can import). ``device="cuda"``: with ``gloo`` every rank
    uses card 0; with ``nccl`` rank r uses card r. A rank that fails makes
    the others stop and this call raise with its traceback, as does a
    world that runs past ``RANKS_TIMEOUT_S``."""
    import torch.multiprocessing as mp
    world = 1
    for s in mesh_shape:
        world *= s
    tmp = tempfile.mkdtemp(prefix="ranks-")
    try:
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main, args=(
            r, world, tmp, tuple(mesh_shape), tuple(axes), backend, device))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        failed: Optional[int] = None
        while any(p.is_alive() for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            if bad or time.monotonic() > deadline:
                failed = bad[0] if bad else -1
                break
            time.sleep(0.05)
        for p in procs:
            if failed is not None and p.is_alive():
                p.terminate()
            p.join()
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
            failed = bad[0] if bad else None
        if failed is not None:
            errs = [open(os.path.join(tmp, f)).read()
                    for f in sorted(os.listdir(tmp)) if f.endswith(".err")]
            what = (f"rank {failed} exited with {procs[failed].exitcode}"
                    if failed >= 0 else
                    f"the world ran past {RANKS_TIMEOUT_S} s")
            raise RuntimeError(f"run_ranks: {what}\n" + "\n".join(errs))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
