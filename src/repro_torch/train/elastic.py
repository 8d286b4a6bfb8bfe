"""Elastic training: react to cluster membership changes (port of
``repro/train/elastic.py``).

When spot capacity changes mid-run the trainer (1) checkpoints, (2)
rebuilds the mesh for the surviving device count, (3) restores with the
new mesh's shardings, (4) rescales the data-parallel batch (keeping the
per-device batch constant: the linear-scaling rule).

The reference re-initialises its runtime across the surviving hosts;
here that is a new ``torch.distributed`` world of the survivors' ranks
(``launch/mesh.run_ranks`` starts one on a host), in which
``resize_mesh`` builds the new ``(data, model)`` mesh. A checkpoint
written from the old mesh (``checkpoint.save_checkpoint(gather=...)``)
is restored onto it by ``checkpoint.restore_checkpoint(shardings=...)``,
or a full state in memory is cut by ``reshard_state``; both take the
layout of a train step built for the new mesh
(``launch/steps.build_step``), which stands where the reference's
logical-name tree and rules stand: the port's layout also needs the
model's whole heads, the KV heads a rank's queries read and the Mamba2
mixer's split, which a name tree does not carry.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple


@dataclasses.dataclass
class ElasticState:
    mesh: Any
    n_devices: int
    global_batch: int


def plan_resize(old: ElasticState, new_n_devices: int,
                model_axis: int) -> Tuple[Tuple[int, int], int]:
    """New (data, model) mesh shape + global batch. The model axis is fixed
    by the sharding degree (weights layout); data axis absorbs the change."""
    model = min(model_axis, new_n_devices)
    while new_n_devices % model:
        model //= 2
    data = new_n_devices // model
    per_dev = max(1, old.global_batch // max(1, old.n_devices))
    return (data, model), per_dev * new_n_devices


def resize_mesh(old: ElasticState, new_n_devices: int, model_axis: int,
                devices: Optional[Sequence[int]] = None) -> ElasticState:
    """This rank's ``launch/mesh.Mesh`` of the planned ``(data, model)``
    shape over the initialised world of the survivors, with the new
    global batch. ``devices``: the survivors' ranks, the first data x
    model of which the mesh takes (default: every rank of the world); the
    world must hold exactly those (every rank calls this: the mesh's
    process groups are collective)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    shape, new_batch = plan_resize(old, new_n_devices, model_axis)
    world = dist.get_world_size()
    ranks = list(range(world) if devices is None else devices)
    ranks = ranks[:shape[0] * shape[1]]
    if ranks != list(range(world)):
        raise ValueError(f"resize_mesh: a {shape} mesh over ranks {ranks} "
                         f"in a world of {world}; start the survivors' "
                         f"world with exactly its ranks")
    return ElasticState(make_mesh(shape, ("data", "model")), new_n_devices,
                        new_batch)


def reshard_state(state: Any, specs: Any, new: ElasticState,
                  rules: Optional[Dict] = None) -> Any:
    """This rank's shard of a full train ``state`` on the new mesh.
    ``specs``: the train step built for ``new.mesh``
    (``launch/train_mesh.TrainBuiltStep``), whose layout stands for the
    reference's logical-name tree (module docstring); ``rules``, when
    given, must be the step's."""
    if not hasattr(specs, "shard_state"):
        raise TypeError("reshard_state: specs must be a train step built "
                        "for the new mesh (launch/steps.build_step); a "
                        "logical-name tree does not carry the port's layout")
    if dict(specs.meta["mesh"].shape) != dict(new.mesh.shape):
        raise ValueError(f"reshard_state: a step built for "
                         f"{dict(specs.meta['mesh'].shape)}, a mesh "
                         f"{dict(new.mesh.shape)}")
    if rules is not None and dict(rules) != specs.meta["rules"]:
        raise ValueError("reshard_state: rules differ from the step's")
    return specs.shard_state(state)
