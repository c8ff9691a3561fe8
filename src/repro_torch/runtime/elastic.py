"""Elastic re-scaling: restore a checkpoint onto a different mesh.

Checkpoints store full (unsharded) arrays (checkpoint/store.py), so scaling
from e.g. a 2-pod (2,16,16) mesh down to one pod (16,16) — or up — is a
restore with the *new* mesh's placements.  The data stream is stateless in
(seed, step) (data/pipeline.py), so the token stream continues exactly.
What changes on re-scale is captured in a RescalePlan for the operator log.
"""

from __future__ import annotations

import dataclasses

from torch.distributed.device_mesh import DeviceMesh

from repro_torch.checkpoint import store
from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import sharding


@dataclasses.dataclass
class RescalePlan:
    old_shape: tuple
    new_shape: tuple
    per_device_batch_old: float
    per_device_batch_new: float
    notes: list[str]


def plan_rescale(old_mesh_shape: dict, new_mesh_shape: dict, global_batch: int) -> RescalePlan:
    old_n = 1
    for v in old_mesh_shape.values():
        old_n *= v
    new_n = 1
    for v in new_mesh_shape.values():
        new_n *= v
    notes = []
    old_dp = old_mesh_shape.get("pod", 1) * old_mesh_shape.get("data", 1)
    new_dp = new_mesh_shape.get("pod", 1) * new_mesh_shape.get("data", 1)
    if global_batch % new_dp:
        notes.append(
            f"global_batch {global_batch} not divisible by new DP degree {new_dp}: "
            "GSPMD pads the batch dim"
        )
    if new_n < old_n:
        notes.append("scale-down: verify per-device memory with dryrun before resuming")
    return RescalePlan(
        old_shape=tuple(old_mesh_shape.items()),
        new_shape=tuple(new_mesh_shape.items()),
        per_device_batch_old=global_batch / old_dp,
        per_device_batch_new=global_batch / new_dp,
        notes=notes,
    )


def restore_onto_mesh(
    directory: str,
    step: int,
    like_tree,
    mesh: DeviceMesh,
    cfg: ModelConfig,
    fsdp: bool = False,
):
    """Restore a checkpoint onto ``mesh`` regardless of the mesh it was
    saved from: each leaf of ``like_tree`` (a tree keyed by ``state_dict``
    names, as ``param_specs`` takes) becomes a DTensor placed by its spec."""
    specs = _flat_specs(sharding.param_specs(like_tree, cfg, fsdp=fsdp, mesh=mesh))
    placed = {key: (mesh, sharding.to_placements(spec, mesh)) for key, spec in specs.items()}
    return store.restore(directory, step, like_tree, shardings=placed)


def _flat_specs(specs, path=()) -> dict:
    """A spec tree flat under the checkpoint's keys (specs are leaves)."""
    if isinstance(specs, sharding.PartitionSpec):
        return {store.SEP.join(map(str, path)): specs}
    items = sorted(specs.items()) if isinstance(specs, dict) else enumerate(specs)
    flat = {}
    for key, child in items:
        flat.update(_flat_specs(child, (*path, key)))
    return flat
