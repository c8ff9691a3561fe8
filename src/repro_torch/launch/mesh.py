"""Device meshes: the host mesh over the ranks there are, and the
production meshes of the dry run on a fake process group.

Mesh axes:
  pod   — inter-pod data parallelism (2 pods × 256 devices)
  data  — intra-pod data/FSDP/sequence parallelism (16)
  model — tensor/expert parallelism (16)

Defined as functions: importing this module starts no process group.  A
process has one default group, so a real group (NCCL on the card, gloo on
the CPU) and the fake group of the production meshes never share a
process: the dry run runs in its own.
"""

from __future__ import annotations

import math
import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.pim.frontend import resolve_device

_FAKE = "fake"


def _fake_backend() -> str:
    """Register the fake backend (``torch.testing``'s, which holds no data
    and moves none) and return its name."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  registers "fake"

    return _FAKE


def _ensure_group(backend: str, world_size: int, rank: int = 0) -> None:
    """Start the default process group, or keep the one there is when it
    has this backend (a fake one with at least ``world_size`` ranks); a
    smaller fake group is replaced (it holds nothing).  Any other group
    already there is an error."""
    if dist.is_initialized():
        have = dist.get_backend()
        if have == backend and (backend != _FAKE or dist.get_world_size() >= world_size):
            return
        if have != _FAKE:
            raise RuntimeError(f"this process already has a {have!r} process group; "
                               f"a {backend!r} mesh needs a process of its own")
        dist.destroy_process_group()
    if backend == _FAKE:
        from torch.testing._internal.distributed.fake_pg import FakeStore

        _fake_backend()
        dist.init_process_group(_FAKE, store=FakeStore(), rank=rank, world_size=world_size)
        return
    # one rank: a file store needs no network
    fd, path = tempfile.mkstemp(prefix="repro_torch_pg_")
    os.close(fd)
    os.unlink(path)
    dist.init_process_group(backend, init_method=f"file://{path}", rank=rank,
                            world_size=world_size)


def make_abstract_mesh(shape, axes) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` on a fake process group of
    ``prod(shape)`` ranks: sharding propagates and collectives are issued,
    but no device is touched and nothing is sent (jax's
    ``AbstractMesh``).  Tensors on it live on the ``meta`` device."""
    n = math.prod(shape)
    _ensure_group(_fake_backend(), n)
    if dist.get_world_size() == n:
        return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))
    # a larger fake group (the multi-pod mesh's) also holds this mesh
    return DeviceMesh("cpu", torch.arange(n).reshape(tuple(shape)), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_abstract_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> DeviceMesh:
    """A ``("data", "model")`` mesh over the ranks of the default process
    group, each axis clamped to the ranks there are.  With no group it
    starts one of a single rank: NCCL on the card (``device=None``;
    ``RuntimeError`` without one), gloo for ``device="cpu"``.  The mesh
    must hold every rank of the group."""
    device = resolve_device(device)
    if not dist.is_initialized():
        _ensure_group("nccl" if device.type == "cuda" else "gloo", 1)
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(1, n // data))
    if data * model != n:
        raise ValueError(f"a {data}x{model} mesh does not hold the group's {n} ranks")
    if device.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device.type, (data, model), mesh_dim_names=("data", "model"))


def check_device(mesh: DeviceMesh, device: torch.device) -> None:
    """A model on ``device`` can be placed on ``mesh``."""
    if mesh.device_type != device.type:
        raise ValueError(f"a mesh of {mesh.device_type!r} devices cannot hold a model on "
                         f"{device}")


def mesh_axis_sizes(mesh: DeviceMesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def num_chips(mesh: DeviceMesh) -> int:
    return mesh.size()
