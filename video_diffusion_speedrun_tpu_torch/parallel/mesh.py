"""Device mesh over `torch.distributed` (port of `parallel/mesh.py`).

One process per card, started by `torchrun` (or any launcher that sets
WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR and MASTER_PORT). The mesh is a
`DeviceMesh` with dims (replica, fsdp, context, tensor), in that order:
NCCL on cards, gloo on the CPU. A world of one process needs no process
group, and its mesh is None; the accessors below take None as the mesh
where every axis has size 1.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from video_diffusion_speedrun_tpu_torch.core.config import MeshConfig

AXIS_REPLICA = "replica"
AXIS_FSDP = "fsdp"
AXIS_CONTEXT = "context"
AXIS_TENSOR = "tensor"
MESH_AXES = (AXIS_REPLICA, AXIS_FSDP, AXIS_CONTEXT, AXIS_TENSOR)


def init_distributed(device: torch.device) -> torch.device:
    """Under a launcher (WORLD_SIZE > 1 in the environment) start the
    default process group — NCCL on `cuda:{LOCAL_RANK}`, gloo on the CPU —
    and return the device this process runs on; otherwise return `device`."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device


def shutdown() -> None:
    """End the process group `init_distributed` started, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def build_mesh(cfg: Optional[MeshConfig] = None,
               device_type: str = "cuda"):
    """The (replica, fsdp, context, tensor) `DeviceMesh` over all processes,
    or None in a world of one. Raises as `MeshConfig.resolve` when the axes
    do not multiply to the world size."""
    cfg = (cfg or MeshConfig()).resolve(world_size())
    if world_size() == 1:
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(
        device_type, (cfg.replica, cfg.fsdp, cfg.context, cfg.tensor),
        mesh_dim_names=MESH_AXES)


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(MESH_AXES.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def context_group(mesh):
    """The process group of this rank's context axis, or None at size 1."""
    if axis_size(mesh, AXIS_CONTEXT) == 1:
        return None
    return mesh.get_group(AXIS_CONTEXT)


def tensor_group(mesh):
    """The process group of this rank's tensor axis, or None at size 1."""
    if axis_size(mesh, AXIS_TENSOR) == 1:
        return None
    return mesh.get_group(AXIS_TENSOR)


def data_group(mesh):
    """The process group over which the batch is data-parallel: the ranks
    that share this rank's (context, tensor) coordinates, in (replica,
    fsdp) order (JAX's `DATA_AXES`); None at size 1."""
    if data_shards(mesh) == 1:
        return None
    if axis_size(mesh, AXIS_FSDP) == 1:
        return mesh.get_group(AXIS_REPLICA)
    if axis_size(mesh, AXIS_REPLICA) == 1:
        return mesh.get_group(AXIS_FSDP)
    if not hasattr(mesh, "data_group"):
        # every rank creates every group, in the same order
        ranks = mesh.mesh  # [replica, fsdp, context, tensor] → global rank
        for c in range(ranks.shape[2]):
            for t in range(ranks.shape[3]):
                members = ranks[:, :, c, t].flatten().tolist()
                group = dist.new_group(members)
                if global_rank() in members:
                    mesh.data_group = group
    return mesh.data_group


def data_rank(mesh) -> int:
    """This rank's index along the data-parallel axes (replica major, then
    fsdp); the tensor and context ranks of one data shard share it."""
    return (axis_rank(mesh, AXIS_REPLICA) * axis_size(mesh, AXIS_FSDP)
            + axis_rank(mesh, AXIS_FSDP))


def data_shards(mesh) -> int:
    """Number of data shards: replica × fsdp."""
    return axis_size(mesh, AXIS_REPLICA) * axis_size(mesh, AXIS_FSDP)


def fsdp_mesh(mesh):
    """The sub-mesh FSDP2 shards over: ("replica", "fsdp") — HSDP, sharded
    over fsdp and replicated over replica — or ("fsdp",) alone when there
    is one replica; None when fsdp has size 1."""
    if axis_size(mesh, AXIS_FSDP) == 1:
        return None
    if axis_size(mesh, AXIS_REPLICA) == 1:
        return mesh[AXIS_FSDP]
    return mesh[AXIS_REPLICA, AXIS_FSDP]


def tensor_mesh(mesh):
    """The sub-mesh of the tensor axis, or None at size 1."""
    if axis_size(mesh, AXIS_TENSOR) == 1:
        return None
    return mesh[AXIS_TENSOR]


def local_batch_slice(mesh, global_batch: int) -> int:
    """Per-data-shard batch size."""
    data = data_shards(mesh)
    if global_batch % data != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by data={data}")
    return global_batch // data
