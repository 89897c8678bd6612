"""The device mesh (port of ``pretrain_gnns_tpu.parallel.mesh``).

A JAX mesh lays a ``data`` axis over devices that one or several
processes own. Here each process owns one device, so the 1-D mesh is the
process group's world: :func:`make_mesh` returns a
``torch.distributed.device_mesh.DeviceMesh`` over it, rank ``r`` at
position ``r``.

``replicated`` and ``batch_sharded`` (the JAX module's shardings) have no
counterpart object: a replicated value is each rank's own copy, kept equal
by the step's all-reduce (``parallel.dp``), and the batch's leading device
axis is the rank itself, each rank holding its own column's batch."""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "data") -> DeviceMesh:
    """The 1-D mesh of ``n_devices`` (default: the world) named
    ``axis_name``. Raises ``ValueError`` ("need N devices, have M") when
    the world is smaller, or when ``n_devices`` is not the world (one
    process drives one device, so a mesh spans every process), and
    ``RuntimeError`` without a process group
    (``parallel.multihost.initialize``)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else int(n_devices)
    if world < n:
        raise ValueError(f"need {n} devices, have {world}")
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs a process group: launch one process a device "
            "(PGT_COORDINATOR / PGT_NUM_PROCESSES / PGT_PROCESS_ID, or "
            "torchrun with PGT_NUM_PROCESSES=auto) and call "
            "parallel.multihost.initialize()")
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a world of {world} "
                         "processes: a process drives one device, so the "
                         "mesh spans the world")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (n,), mesh_dim_names=(axis_name,))
