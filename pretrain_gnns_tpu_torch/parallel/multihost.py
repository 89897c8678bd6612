"""Multi-process execution (port of ``pretrain_gnns_tpu.parallel.multihost``).

The JAX package runs one program over a mesh of every process's devices;
a process may own several. Here a process owns one device, and the
``torch.distributed`` process group's world is the mesh's ``data`` axis:
rank ``r`` is column ``r`` (ROADMAP L3). What the JAX module does maps so:

- **bootstrap**: :func:`initialize` reads the same variables,
  ``PGT_COORDINATOR`` (``HOST:PORT``, or any ``tcp://`` / ``file://`` URL),
  ``PGT_NUM_PROCESSES`` and ``PGT_PROCESS_ID``, and is a no-op without
  them, so every CLI calls it unconditionally. ``PGT_NUM_PROCESSES=auto``,
  the JAX package's auto-detection, reads torch's launcher environment
  (``torchrun``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``). The backend follows the device: NCCL for CUDA, gloo
  for the CPU. A rank on CUDA takes card ``LOCAL_RANK`` (0 when unset).
  ``cpu_devices_per_process`` / ``PGT_CPU_DEVICES`` has no counterpart,
  since a process drives one device: a value other than 1 raises.
- **what stands in for the global arrays**: ``put_replicated`` and
  ``put_col_sharded`` have no meaning with one device a process. The
  replicated train state is each rank's own copy, identical by seed and
  broadcast from rank 0 before the first step (``parallel.dp.broadcast_
  state``); a rank's descriptors are its own column of each group of
  ``world`` batches (:func:`local_cols`, the loaders' ``shard_cols``).
- **process-0 gating**: :func:`is_main` guards logging and file writes,
  :func:`sync` is the barrier after them.

NCCL inside a captured CUDA graph (the epoch trainer's replays hold each
step's all-reduce): :func:`init_group` turns NCCL's asynchronous error
handling off (``TORCH_NCCL_ASYNC_ERROR_HANDLING=0``), as PyTorch's CUDA
graph notes ask for collectives under capture; the communicator is made
when the group is (``device_id``), and the warm-up steps run the
collective eagerly before any capture."""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

ENV_VARS = ("PGT_COORDINATOR", "PGT_NUM_PROCESSES", "PGT_PROCESS_ID",
            "PGT_CPU_DEVICES")


def _device(device) -> torch.device:
    """The run's device: ``None`` means CUDA, which must then exist (the
    port's entry points have no silent CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run the ranks on the CPU (gloo)")
    return dev


def init_method(coordinator_address: str) -> str:
    """``HOST:PORT`` as a ``tcp://`` URL; a URL stays as it is."""
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def init_group(method: str, world_size: Optional[int] = None,
               rank: Optional[int] = None, device=None) -> None:
    """Initialize the default process group at ``method`` (``env://``,
    ``tcp://HOST:PORT`` or ``file:///path``) over ``world_size`` ranks as
    ``rank``: NCCL bound to card ``LOCAL_RANK`` when ``device`` is CUDA
    (the default), gloo on the CPU."""
    dev = _device(device)
    kw = {}
    if world_size is not None:
        kw.update(world_size=int(world_size), rank=int(rank))
    if dev.type == "cuda":
        # collectives captured by CUDA graphs: no asynchronous error
        # handling (its watchdog would query work made under capture)
        os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "0"
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", init_method=method,
                                device_id=torch.device("cuda", local), **kw)
    else:
        dist.init_process_group("gloo", init_method=method, **kw)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    cpu_devices_per_process: Optional[int] = None,
    device=None,
) -> bool:
    """Join the run's process group. Returns True when a multi-process
    group was initialized, False for the (default) single-process case.

    Arguments fall back to ``PGT_COORDINATOR``, ``PGT_NUM_PROCESSES``,
    ``PGT_PROCESS_ID`` and ``PGT_CPU_DEVICES``; with none set this is a
    no-op. ``PGT_NUM_PROCESSES=auto`` initializes from torch's launcher
    environment (``init_method="env://"``). Raises ``ValueError`` when a
    multi-process run lacks its coordinator or process id, and when a
    process is asked to drive more than one CPU device."""
    coordinator_address = coordinator_address or os.environ.get(
        "PGT_COORDINATOR")
    if cpu_devices_per_process is None and os.environ.get("PGT_CPU_DEVICES"):
        cpu_devices_per_process = int(os.environ["PGT_CPU_DEVICES"])
    if cpu_devices_per_process not in (None, 1):
        raise ValueError(
            f"cpu_devices_per_process={cpu_devices_per_process}: a process "
            "of the port drives one device; launch one process a device")
    env_np = os.environ.get("PGT_NUM_PROCESSES")
    if num_processes is None and env_np:
        if env_np == "auto":
            init_group("env://", device=device)
            return True
        num_processes = int(env_np)
    if process_id is None and os.environ.get("PGT_PROCESS_ID"):
        process_id = int(os.environ["PGT_PROCESS_ID"])
    if not num_processes or num_processes <= 1:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError(
            "multi-process run needs coordinator_address and process_id "
            "(PGT_COORDINATOR / PGT_PROCESS_ID)")
    init_group(init_method(coordinator_address), num_processes, process_id,
               device)
    return True


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """True on the process that owns logging and file writes."""
    return process_index() == 0


def sync(name: str = "barrier") -> None:
    """A barrier of the whole group (a no-op without one). ``name`` says
    where, as the JAX function's does."""
    del name
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def local_cols(mesh=None, axis: str = "data") -> Tuple[int, int, int]:
    """(n_global, lo, hi): this process's columns along the data axis.
    A process owns one device, so that is ``(world, rank, rank + 1)``;
    ``mesh`` (a ``parallel.mesh.make_mesh`` mesh) must span the world."""
    world, rank = process_count(), process_index()
    if mesh is not None and mesh.size() != world:
        raise ValueError(f"the mesh spans {mesh.size()} devices, the world "
                         f"{world} processes")
    del axis
    return world, rank, rank + 1


def to_host(tree: Any) -> Any:
    """Tensors of a nested dict, list or tuple as numpy arrays on the
    host (for a checkpoint or a trunk written by rank 0)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree
