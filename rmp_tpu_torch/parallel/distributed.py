"""The process group of a multi-process (or multi-host) run.

The port's `rmp_tpu/parallel/distributed.py`. Nothing discovers a cluster
here: each process calls `initialize` with the coordinator's address, the
number of processes and its own index, then builds the ('env',) mesh
(`global_env_mesh`) and runs its slice of the global env batch
(`local_batch_slice`); only the final metrics cross processes
(parallel/mesh.py).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from rmp_tpu_torch import default_device
from rmp_tpu_torch.parallel.mesh import EnvMesh, make_mesh


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, device=None) -> torch.device:
    """init_process_group over tcp://coordinator_address (host:port) with
    world size num_processes and rank process_id. The backend follows the
    device: NCCL on a card (`device`, default the card; a device without
    an index takes card process_id mod the card count, made current), gloo
    on the CPU; NCCL never falls back to gloo. Returns this rank's
    device."""
    device = default_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda",
                                  process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for {device}")
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return device


def global_env_mesh() -> EnvMesh:
    """The ('env',) mesh over every rank of the group (make_mesh)."""
    return make_mesh()


def local_batch_slice(global_batch: int) -> tuple[int, int]:
    """(start, size) of this rank's shard of a global env batch: an equal
    share, global_batch // world size (the remainder is run by no rank)."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    per = global_batch // size
    return rank * per, per


def shutdown() -> None:
    """Destroy the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
