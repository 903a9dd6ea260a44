"""The env mesh and sharded batched rollouts.

The port's `rmp_tpu/parallel/mesh.py`. The workload's only parallel axis is
the environment batch, and envs are independent: each rank of the process
group runs its own slice of the global batch on its own device, and only
the final scalar metrics cross processes (all-reduces of 0-d tensors). The
JAX package checks that invariant on compiled HLO; PyTorch has none, so
`record_collectives` records every collective issued while it is open and
`audit_collectives` holds the record to the same rule.

Where the JAX package keys each env, the port's batched state draws from
one torch.Generator over the rows of the global batch (EnvState.stream):
every rank holds the same generator, draws for all rows and keeps its own,
so a scene that draws mid-rollout (randomized resampling) gives the same
result sharded as unsharded.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from rmp_tpu_torch import default_device
from rmp_tpu_torch.envs.base import Env, EnvState, make_rollout
from rmp_tpu_torch.utils.checkpoint import _leaves, _rebuild, batch_of

ENV_AXIS = "env"

# the collectives of torch.distributed that record_collectives wraps
_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                "all_gather_object", "all_to_all", "all_to_all_single",
                "broadcast", "broadcast_object_list", "reduce",
                "reduce_scatter", "reduce_scatter_tensor", "gather",
                "scatter", "send", "recv", "isend", "irecv")


@dataclasses.dataclass(frozen=True)
class EnvMesh:
    """A 1-D mesh with the axis 'env' over the ranks of the default
    process group: this process's rank, the world size and its device. A
    process with no group is a mesh of one rank."""

    rank: int
    size: int
    device: torch.device
    axis_names: tuple[str, ...] = (ENV_AXIS,)


def group_device() -> torch.device:
    """The device of this rank: the current card under NCCL, the CPU under
    gloo, the default device without a group."""
    if not dist.is_initialized():
        return default_device()
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(devices=None) -> EnvMesh:
    """The ('env',) mesh over the world: this rank's index and the world
    size from the process group (one rank without one), and its device,
    `devices[rank]` when given (one per rank), else group_device()."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    size = dist.get_world_size() if dist.is_initialized() else 1
    if devices is not None:
        devices = list(devices)
        if len(devices) != size:
            raise ValueError(f"{len(devices)} devices for a world of {size}")
        device = torch.device(devices[rank])
    else:
        device = group_device()
    return EnvMesh(rank=rank, size=size, device=device)


def shard_env_batch(tree, mesh: EnvMesh):
    """This rank's slice of a global batched tree (an EnvState), every
    tensor cut on its leading env axis and moved to the rank's device. The
    global batch must split evenly over the ranks, as the JAX package's
    sharding requires. A generator leaf becomes a new generator on the
    rank's device, set to the global one's state where both lie on one
    kind of device, else seeded with its initial seed. An EnvState's
    stream keeps the global batch's rows (rng_size, rng_offset), so every
    rank draws what the whole batch draws for its envs."""
    B = batch_of(tree)
    if B % mesh.size:
        raise ValueError(f"a batch of {B} envs does not split over "
                         f"{mesh.size} ranks")
    per = B // mesh.size
    start = mesh.rank * per
    if isinstance(tree, EnvState):
        size = tree.rng_size or B
        tree = dataclasses.replace(
            tree, rng_size=size, rng_offset=(tree.rng_offset + start) % size)

    def local(x):
        if isinstance(x, torch.Generator):
            gen = torch.Generator(device=mesh.device)
            if x.device.type == mesh.device.type:
                gen.set_state(x.get_state())
            else:
                gen.manual_seed(x.initial_seed())
            return gen
        return x[start:start + per].to(mesh.device)
    return _rebuild(tree, iter([local(x) for x in _leaves(tree)]))


@contextlib.contextmanager
def record_collectives():
    """A list that receives one entry per torch.distributed collective
    issued while the block runs: {'op': name, 'shapes': [tensor shapes]}
    (the tensors among its arguments, lists of tensors included)."""
    record: list[dict] = []
    originals = {name: getattr(dist, name) for name in _COLLECTIVES
                 if hasattr(dist, name)}

    def wrap(name, fn):
        def recorded(*args, **kwargs):
            shapes = []
            for a in (*args, *kwargs.values()):
                for t in (a if isinstance(a, (list, tuple)) else (a,)):
                    if isinstance(t, torch.Tensor):
                        shapes.append(tuple(t.shape))
            record.append(dict(op=name, shapes=shapes))
            return fn(*args, **kwargs)
        return recorded

    for name, fn in originals.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield record
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)


def audit_collectives(record: list[dict]) -> dict:
    """The zero-comms invariant of a sharded rollout on a record of
    record_collectives: no collective that moves batched data (all-gather,
    all-to-all, broadcast, scatter, gather, reduce-scatter, point to
    point), and every all-reduce on scalars only (the final metrics).
    Returns {'all_reduce': n, 'scalar_only': True}; raises AssertionError
    naming the offending entries otherwise."""
    bad = [r for r in record if r["op"] != "all_reduce"]
    if bad:
        raise AssertionError(
            "data-moving collectives in the sharded rollout (the env axis "
            f"must stay embarrassingly parallel): {bad}")
    wide = [r for r in record if any(s != () for s in r["shapes"])]
    if wide:
        raise AssertionError(
            f"non-scalar all-reduce in the sharded rollout: {wide}")
    return {"all_reduce": len(record), "scalar_only": True}


def _all_reduce(x: torch.Tensor, op=None) -> torch.Tensor:
    """x reduced over the world in place (SUM unless `op`); x as it is
    without a process group."""
    if dist.is_initialized():
        dist.all_reduce(x, op=op or dist.ReduceOp.SUM)
    return x


def pmean_metrics(metrics: dict) -> dict:
    """The mean over the ranks of each scalar metric: one all-reduce of a
    0-d tensor per entry."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    return {k: _all_reduce(v.detach().clone()) / size
            for k, v in metrics.items()}


def check_equal_shards(B: int, device) -> None:
    """Raise on every rank unless every rank holds B envs: the mean of the
    ranks' means is the global mean only then. Two scalar all-reduces
    (the least and the largest shard), so every rank sees the same
    answer and none waits on a rank that raised."""
    if not dist.is_initialized():
        return
    lo = _all_reduce(torch.tensor(B, device=device), dist.ReduceOp.MIN)
    hi = _all_reduce(torch.tensor(B, device=device), dist.ReduceOp.MAX)
    lo, hi = int(lo), int(hi)
    if lo != hi:
        raise ValueError(f"unequal shards: {lo} to {hi} envs a rank; take "
                         f"each rank's slice with local_batch_slice")


def make_sharded_rollout(env: Env, n_ticks: int, mesh: EnvMesh,
                         collect_aux: bool = False) -> Callable:
    """fn(local_states, params) -> (final local states, metrics) or, with
    collect_aux, (final, metrics, aux): `make_rollout` (the per-env
    semantics, as the JAX package vmaps make_rollout) on this rank's slice,
    then the metrics as means over the global batch: success_rate (envs
    that reached a goal at any tick), goals_reached (final solved_count)
    and mean_abs_qdd, each a 0-d tensor reduced by pmean_metrics. The
    shards must be equal (check_equal_shards)."""
    rollout = make_rollout(env, n_ticks)

    def run(states, params):
        if states.sim.q.device != mesh.device:
            raise ValueError(f"states on {states.sim.q.device}, the mesh's "
                             f"rank on {mesh.device}")
        check_equal_shards(states.sim.q.shape[0], mesh.device)
        final, aux = rollout(states, params)
        metrics = pmean_metrics(dict(
            success_rate=aux["solved"].any(dim=1).float().mean(),
            goals_reached=final.solved_count.float().mean(),
            mean_abs_qdd=aux["qdd"].abs().mean()))
        if collect_aux:
            return final, metrics, aux
        return final, metrics
    return run
