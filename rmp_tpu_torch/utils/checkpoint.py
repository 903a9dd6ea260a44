"""Checkpoint / resume for rollout states and training loops.

The port's `rmp_tpu/utils/checkpoint.py` (`save_checkpoint`,
`restore_checkpoint`, `save_train_checkpoint`, `restore_train_checkpoint`,
`save_checkpoint_sharded`, `restore_checkpoint_sharded`).
The files are `torch.save` archives, read back with
`torch.load(weights_only=True)`; the JAX package's flax-msgpack files are
not read. A state tree is flattened to its leaves in a fixed order
(dataclass fields, dict items and sequence entries in order), so any
EnvState-like tree of tensors restores against a template of the same
structure, the resampling stream (a torch.Generator leaf) included: its
state is saved, and the restored tree holds a new generator on the
template's device set to it. A sharded checkpoint is a directory: a file
per rank of the process group with its slice's leaves, and a manifest of
the global shapes.
"""
from __future__ import annotations

import dataclasses
import json
import os

import torch
import torch.distributed as dist

_FORMAT = "rmp_tpu_torch.checkpoint/1"
_SHARDED_FORMAT = "rmp_tpu_torch.checkpoint.sharded/1"
_MANIFEST = "manifest.json"


def _leaves(tree) -> list:
    """The tensor and generator leaves of `tree` in order; every other
    value (None, strings, numbers) is structure, taken from the template."""
    if isinstance(tree, (torch.Tensor, torch.Generator)):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _rebuild(like, leaves):
    """`like` with its leaves replaced, in order, from the iterator."""
    if isinstance(like, (torch.Tensor, torch.Generator)):
        return next(leaves)
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), leaves)
            for f in dataclasses.fields(like) if f.init})
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return like


def _to_saved(x):
    if isinstance(x, torch.Generator):
        return {"generator_state": x.get_state()}
    return x.detach().cpu()


def _from_saved(saved, like):
    if isinstance(like, torch.Generator):
        if not isinstance(saved, dict):
            raise ValueError("checkpoint holds a tensor where the template "
                             "holds a generator")
        gen = torch.Generator(device=like.device)
        gen.set_state(saved["generator_state"])
        return gen
    if not isinstance(saved, torch.Tensor) or saved.shape != like.shape:
        raise ValueError(f"checkpoint leaf {getattr(saved, 'shape', saved)} "
                         f"does not fit the template's {tuple(like.shape)}")
    return saved.to(device=like.device, dtype=like.dtype)


def save_checkpoint(path: str, tree) -> None:
    """Write the leaves of any state tree (tensors, on the host, and each
    generator's state)."""
    torch.save({"format": _FORMAT,
                "leaves": [_to_saved(x) for x in _leaves(tree)]}, path)


def restore_checkpoint(path: str, like):
    """The tree saved at `path`, restored into the structure of `like`:
    each tensor on the template leaf's device and dtype, each generator a
    new one on the template's device."""
    data = torch.load(path, weights_only=True)
    template = _leaves(like)
    if data.get("format") != _FORMAT or len(data["leaves"]) != len(template):
        raise ValueError(f"{path}: {len(data.get('leaves', ()))} leaves for "
                         f"a template of {len(template)}")
    restored = [_from_saved(s, t) for s, t in zip(data["leaves"], template)]
    return _rebuild(like, iter(restored))


def save_train_checkpoint(path: str, step: int, net: dict, opt_state: dict,
                          best_val: float, best_net: dict,
                          meta: dict | None = None) -> None:
    """Training-loop checkpoint of the port's trainers
    (rmp_tpu_torch/experiments/train_neural_rmp.py, train_neural_clutter.py):
    the loop position, the best loss so far, the live net, the
    torch.optim state_dict (Adam's moments and step counts) and the best
    iterate, and `meta`, plain values the trainer needs to read the rest
    (train_neural_clutter: the criterion that scored the best iterate).
    Written atomically (a temporary file, then os.replace), so a kill
    mid-write leaves the previous checkpoint whole."""
    tree = dict(format=_FORMAT, step=int(step), best_val=float(best_val),
                net={k: v.detach().cpu() for k, v in net.items()},
                opt_state=opt_state,
                best_net={k: v.detach().cpu() for k, v in best_net.items()},
                meta=dict(meta or {}))
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def restore_train_checkpoint(path: str, net: dict):
    """(step, net, opt_state, best_val, best_net) of a save_train_checkpoint
    file; the nets' tensors on the devices and dtypes of `net` (a freshly
    initialised net of the same shapes), opt_state as saved, for
    `optimizer.load_state_dict`."""
    c = torch.load(path, weights_only=True)
    if c.get("format") != _FORMAT:
        raise ValueError(f"{path} is not a training checkpoint of this port")

    def like(saved):
        if sorted(saved) != sorted(net):
            raise ValueError(f"checkpoint net {sorted(saved)} does not fit "
                             f"{sorted(net)}")
        return {k: _from_saved(saved[k], net[k].detach()) for k in net}
    return (int(c["step"]), like(c["net"]), c["opt_state"],
            float(c["best_val"]), like(c["best_net"]))


def train_checkpoint_meta(path: str) -> dict:
    """The `meta` of a save_train_checkpoint file ({} where none was
    saved)."""
    c = torch.load(path, weights_only=True)
    if c.get("format") != _FORMAT:
        raise ValueError(f"{path} is not a training checkpoint of this port")
    return dict(c.get("meta") or {})


def batch_of(tree) -> int:
    """The leading (env) axis that every tensor of a batched tree shares."""
    tensors = [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]
    sizes = {x.shape[0] if x.dim() else None for x in tensors}
    if len(sizes) != 1 or None in sizes:
        raise ValueError(f"not a batched tree: leading sizes "
                         f"{sorted(sizes, key=str)}")
    return sizes.pop()


def _world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _shard_file(path: str, rank: int, world: int) -> str:
    return os.path.join(path, f"shard_{rank:05d}_of_{world:05d}.pt")


def _write_atomic(target: str, write) -> None:
    tmp = f"{target}.tmp{os.getpid()}"
    write(tmp)
    os.replace(tmp, target)


def save_checkpoint_sharded(path: str, tree) -> None:
    """Checkpoint of an env-sharded batched tree (parallel.shard_env_batch)
    into the directory `path`: each rank of the process group (one without
    a group) writes its own slice's leaves, rank 0 a manifest of the global
    shapes, and every rank waits at a barrier until all are written. The
    ranks hold equal slices, rank r the r-th."""
    rank, world = _world()
    leaves = _leaves(tree)
    B = batch_of(tree)
    os.makedirs(path, exist_ok=True)
    _write_atomic(_shard_file(path, rank, world), lambda f: torch.save(
        {"format": _SHARDED_FORMAT,
         "leaves": [_to_saved(x) for x in leaves]}, f))
    if rank == 0:
        manifest = {"format": _SHARDED_FORMAT, "world": world,
                    "global_batch": B * world,
                    "leaves": [{"generator": True}
                               if isinstance(x, torch.Generator) else
                               {"shape": [B * world, *x.shape[1:]],
                                "dtype": str(x.dtype)} for x in leaves]}

        def write(f):
            with open(f, "w") as out:
                json.dump(manifest, out)
        _write_atomic(os.path.join(path, _MANIFEST), write)
    if dist.is_initialized():
        dist.barrier()


def restore_checkpoint_sharded(path: str, like):
    """A save_checkpoint_sharded checkpoint restored into the structure of
    `like`, this rank's slice of the global batch on this world: rank r
    of W takes rows [r B, (r + 1) B) with B = like's batch, B W the saved
    global batch, whatever world saved it. Tensors come back bit for bit on
    the template's devices and dtypes; a generator leaf takes the state
    saved by the shard that held the slice's first row."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    template = _leaves(like)
    if (manifest.get("format") != _SHARDED_FORMAT
            or len(manifest["leaves"]) != len(template)):
        raise ValueError(f"{path}: {len(manifest.get('leaves', ()))} leaves "
                         f"for a template of {len(template)}")
    rank, world = _world()
    B = batch_of(like)
    total, saved_world = manifest["global_batch"], manifest["world"]
    if B * world != total:
        raise ValueError(f"{path} holds {total} envs; {world} ranks of {B} "
                         f"do not cover them")
    start, per = rank * B, total // saved_world
    shards = {r: torch.load(_shard_file(path, r, saved_world),
                            weights_only=True)
              for r in range(start // per, (start + B - 1) // per + 1)}
    restored = []
    for i, (meta, t) in enumerate(zip(manifest["leaves"], template)):
        if meta.get("generator"):
            restored.append(_from_saved(shards[start // per]["leaves"][i], t))
            continue
        if list(meta["shape"][1:]) != list(t.shape[1:]):
            raise ValueError(f"checkpoint leaf {meta['shape']} does not fit "
                             f"the template's {tuple(t.shape)}")
        parts = [shards[r]["leaves"][i][max(start - r * per, 0):
                                        min(start + B - r * per, per)]
                 for r in sorted(shards)]
        restored.append(_from_saved(torch.cat(parts), t))
    return _rebuild(like, iter(restored))
