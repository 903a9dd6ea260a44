"""Carry policy parameters, learned weights and rollout state across from
numpy.

These functions are how the same inputs reach both packages: the JAX
package's pytrees, mapped to numpy arrays (`jax.tree.map(np.asarray,
...)`), and the committed weight files (numpy arrays 'w0', 'b0', ...)
become the port's tensors; `net_to_numpy` writes a net the port trained
back in that layout.
"""
from __future__ import annotations

import numpy as np
import torch

from rmp_tpu_torch.envs.base import EnvState, generator
from rmp_tpu_torch.sim.collision import ObstacleSet
from rmp_tpu_torch.sim.world import SimState


def net_from_numpy(net, device) -> dict:
    """An MLP's weights {'w0': (n_in, n_out), 'b0': (n_out,), ...} as
    float32 tensors on `device`, from a dict of arrays or an opened .npz."""
    return {k: torch.tensor(np.asarray(net[k]), dtype=torch.float32,
                            device=device) for k in net.keys()}


def net_to_numpy(net: dict) -> dict:
    """The inverse of net_from_numpy: an MLP's weights as float32 numpy
    arrays under the same keys, the layout of the committed .npz assets
    (`np.savez(path, **net_to_numpy(net))` loads in either package)."""
    return {k: np.asarray(v.detach().cpu(), np.float32)
            for k, v in net.items()}


def params_from_numpy(params, device) -> tuple:
    """Per-policy param dicts: 0-d entries become Python floats (scalar
    gains), arrays float32 tensors on `device` (goals, the v1 joint limits
    and preferred configuration), and a nested dict (a learned leaf's
    'net') net_from_numpy's tensors."""
    out = []
    for prm in params:
        converted = {}
        for k, v in prm.items():
            if isinstance(v, dict):
                converted[k] = net_from_numpy(v, device)
                continue
            a = np.asarray(v)
            converted[k] = (float(a) if a.ndim == 0 else
                            torch.tensor(a, dtype=torch.float32,
                                         device=device))
        out.append(converted)
    return tuple(out)


def state_from_numpy(leaves: dict, device) -> EnvState:
    """EnvState of B environments from numpy arrays with leading axis B:
    q, qd (B, n); t, goal_best (B,); goal (B, 3), one per arm (B, A, 3)
    (the dual arm's (B, 2, 3)) or None; steps,
    solved_count, phase, no_progress (B,) integers; obstacles None or a
    dict of p0, p1 (B, K, 3), radius (B, K) and an optional `kinds`
    sequence of strings (numpy 0-d string arrays, as a tree map leaves
    them, are taken too); gjk_warm (B, L, K, 3), the hull tier's warm
    carry, or absent / None; scratch, the scene's private state (nested
    dicts of arrays: float ones become float32, integer ones int32, bool
    ones bool), or absent / None. The resampling stream (EnvState.rng) is
    seeded with 0."""
    def f32(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)

    def i32(x):
        return torch.tensor(np.asarray(x), dtype=torch.int32, device=device)

    def tree(x):
        if isinstance(x, dict):
            return {k: tree(v) for k, v in x.items()}
        a = np.asarray(x)
        if a.dtype == np.bool_:
            return torch.tensor(a, device=device)
        return i32(a) if np.issubdtype(a.dtype, np.integer) else f32(a)

    obs = leaves.get("obstacles")
    kinds = None if obs is None else obs.get("kinds")
    obstacles = None if obs is None else ObstacleSet(
        f32(obs["p0"]), f32(obs["p1"]), f32(obs["radius"]),
        kinds=None if kinds is None else tuple(str(k) for k in kinds))
    goal = leaves.get("goal")
    warm = leaves.get("gjk_warm")
    sim = SimState(q=f32(leaves["q"]), qd=f32(leaves["qd"]),
                   t=f32(leaves["t"]), obstacles=obstacles,
                   goal=None if goal is None else f32(goal))
    return EnvState(sim=sim, steps=i32(leaves["steps"]),
                    solved_count=i32(leaves["solved_count"]),
                    phase=i32(leaves["phase"]),
                    goal_best=f32(leaves["goal_best"]),
                    no_progress=i32(leaves["no_progress"]),
                    gjk_warm=None if warm is None else f32(warm),
                    rng=generator(device, 0),
                    scratch=None if leaves.get("scratch") is None
                    else tree(leaves["scratch"]))
