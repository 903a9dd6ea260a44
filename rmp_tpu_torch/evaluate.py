"""Task statistics of a randomized rollout.

The port's metric block of `experiments/evaluate.py` (lines 67-141): from
a scene's initial and final states and the rollout's aux (entries (B, T)),
the success rates, goal feasibility, goals reached, final penetration and
NaN rate. The command-line sweep around it is
`rmp_tpu_torch/experiments/evaluate.py`.
"""
from __future__ import annotations

import torch

from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.sim.collision import (capsule_capsule_query,
                                         robot_obstacle_distances,
                                         robot_obstacle_distances_hull_batched)
from rmp_tpu_torch.sim.data import COLD_ITERS

FEASIBLE_CLEARANCE = 0.03    # m: a goal this clear of every obstacle
PENETRATION = -0.01          # m: a final clearance below this penetrates


def goal_clearance(sim) -> torch.Tensor:
    """(B,) least distance from each env's goal (or goals: (B, 3) or
    (B, G, 3)) to its obstacles (B, K, ...), by the capsule metric."""
    B = sim.q.shape[0]
    goals = sim.goal.reshape(B, -1, 3)                    # (B, G, 3)
    obs = sim.obstacles
    _, _, _, d = capsule_capsule_query(
        goals[:, :, None], goals[:, :, None],
        torch.zeros(1, dtype=goals.dtype, device=goals.device),
        obs.p0[:, None], obs.p1[:, None], obs.radius[:, None])
    return d.amin(dim=(1, 2))


def min_clearance(env, sim) -> torch.Tensor:
    """(B,) least link-obstacle distance at sim.q: the capsule query, or in
    the hull tier every (link, obstacle) pair cold through K4, as the JAX
    package's robot_obstacle_distances_hull queries them."""
    T_all = K.fk_all(env.model, sim.q)
    if env.collision_geometry == "hull":
        d = robot_obstacle_distances_hull_batched(
            env.model, T_all, sim.obstacles, iters=COLD_ITERS,
            top_m=sim.obstacles.count)[3]
    else:
        d = robot_obstacle_distances(env.model, T_all, sim.obstacles)[3]
    return d.amin(dim=(1, 2))


def task_statistics(env, initial, final, aux: dict) -> dict:
    """The statistics of experiments/evaluate.py as Python numbers:

    - success_rate: envs that reached a goal at any tick;
    - first_goal_success_rate: envs whose first resample event (a goal
      reached, or a stuck timeout) was a goal reached; without a
      'resample' entry, success_rate;
    - goal_feasible_rate: initial goals more than 3 cm clear of every
      obstacle; success_rate_feasible_goals: first-goal success among them;
    - goals_reached_mean / max: final.solved_count;
    - final_penetration_rate: final poses with a link more than 1 cm inside
      an obstacle (min_clearance);
    - nan_rate: final poses with a NaN joint.
    The feasibility and penetration entries are None without obstacles."""
    solved = aux["solved"]
    solved_any = solved.any(dim=1)
    if "resample" in aux:
        ev = aux["resample"]
        first = ev.to(torch.int8).argmax(dim=1, keepdim=True)
        first_goal = ev.any(dim=1) & solved.gather(1, first)[:, 0]
    else:
        first_goal = solved_any
    feasible = penetration = success_feasible = None
    if final.sim.obstacles is not None and final.sim.goal is not None:
        feasible = goal_clearance(initial.sim) > FEASIBLE_CLEARANCE
        if bool(feasible.any()):
            success_feasible = float(first_goal[feasible].double().mean())
        feasible = float(feasible.double().mean())
    if final.sim.obstacles is not None:
        penetration = float((min_clearance(env, final.sim) < PENETRATION)
                            .double().mean())
    goals = final.solved_count
    return dict(
        success_rate=float(solved_any.double().mean()),
        goal_feasible_rate=feasible,
        first_goal_success_rate=float(first_goal.double().mean()),
        success_rate_feasible_goals=success_feasible,
        goals_reached_mean=float(goals.double().mean()),
        goals_reached_max=int(goals.max()),
        final_penetration_rate=penetration,
        nan_rate=float(torch.isnan(final.sim.q).any(dim=1).double().mean()))
