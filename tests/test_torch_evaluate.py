"""rmp_tpu_torch.evaluate.task_statistics against the metric block of
experiments/evaluate.py (lines 67-141), written out in numpy here on the
same aux arrays, with the JAX package's clearance queries for the
penetration rate. The cases: an env with no event, events on tick 0 (a
goal reached, a stuck timeout), a goal reached after a timeout, a goal
inside an obstacle, a penetrating final pose and a NaN pose."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu.models import kinematics as JK
from rmp_tpu.models import robots as jrobots
from rmp_tpu.sim import collision as jcollision
from rmp_tpu_torch import envs
from rmp_tpu_torch.evaluate import min_clearance, task_statistics

torch.set_num_threads(1)

SCENE = "franka/randomized_cluttered"
B, T = 8, 6


def _aux():
    """solved / resample (B, T): env 0 no event; 1 solved on tick 0; 2
    stuck on tick 0, then solved on tick 3; 3 solved on tick 2 twice more
    later; 4 stuck on tick 4 only; the rest nothing."""
    sol = np.zeros((B, T), bool)
    ev = np.zeros((B, T), bool)
    sol[1, 0] = ev[1, 0] = True
    ev[2, 0] = True
    sol[2, 3] = ev[2, 3] = True
    sol[3, [2, 4, 5]] = ev[3, [2, 4, 5]] = True
    ev[4, 4] = True
    return sol, ev


def _states(geometry: str):
    """(env, initial, final): a reset of B envs; env 5's initial goal moved
    inside its first obstacle; the final poses are the initial ones, with
    env 6's first obstacle moved onto its hand and env 7's q NaN."""
    env = envs.make(SCENE, device="cpu")
    env.collision_geometry = geometry
    initial = envs.make_batched_reset(env, B, 3)()
    obs = initial.sim.obstacles
    goal = initial.sim.goal.clone()
    goal[5] = (obs.p0[5, 0] + obs.p1[5, 0]) / 2
    initial = dataclasses.replace(initial, sim=dataclasses.replace(
        initial.sim, goal=goal))
    hand = envs.base.ee_position(env, initial.sim)[6]
    p0, p1 = obs.p0.clone(), obs.p1.clone()
    p0[6, 0], p1[6, 0] = hand - 0.02, hand + 0.02
    q = initial.sim.q.clone()
    q[7, 3] = float("nan")
    final = dataclasses.replace(initial, sim=dataclasses.replace(
        initial.sim, q=q, obstacles=dataclasses.replace(obs, p0=p0, p1=p1)),
        solved_count=torch.tensor([0, 1, 1, 3, 0, 0, 0, 0],
                                  dtype=torch.int32))
    return env, initial, final


def _jax_min_clearance(sim, geometry: str) -> np.ndarray:
    model = jrobots.franka_panda()
    query = (jcollision.robot_obstacle_distances_hull if geometry == "hull"
             else jcollision.robot_obstacle_distances)

    def one(q, p0, p1, r):
        obs = jcollision.ObstacleSet(p0, p1, r, kinds=sim.obstacles.kinds)
        return jnp.min(query(model, JK.fk_all(model, q), obs)[3])
    return np.asarray(jax.vmap(one)(*(jnp.asarray(x.numpy()) for x in (
        sim.q, sim.obstacles.p0, sim.obstacles.p1, sim.obstacles.radius))))


def _numpy_statistics(sol, ev, initial, final, clear):
    """experiments/evaluate.py's formulas, in numpy."""
    solved_any = sol.any(axis=1)
    has_ev = ev.any(axis=1)
    first_goal = has_ev & sol[np.arange(B), ev.argmax(axis=1)]
    g = initial.sim.goal.numpy()
    o = initial.sim.obstacles
    p0, p1, r = o.p0.numpy(), o.p1.numpy(), o.radius.numpy()
    seg = p1 - p0
    t = np.clip(np.einsum("bkc,bkc->bk", g[:, None] - p0, seg)
                / np.maximum(np.einsum("bkc,bkc->bk", seg, seg), 1e-12), 0, 1)
    d = np.linalg.norm(g[:, None] - (p0 + t[..., None] * seg), axis=-1) - r
    feasible = d.min(axis=1) > 0.03
    goals = final.solved_count.numpy()
    return dict(
        success_rate=solved_any.mean(), goal_feasible_rate=feasible.mean(),
        first_goal_success_rate=first_goal.mean(),
        success_rate_feasible_goals=first_goal[feasible].mean(),
        goals_reached_mean=goals.mean(), goals_reached_max=goals.max(),
        final_penetration_rate=(clear < -0.01).mean(),
        nan_rate=np.isnan(final.sim.q.numpy()).any(axis=1).mean())


@pytest.mark.parametrize("geometry", ["capsule", "hull"])
def test_statistics_match_the_evaluate_formulas(geometry):
    env, initial, final = _states(geometry)
    sol, ev = _aux()
    aux = dict(solved=torch.tensor(sol), resample=torch.tensor(ev))
    clear = _jax_min_clearance(final.sim, geometry)
    got = task_statistics(env, initial, final, aux)
    want = _numpy_statistics(sol, ev, initial, final, clear)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(float(v), abs=1e-12), k
    assert got["first_goal_success_rate"] == 2 / B      # envs 1 and 3
    assert got["nan_rate"] == 1 / B
    ours = min_clearance(env, final.sim).numpy()
    finite = np.isfinite(clear)
    np.testing.assert_allclose(ours[finite], clear[finite], atol=1e-4)
    assert ours[6] < -0.01 and np.isnan(ours[7])
    # without a resample entry the first goal is any goal
    quiet = task_statistics(env, initial, final, dict(solved=aux["solved"]))
    assert quiet["first_goal_success_rate"] == got["success_rate"]
