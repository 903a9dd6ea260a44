"""The hull tier of the two-joint robot and the UR5 against the JAX package:
the synthetic hull tables, `ops/gjk.support_sphere`, the per-env hull query
`sim/collision.robot_obstacle_distances_hull` (with the analytic box case of
tests/test_gjk.py), K4's plain version against JAX's K4 body run eagerly on
the support ties these tables are full of, and 5-tick parity of each
scene's hull tier at B = 8 (the per-env semantics in both packages). One
B = 128 tick against JAX's kernel path: tests/test_torch_hull_models_tick.py.

The query tolerances are those of tests/test_torch_gjk.py (quantiles of
the distance difference, witnesses where the distances agree)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu import envs as jenvs
from rmp_tpu.models import hulls as jhulls
from rmp_tpu.models import kinematics as JK
from rmp_tpu.models import robots as jrobots
from rmp_tpu.ops import gjk as jgjk
from rmp_tpu.sim import collision as JC
from rmp_tpu_torch import envs
from rmp_tpu_torch.models import hulls, robots
from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.ops import cuda_gjk, gjk
from rmp_tpu_torch.sim import collision as C
from test_torch_gjk import (check_kernel_outputs, check_quantiles,
                            kernel_operands, link_dots, plain_and_jax, t)
from test_torch_scenes import (assert_tick_parity, perturbed_jax_states,
                               port_inputs)

torch.set_num_threads(1)

ROBOTS = {"two_joint": (robots.two_joint_robot, jrobots.two_joint_robot,
                        (3, 48, 3)),
          "ur5": (robots.ur5, jrobots.ur5, (6, 130, 3))}
HULL_SCENES = ("two_joint/05_obstacle_avoidance",
               "two_joint/05_obstacle_avoidance_variant",
               "ur5/02_obstacle_avoidance")


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_synthetic_hull_tables_equal_jax(robot):
    """Bit for bit, in collision-frame order, and on the device as built."""
    make, jmake, shape = ROBOTS[robot]
    table = hulls.hulls_for(make())
    assert table.shape == shape and table.dtype == np.float32
    np.testing.assert_array_equal(table, jhulls.hulls_for(jmake()))
    assert torch.equal(hulls.hull_table(make(), "cpu"), torch.as_tensor(table))


def test_support_sphere_matches_jax():
    rng = np.random.default_rng(5)
    c = rng.normal(size=(256, 3)).astype(np.float32)
    r = rng.uniform(0.0, 0.2, 256).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d[::7] = 0.0                                    # no direction: the centre
    d[1::7] *= np.float32(1e-9)
    got = gjk.support_sphere(t(c), t(r), t(d)).numpy()
    want = np.asarray(jgjk.support_sphere(c, r, d))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[::7], c[::7])


def test_two_joint_hull_query_analytic_box_case():
    """tests/test_gjk.py's case: a sphere of radius 0.1 at z = 0.5 above
    link_1's midpoint; the box's top face is at 0.075 + 0.025, so the
    exact clearance is 0.3, and the capsule tier (rounded box) reports
    less."""
    model = robots.two_joint_robot()
    T_all = K.fk_all(model, torch.zeros(1, model.n_q))
    obs = C.sphere_obstacle([0.5, 0.0, 0.5], 0.1).expand(1)
    d = C.robot_obstacle_distances_hull(model, T_all, obs)[3]
    exact = 0.5 - (0.075 + 0.025) - 0.1
    assert abs(float(d[0, 0, 0]) - exact) < 1e-3
    d_cap = C.robot_obstacle_distances(model, T_all, obs)[3]
    assert float(d_cap[0, 0, 0]) < float(d[0, 0, 0])


def test_hull_query_raises_without_a_table():
    """The hull tier of a robot with no table raises (no capsule
    fallback)."""
    model = dataclasses.replace(robots.ur5(), name="UR5-unknown")
    T_all = K.fk_all(model, torch.zeros(1, model.n_q))
    obs = C.sphere_obstacle([0.5, 0.0, 0.5], 0.1).expand(1)
    with pytest.raises(ValueError, match="no hull asset"):
        C.robot_obstacle_distances_hull(model, T_all, obs)


def _random_poses(robot, seed, batch=64):
    make, jmake, _ = ROBOTS[robot]
    model, jmodel = make(), jmake()
    rng = np.random.default_rng(seed)
    q = rng.uniform(-3.0, 3.0, (batch, model.n_q)).astype(np.float32)
    T = np.asarray(jax.vmap(lambda x: JK.fk_all(jmodel, x))(jnp.asarray(q)))
    return model, jmodel, T


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_hull_query_matches_jax_per_env(robot):
    """Random poses against a capsule, a sphere and a vertical cylinder per
    env: the port's per-env query (K4's plain version, every pair cold)
    against JAX's vmapped per-env query (the XLA GJK). A box's vertical
    face parallel to the cylinder's side meets it along a segment, where
    any point of the segment is a closest point: the two GJKs' witnesses
    part there by up to ~2.4 cm (CPU run), always along the contact set.
    So the distances are held at check_query's quantiles and the normals
    at p99 < 1e-2; the witnesses where the distances agree may part only
    perpendicular to the normal (< 1e-4 along it), and each witness pair
    lies its distance apart (to 1e-5, outside the 0.5 mm handoff)."""
    model, jmodel, T = _random_poses(robot, 11)
    B = T.shape[0]
    rng = np.random.default_rng(12)
    reach = 1.0 if robot == "ur5" else 2.0
    center = rng.uniform(-reach, reach, (B, 3, 3))
    center[..., 2] = rng.uniform(0.0, 0.6, (B, 3))
    half = np.zeros((B, 3, 3))
    half[:, 0] = rng.normal(size=(B, 3)) * 0.1       # a capsule
    half[:, 2, 2] = 0.3                              # a vertical cylinder
    p0 = (center - half).astype(np.float32)
    p1 = (center + half).astype(np.float32)
    radius = rng.uniform(0.03, 0.12, (B, 3)).astype(np.float32)
    kinds = ("capsule", "capsule", "cylinder")
    jobs = JC.ObstacleSet(jnp.asarray(p0), jnp.asarray(p1),
                          jnp.asarray(radius), kinds=kinds)
    want = [np.asarray(x) for x in jax.jit(jax.vmap(
        lambda T_, o: JC.robot_obstacle_distances_hull(jmodel, T_, o)))(
            jnp.asarray(T), jobs)]
    obs = C.ObstacleSet(t(p0), t(p1), t(radius), kinds=kinds)
    before = cuda_gjk.gjk_hull_obstacles.launches
    got = [x.numpy() for x in C.robot_obstacle_distances_hull(
        model, t(T), obs)]
    assert cuda_gjk.gjk_hull_obstacles.launches == before   # plain on CPU
    assert all(np.isfinite(g).all() for g in got)
    diff = np.abs(got[3] - want[3])
    check_quantiles(diff)
    agree = diff < 1e-5
    assert agree.mean() > 0.95
    n_err = np.abs(got[2] - want[2]).max(-1)[agree]
    assert np.percentile(n_err, 99) < 1e-2
    for i in (0, 1):
        along = np.abs(np.sum((got[i] - want[i]) * want[2], -1))[agree]
        assert along.max() < 1e-4, (i, along.max())
    free = got[3] > 1e-3
    gap = np.linalg.norm(got[0] - got[1], axis=-1) - got[3]
    assert np.abs(gap[free]).max() < 1e-5
    if robot == "ur5":
        # the capsule polytopes are inner approximations: away from the
        # handoff a hull distance to a capsule obstacle exceeds the capsule
        # tier's by at most ~2 mm (the cylinder's flat caps are exact in the
        # hull tier only)
        d_cap = C.robot_obstacle_distances(model, t(T), obs)[3].numpy()
        cap = free[..., :2]
        dh, dc = got[3][..., :2][cap], d_cap[..., :2][cap]
        assert (dh >= dc - 1e-4).all()
        assert (dh - dc <= 2.5e-3).all()


def _tie_operands(robot, seed):
    """K4 operands on a robot's table with R = I and start directions that
    tie: horizontal ones on the two-joint robot (the prism's top and bottom
    rings tie on every pair, the boxes on a face normal four ways), ones
    perpendicular to each link's capsule axis on the UR5 (the equatorial
    rings of both ends tie)."""
    make = ROBOTS[robot][0]
    verts = hulls.hulls_for(make())
    ops = kernel_operands(verts, seed, unrotated=1)
    rng = np.random.default_rng(seed)
    L, M, _, B = ops["d0"].shape
    if robot == "two_joint":
        a = rng.uniform(-np.pi, np.pi, (L, M, B))
        a[..., ::3] = np.round(a[..., ::3] / (np.pi / 2)) * (np.pi / 2)
        d0 = np.stack([np.cos(a), np.sin(a), np.zeros_like(a)], axis=2)
    else:
        # each link is one capsule polytope, poles at rows 0 and 65, its
        # axis along a local coordinate axis: a direction with exactly no
        # component along it ties the two ends' equatorial rings
        axis = np.abs(verts[:, 65] - verts[:, 0]).argmax(-1)         # (L,)
        v = rng.normal(size=(L, M, B, 3))
        v[np.arange(L), ..., axis] = 0.0
        d0 = np.moveaxis(v, -1, 2)
    ops["d0"] = np.ascontiguousarray(d0, np.float32)
    return ops


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_plain_kernel_matches_jax_kernel_on_the_tables_ties(robot):
    """K4's plain version against JAX's K4 body run eagerly on the new
    tables, from start directions where the first supports tie (at least
    two maximisers on most pairs)."""
    ops = _tie_operands(robot, 21)
    dots = link_dots(ops, -ops["d0"])
    count = (dots == dots.max(axis=-1, keepdims=True)).sum(axis=-1)
    assert (count >= 2).mean() > 0.5, "the case does not reach its ties"
    got, want = plain_and_jax(ops)
    check_kernel_outputs(got, want)


@pytest.mark.parametrize("name", HULL_SCENES)
def test_hull_tier_tick_parity_with_jax(name):
    """Five ticks at B = 8 (the per-env semantics in both packages: every
    pair cold, 10 GJK iterations) from perturbed states."""
    jenv = jenvs.make(name)
    jenv.collision_geometry = "hull"
    states = perturbed_jax_states(jenv, 9)
    params = jenv.gather_params()
    jfinal, jaux = jax.jit(jenvs.make_batched_rollout(jenv, 5))(states,
                                                                params)
    env, state, tparams = port_inputs(name, states, params)
    env.collision_geometry = "hull"
    final, aux = envs.make_batched_rollout(env, 5)(state, tparams)
    assert final.gjk_warm is None
    assert not aux["solved"].any() and not np.asarray(jaux["solved"]).any()
    assert_tick_parity(aux, jaux, final, jfinal)
