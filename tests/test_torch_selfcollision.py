"""The port's self-collision queries against the JAX package: the pair lists
of self_collision_pairs (the whole list and franka/03's exclude_below = 0.12
list, equal), robot_self_distances and link_world_capsules on perturbed
Panda poses, sphere obstacles, and franka/03's per-frame context_fn."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu import envs as jenvs
from rmp_tpu.models import kinematics as jK
from rmp_tpu.models import robots as jrobots
from rmp_tpu.sim import collision as jcollision
from rmp_tpu_torch import envs
from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.sim import collision

torch.set_num_threads(1)

ATOL = 2e-6          # positions and distances of an O(1) m arm, float32
B = 8


def poses(seed: int, span: float = 0.4) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (robots.PANDA_Q_READY
            + rng.uniform(-span, span, (B, 9))).astype(np.float32)


@pytest.mark.parametrize("exclude_below", [None, 0.12])
def test_self_collision_pairs_equal_jax(exclude_below):
    """The pair list (3 apart in the tree) and franka/03's list, pairs
    closer than 12 cm at the ready pose dropped: 24 and 20 pairs, equal to
    JAX's, in the same order."""
    kw = dict(n_neighbors=3, exclude_below=exclude_below,
              q_ref=robots.PANDA_Q_READY)
    got = collision.self_collision_pairs(robots.franka_panda(), **kw)
    want = jcollision.self_collision_pairs(jrobots.franka_panda(), **kw)
    assert got == tuple(tuple(int(i) for i in p) for p in want)
    assert len(got) == (24 if exclude_below is None else 20)


def test_robot_self_distances_match_jax():
    """All 24 pairs at 8 poses moved by q ± 0.4 from the ready pose: the
    min over each pair's primitive cross product, env by env."""
    model, jmodel = robots.franka_panda(), jrobots.franka_panda()
    pairs = collision.self_collision_pairs(model)
    q = poses(1)
    got = collision.robot_self_distances(model, K.fk_all(model,
                                                         torch.tensor(q)),
                                         pairs)
    want = jax.vmap(lambda qq: jcollision.robot_self_distances(
        jmodel, jK.fk_all(jmodel, qq), pairs))(jnp.asarray(q))
    for what, g, w in zip(("pos_on_a", "pos_on_b", "normal", "distance"),
                          got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0, err_msg=what)


def test_link_world_capsules_match_jax():
    model, jmodel = robots.franka_panda(), jrobots.franka_panda()
    q = poses(2)
    got = collision.link_world_capsules(model,
                                        K.fk_all(model, torch.tensor(q)))
    want = jax.vmap(lambda qq: jcollision.link_world_capsules(
        jmodel, jK.fk_all(jmodel, qq)))(jnp.asarray(q))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2])[0])


def test_sphere_obstacle_matches_jax():
    got = collision.sphere_obstacle([0.4, -0.1, 0.3], 0.05)
    want = jcollision.sphere_obstacle([0.4, -0.1, 0.3], 0.05)
    for name in ("p0", "p1", "radius"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert got.kinds is None and want.kinds is None


def test_self_avoidance_context_matches_jax():
    """franka/03's context_fn on 8 perturbed poses, given the tick's world
    transforms: every per-frame field equal to JAX's (which runs per env),
    the frames and their row counts too."""
    name = "franka/03_self_avoidance"
    env, jenv = envs.make(name, device="cpu"), jenvs.make(name)
    q = poses(3, 0.3)
    states = envs.make_batched_reset(env, B)()
    sim = states.sim
    sim.q = torch.tensor(q)
    got = env.context_fn(env.model, sim, K.fk_all(env.model, sim.q))
    jstates = jenvs.make_batched_reset(jenv, B)(jax.random.PRNGKey(0))
    jsim = jstates.sim
    jsim.q = jnp.asarray(q)
    want = jax.vmap(lambda s: jenv.context_fn(jenv.model, s, None))(jsim)
    assert sorted(got) == sorted(want)
    assert len(got) == 5
    keyed = [p.ctx_key for p in env.policies if p.ctx_key]
    assert sorted(keyed) == sorted(got)
    for frame, fields in got.items():
        assert sorted(fields) == sorted(want[frame])
        for field, value in fields.items():
            np.testing.assert_allclose(value.numpy(),
                                       np.asarray(want[frame][field]),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"{frame} {field}")
