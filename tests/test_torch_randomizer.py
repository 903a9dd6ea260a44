"""The port's scene randomizer and obstacle padding against the JAX
package's. jax.random streams are not reproduced in torch, so each
sampler's deterministic core is fed the JAX package's own draws (the unit
uniforms behind jax.random.uniform's scaling); the port's own draws are
held to the samplers' contracts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu.envs import franka as jfranka
from rmp_tpu.sim import collision as jcollision
from rmp_tpu.sim import randomizer as jrnd
from rmp_tpu_torch.envs import franka
from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.sim import collision, randomizer as rnd

torch.set_num_threads(1)

B = 32
ATOL = 2e-6      # float32 sin/cos/matmul of the two packages


def _obstacles(jobs) -> collision.ObstacleSet:
    return collision.ObstacleSet(
        *(torch.tensor(np.asarray(x)) for x in (jobs.p0, jobs.p1,
                                                 jobs.radius)),
        kinds=jobs.kinds)


def _assert_obstacles_close(obs, jobs, atol=ATOL):
    for name in ("p0", "p1", "radius"):
        np.testing.assert_allclose(getattr(obs, name).numpy(),
                                   np.asarray(getattr(jobs, name)),
                                   atol=atol)
    assert obs.kinds == jobs.kinds


def _jax_obstacles(seed: int, n: int, batch: int = B):
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    return jax.vmap(lambda k: jrnd.randomize_obstacles(k, n))(keys), keys


@pytest.mark.parametrize("n, capacity", [(7, 8), (3, 8), (8, 8), (9, 16)])
def test_pad_obstacles_and_buckets_match_jax(n, capacity):
    """bucket_capacity picks the JAX package's bucket; pad_obstacles on
    batched (B, K, ...) leaves gives the JAX package's per-env padding
    (vmapped), pad rows and kinds included; a shared (K, ...) set too."""
    assert franka.bucket_capacity(n) == jfranka.bucket_capacity(n) == capacity
    jobs, _ = _jax_obstacles(0, n)
    want = jax.vmap(lambda o: jcollision.pad_obstacles(o, capacity))(jobs)
    got = collision.pad_obstacles(_obstacles(jobs), capacity)
    _assert_obstacles_close(got, want, atol=0)
    one = collision.pad_obstacles(
        collision.ObstacleSet(*(x[0] for x in (got.p0, got.p1, got.radius)),
                              kinds=got.kinds), capacity)
    np.testing.assert_array_equal(one.p0.numpy(), got.p0[0].numpy())
    mixed = collision.ObstacleSet(got.p0[:, :2], got.p1[:, :2],
                                  got.radius[:, :2],
                                  kinds=("capsule", "cylinder"))
    assert collision.pad_obstacles(mixed, 4).kinds == (
        "capsule", "cylinder", "capsule", "capsule")
    with pytest.raises(ValueError, match="capacity"):
        collision.pad_obstacles(got, capacity - 1)


def test_obstacle_uniforms_map_matches_jax():
    """randomize_obstacles' uniforms -> segments map, fed the unit uniforms
    of JAX's four draws, gives JAX's cylinders env by env."""
    n = 7
    jobs, keys = _jax_obstacles(1, n)

    def draws(key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        return (jax.random.uniform(k1, (n, 3)), jax.random.uniform(k2, (n, 3)),
                jax.random.uniform(k3, (n,)), jax.random.uniform(k4, (n,)))
    u = [torch.tensor(np.asarray(x)) for x in jax.vmap(draws)(keys)]
    _assert_obstacles_close(rnd.obstacles_from_uniforms(*u), jobs)


def test_robot_config_map_matches_jax():
    """randomize_robot_config's map, fed JAX's unit uniforms."""
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    jq, jqd = jax.vmap(jrnd.randomize_robot_config)(keys)
    space = rnd.RobotSampleSpace.panda_default()

    def draws(key):
        kq, kqd = jax.random.split(key)
        return jax.random.uniform(kq, (9,)), jax.random.uniform(kqd, (9,))
    uq, uqd = (torch.tensor(np.asarray(x)) for x in jax.vmap(draws)(keys))
    # one float32 ulp at |q| < 4: XLA may fuse the scale's multiply-add
    np.testing.assert_allclose(
        rnd.scale_uniform(uq, space.q_low, space.q_high).numpy(),
        np.asarray(jq), rtol=0, atol=2.4e-7)
    np.testing.assert_allclose(
        rnd.scale_uniform(uqd, space.qd_low, space.qd_high).numpy(),
        np.asarray(jqd), rtol=0, atol=1e-9)


def test_goal_rejection_core_matches_jax():
    """pick_clear_candidate fed JAX's 8 candidates per env (from
    randomize_goal's own draw) picks JAX's goal: the first candidate with
    5 cm clearance. Then every candidate blocked (a 5 m obstacle around
    them): both fall back to the clearest candidate."""
    jobs, _ = _jax_obstacles(3, 7)
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    jgoal = jax.vmap(lambda k, o: jrnd.randomize_goal(k, obstacles=o))(
        keys, jobs)
    u = jax.vmap(lambda k: jax.random.uniform(k, (8, 3)))(keys)
    cand = rnd._cylindrical_to_cartesian(rnd.scale_uniform(
        torch.tensor(np.asarray(u)), rnd.GOAL_CYL_LOW, rnd.GOAL_CYL_HIGH))
    got = rnd.pick_clear_candidate(cand, _obstacles(jobs), 0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgoal), atol=ATOL)

    p0 = np.zeros((B, 1, 3), np.float32)
    p1 = np.tile(np.float32([0.0, 0.0, 0.1]), (B, 1, 1))
    radius = np.full((B, 1), 5.0, np.float32)
    wall = collision.ObstacleSet(*(torch.tensor(x) for x in (p0, p1, radius)))
    jwall = jcollision.ObstacleSet(*(jnp.asarray(x) for x in (p0, p1,
                                                              radius)))
    want = jax.vmap(lambda c, o: jrnd._pick_clear_candidate(c, o, 0.05))(
        jnp.asarray(cand.numpy()), jwall)
    got = rnd.pick_clear_candidate(cand, wall, 0.05)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    c = cand.numpy()
    above = np.maximum(c[..., 2] - 0.1, 0.0)     # the segment runs z 0..0.1
    clear = np.hypot(np.linalg.norm(c[..., :2], axis=-1), above) - 5.0
    assert (clear < 0.05).all()
    np.testing.assert_array_equal(got.numpy(),
                                  c[np.arange(B), clear.argmax(1)])


def test_port_goals_keep_their_clearance():
    """On the port's own draws every goal is at least 5 cm clear of its
    env's seven random cylinders, and in the cylindrical sampling space;
    the same seed gives the same goals, another seed others."""
    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        obs = rnd.randomize_obstacles(gen, 256, 7)
        return obs, rnd.randomize_goal(gen, 256, obstacles=obs)
    obs, goal = draw(5)
    _, _, _, d = collision.capsule_capsule_query(
        goal[:, None], goal[:, None], torch.zeros(1), obs.p0, obs.p1,
        obs.radius)
    assert float(d.amin(dim=1).min()) >= 0.05
    r = torch.linalg.vector_norm(goal[:, :2], dim=-1)
    assert float(r.min()) >= 0.4 - 1e-6 and float(r.max()) <= 0.9 + 1e-6
    assert float(goal[:, 2].min()) >= 0.0 and float(goal[:, 2].max()) <= 1.0
    assert torch.equal(draw(5)[1], goal)
    assert not torch.equal(draw(6)[1], goal)


def test_box_samplers_stay_in_their_ranges():
    """randomize_goal_box draws in its box (and clear of obstacles);
    randomize_obstacles_box's centers lie in the box, radii in range,
    lengths the given height, and with `avoid` every obstacle keeps the
    clearance from the avoided capsules (those the seed's draw meets)."""
    gen = torch.Generator().manual_seed(7)
    low, high = [0.2, -0.5, 0.1], [0.7, 0.5, 0.8]
    goal = rnd.randomize_goal_box(gen, 64, low, high)
    assert ((goal >= torch.tensor(low)) & (goal < torch.tensor(high))).all()
    model = robots.franka_panda()
    q = torch.as_tensor(robots.PANDA_Q_READY, dtype=torch.float32)[None]
    p0, p1, radius, _ = collision.link_world_capsules_all(
        model, K.fk_all(model, q.expand(64, -1)))
    for avoid in (None, (p0, p1, radius)):
        obs = rnd.randomize_obstacles_box(gen, 64, 5, low, high,
                                          avoid=avoid)
        center = (obs.p0 + obs.p1) / 2
        assert ((center >= torch.tensor(low) - 1e-6)
                & (center <= torch.tensor(high) + 1e-6)).all()
        assert ((obs.radius >= 0.04) & (obs.radius <= 0.08)).all()
        length = torch.linalg.vector_norm(obs.p1 - obs.p0, dim=-1)
        np.testing.assert_allclose(length.numpy(), 0.5, atol=1e-6)
        assert obs.kinds == ("cylinder",) * 5
        if avoid is not None:
            _, _, _, d = collision.capsule_capsule_query(
                obs.p0[:, :, None], obs.p1[:, :, None],
                obs.radius[:, :, None], p0[:, None], p1[:, None], radius)
            assert float(d.amin(dim=-1).min()) >= 0.03
    goal = rnd.randomize_goal_box(gen, 64, low, high, obstacles=obs)
    _, _, _, d = collision.capsule_capsule_query(
        goal[:, None], goal[:, None], torch.zeros(1), obs.p0, obs.p1,
        obs.radius)
    assert float(d.amin(dim=1).min()) >= 0.05
