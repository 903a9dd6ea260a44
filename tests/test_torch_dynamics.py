"""The port's rigid-body dynamics, torque path and robot models against the
JAX package on the same seeded numpy inputs: RNEA, bias forces, the
ID-trick and CRBA mass matrices, forward dynamics, the velocity clamp of the
integrator, one torque-mode physics step, the two-joint and UR5 models field
by field, and PyBullet's collision-shape inertia."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu.models import hulls as jhulls
from rmp_tpu.models import robots as jrobots
from rmp_tpu.models import urdf as jurdf
from rmp_tpu.sim import dynamics as jdyn
from rmp_tpu.sim import world as jworld
from rmp_tpu_torch.models import robots, urdf
from rmp_tpu_torch.sim import dynamics, world

torch.set_num_threads(1)

B = 16
REL = 1e-4           # |Δ| <= REL * max(1, |value|)
ROBOTS = {"two_joint": (robots.two_joint_robot, jrobots.two_joint_robot),
          "panda": (robots.franka_panda, jrobots.franka_panda),
          "ur5": (robots.ur5, jrobots.ur5)}


def assert_close_scaled(got, want, what=""):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_allclose(got.numpy(), want, rtol=0, err_msg=what,
                               atol=REL * max(1.0, float(np.abs(want).max())))


def states(n, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-a, a, (B, n)).astype(np.float32)
                 for a in (1.2, 1.0, 2.0, 20.0))


@pytest.mark.parametrize("name", ROBOTS)
def test_dynamics_match_jax(name):
    model, jmodel = (f() for f in ROBOTS[name])
    q, qd, qdd, tau = states(model.n_q, 0)
    g = np.asarray([0.0, -9.81, 1.0], np.float32)     # a tilted gravity too
    jit = jax.jit(jax.vmap(lambda a, b, c, t: dict(
        id=jdyn.inverse_dynamics(jmodel, a, b, c),
        id_g=jdyn.inverse_dynamics(jmodel, a, b, c, gravity=jnp.asarray(g)),
        bias=jdyn.bias_forces(jmodel, a, b),
        mass=jdyn.mass_matrix(jmodel, a),
        crba=jdyn.mass_matrix_crba(jmodel, a),
        fd=jdyn.forward_dynamics(jmodel, a, b, t))))
    want = jit(*(jnp.asarray(x) for x in (q, qd, qdd, tau)))
    q, qd, qdd, tau = (torch.tensor(x) for x in (q, qd, qdd, tau))
    got = dict(id=dynamics.inverse_dynamics(model, q, qd, qdd),
               id_g=dynamics.inverse_dynamics(model, q, qd, qdd, gravity=g),
               bias=dynamics.bias_forces(model, q, qd),
               mass=dynamics.mass_matrix(model, q),
               crba=dynamics.mass_matrix_crba(model, q),
               fd=dynamics.forward_dynamics(model, q, qd, tau))
    for key, w in want.items():
        assert_close_scaled(got[key], w, key)
    assert_close_scaled(got["crba"], got["mass"], "CRBA vs the ID trick")


def test_dynamics_take_any_leading_axes():
    model = robots.ur5()
    q, qd, qdd, _ = (torch.tensor(x) for x in states(6, 1))
    flat = dynamics.inverse_dynamics(model, q, qd, qdd)
    shaped = dynamics.inverse_dynamics(*(x.reshape(4, 4, 6) if i else x
                                         for i, x in enumerate((model, q, qd,
                                                                qdd))))
    torch.testing.assert_close(shaped.reshape(B, 6), flat)
    one = dynamics.mass_matrix(model, q[0])
    torch.testing.assert_close(one, dynamics.mass_matrix(model, q)[0])


@pytest.mark.parametrize("enforce", [False, True])
def test_velocity_clamp_matches_jax(enforce):
    """q̇ past the UR5's URDF limits (3.15 and 3.2 rad/s), and past its
    position limits, integrated once."""
    model, jmodel = robots.ur5(), jrobots.ur5()
    rng = np.random.default_rng(2)
    q = rng.uniform(-3.5, 3.5, (B, 6)).astype(np.float32)
    qd = rng.uniform(-6.0, 6.0, (B, 6)).astype(np.float32)
    qdd = rng.uniform(-50.0, 50.0, (B, 6)).astype(np.float32)
    want = jax.vmap(lambda a, b, c: jdyn.semi_implicit_euler_step(
        jmodel, a, b, c, 0.01, enforce_velocity_limits=enforce))(q, qd, qdd)
    got = dynamics.semi_implicit_euler_step(
        model, torch.tensor(q), torch.tensor(qd), torch.tensor(qdd), 0.01,
        enforce_velocity_limits=enforce)
    for g, w, what in zip(got, want, ("q", "qd")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   err_msg=what)
    vmax = model.velocity_limit
    clamped = (np.abs(got[1].numpy()) <= vmax + 1e-6).all()
    assert clamped == enforce


def test_torque_physics_step_matches_jax():
    """One torque-mode step of the UR5 (joint damping 0.1) with commands
    large enough that the effort limits (150 and 28 N m) clip some torques,
    the velocity clamp on."""
    model, jmodel = robots.ur5(), jrobots.ur5()
    q, qd, qdd, _ = states(6, 3)
    qdd = 50.0 * qdd
    jstate = jworld.SimState(q=jnp.asarray(q), qd=jnp.asarray(qd),
                             t=jnp.zeros(B))
    want = jax.jit(jax.vmap(lambda s, a: jworld.physics_step(
        jmodel, s, a, 0.01, torque_mode=True,
        enforce_velocity_limits=True)))(jstate, jnp.asarray(qdd))
    tau = dynamics.inverse_dynamics(model, torch.tensor(q), torch.tensor(qd),
                                    torch.tensor(qdd))
    assert (tau.abs() > torch.tensor(model.effort_limit)).any()
    state = world.SimState(q=torch.tensor(q), qd=torch.tensor(qd),
                           t=torch.zeros(B))
    got = world.physics_step(model, state, torch.tensor(qdd), 0.01,
                             torque_mode=True, enforce_velocity_limits=True)
    assert_close_scaled(got.qd, want.qd, "qd")
    assert_close_scaled(got.q, want.q, "q")
    exact = world.physics_step(model, state, torch.tensor(qdd), 0.01)
    assert float((exact.qd - got.qd).abs().max()) > 1e-2


def _assert_model_equal(got, want):
    for field in dataclasses.fields(want):
        g, w = getattr(got, field.name), getattr(want, field.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, field.name
            assert np.array_equal(g, w), field.name
        elif field.name == "collision":
            assert [[dataclasses.astuple(p) for p in frame] for frame in g] \
                == [[dataclasses.astuple(p) for p in frame] for frame in w]
        else:
            assert g == w, field.name


@pytest.mark.parametrize("name,frames,motors,links", [
    ("two_joint", 3, 2, 3), ("ur5", 7, 6, 6)])
def test_robot_model_equals_jax_field_by_field(name, frames, motors, links):
    got, want = (f() for f in ROBOTS[name])
    _assert_model_equal(got, want)
    assert (got.n_frames, got.n_q, len(got.collision_frames)) == (
        frames, motors, links)
    for k in range(want.n_frames):
        assert got.chain(k) == want.chain(k)


def test_robot_constants_equal_jax():
    for name in ("TWO_JOINT_Q_READY", "TWO_JOINT_Q_LIM_LOW",
                 "TWO_JOINT_Q_LIM_HIGH", "UR5_Q_READY"):
        g, w = getattr(robots, name), getattr(jrobots, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert robots.TWO_JOINT_EE_FRAME == jrobots.TWO_JOINT_EE_FRAME
    assert robots.UR5_EE_FRAME == jrobots.UR5_EE_FRAME


def test_pybullet_collision_inertia_matches_jax():
    """The Panda from its hull asset, field by field; the UR5 from its
    synthetic hulls (ported since the tenth slice) and when handed the JAX
    package's; a robot without a hull table raises."""
    _assert_model_equal(urdf.pybullet_collision_inertia(robots.franka_panda()),
                        jurdf.pybullet_collision_inertia(
                            jrobots.franka_panda()))
    _assert_model_equal(urdf.pybullet_collision_inertia(robots.ur5()),
                        jurdf.pybullet_collision_inertia(jrobots.ur5()))
    unknown = dataclasses.replace(robots.ur5(), name="UR5-unknown")
    with pytest.raises(ValueError, match="no hull asset"):
        urdf.pybullet_collision_inertia(unknown)
    verts = np.asarray(jhulls.hulls_for(jrobots.ur5()))
    _assert_model_equal(
        urdf.pybullet_collision_inertia(robots.ur5(), hull_verts=verts),
        jurdf.pybullet_collision_inertia(jrobots.ur5()))
