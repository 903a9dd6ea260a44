"""The port's IK, URDF parser, scene objects, camera table and imperative
Simulation wrapper against the JAX package, on the CPU: the DLS IK of
tests/test_subsystems.py and franka/04's start pose, parse_urdf on the three
committed assets field by field, the objects' obstacle sets, and the
wrapper's reference loop of test_subsystems.py side by side."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu import envs as jenvs
from rmp_tpu import sim as jsim
from rmp_tpu import taskmaps as jtm
from rmp_tpu.core import RmpCore as JRmpCore
from rmp_tpu.envs import cameras as jcameras
from rmp_tpu.models import ik as jik
from rmp_tpu.models import robots as jrobots
from rmp_tpu.models import urdf as jurdf
from rmp_tpu.policies import v1 as jv1
from rmp_tpu_torch import envs, sim
from rmp_tpu_torch import taskmaps as tm
from rmp_tpu_torch.core import RmpCore
from rmp_tpu_torch.envs import cameras
from rmp_tpu_torch.models import ik, robots, urdf
from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.policies import v1

torch.set_num_threads(1)

ASSETS = os.path.join(os.path.dirname(__file__), os.pardir, "assets")
EE = robots.PANDA_EE_FRAME
IK_TOL = 1e-4        # start q against JAX's after 200 DLS iterations
# wrapper loop: q and q̇ after 200 steps against JAX's. A lone EE target
# gives the 9-joint arm a rank-3 metric, which 'cholesky' solves through its
# ridge: the packages' float32 roundings part by 2.2e-4 in the first q̈ of
# 0.14 already (CPU run), and by 2.0e-4 in q after the 200 steps.
SIM_Q_TOL = 2e-3


def test_inverse_kinematics_position_matches_jax():
    """tests/test_subsystems.py's position-only IK: the EE within 5 mm of
    the target, q inside the limits, and q within IK_TOL of JAX's."""
    model = robots.franka_panda()
    target = np.asarray([0.5, 0.1, 0.5], np.float32)
    q = ik.inverse_kinematics(model, EE, target,
                              q_init=robots.PANDA_Q_READY)
    T = K.fk_frame(model, q, model.frame_index(EE))
    np.testing.assert_allclose(T[:3, 3].numpy(), target, atol=5e-3)
    assert (q.numpy() >= model.q_lower - 1e-6).all()
    assert (q.numpy() <= model.q_upper + 1e-6).all()
    want = jik.inverse_kinematics(jrobots.franka_panda(), EE,
                                  jnp.asarray(target),
                                  q_init=jnp.asarray(jrobots.PANDA_Q_READY))
    np.testing.assert_allclose(q.numpy(), np.asarray(want), atol=IK_TOL)


def test_nullspace_scene_start_matches_jax():
    """franka/04's IK start (position and orientation, joint 5 clipped at
    its lower limit by the DLS loop) against JAX's within IK_TOL; the
    scene resets every env there."""
    env, jenv = (envs.make("franka/04_nullspace_control", device="cpu"),
                 jenvs.make("franka/04_nullspace_control"))
    got = envs.make_batched_reset(env, 3)().sim.q
    want = np.asarray(jenv.reset(jax.random.PRNGKey(0)).sim.q)
    np.testing.assert_allclose(got.numpy(), np.tile(want, (3, 1)),
                               atol=IK_TOL, rtol=0)
    assert got[0, 4] == env.model.q_lower[4]


@pytest.mark.parametrize("asset", ["franka_panda.urdf", "two_joint_robot.urdf",
                                   "ur5.urdf"])
def test_parse_urdf_matches_jax(asset):
    """Every field of the parsed model, the collision primitives included,
    equal to the JAX package's parse of the same file."""
    path = os.path.join(ASSETS, asset)
    got, want = urdf.parse_urdf(path), jurdf.parse_urdf(path)
    for f in ("name", "frame_names", "link_names", "parent", "joint_type",
              "q_index", "motor_names", "has_collision"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("T_constant", "axis", "mass", "com", "inertia", "q_lower",
              "q_upper", "velocity_limit", "effort_limit", "joint_damping",
              "joint_friction"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert ([[dataclass_tuple(p) for p in prims] for prims in got.collision]
            == [[dataclass_tuple(p) for p in prims]
                for prims in want.collision])


def dataclass_tuple(prim):
    return (prim.kind, tuple(map(float, prim.p0)), tuple(map(float, prim.p1)),
            float(prim.radius))


def test_with_collision_primitives_matches_jax():
    path = os.path.join(ASSETS, "two_joint_robot.urdf")
    got, want = urdf.parse_urdf(path), jurdf.parse_urdf(path)
    frame = got.frame_names[1]
    got = urdf.with_collision_primitives(got, {frame: (
        urdf.CollisionPrimitive("sphere", (0, 0, 0), (0, 0, 0), 0.1),)})
    want = jurdf.with_collision_primitives(want, {frame: (
        jurdf.CollisionPrimitive("sphere", (0, 0, 0), (0, 0, 0), 0.1),)})
    assert got.has_collision == want.has_collision
    assert ([[dataclass_tuple(p) for p in prims] for prims in got.collision]
            == [[dataclass_tuple(p) for p in prims]
                for prims in want.collision])


def test_scene_objects_match_jax():
    """Sphere, Goal and Cylinder (euler and quaternion orientations) as
    obstacle sets, and scene_to_obstacles, equal to JAX's."""
    quat = [0.0, 0.2588190451, 0.0, 0.9659258263]
    objs = lambda pkg: [pkg.Sphere(base_position=(0.3, 0.1, 0.4), radius=0.05),
                        pkg.Goal(base_position=(0.5, 0.0, 0.3)),
                        pkg.Cylinder(base_position=(0.2, -0.3, 0.5),
                                     base_orientation=(0.3, 0.0, 0.1),
                                     radius=0.03, height=0.2),
                        pkg.Cylinder(base_position=(0.4, 0.3, 0.2),
                                     base_orientation=quat)]
    got = sim.scene_to_obstacles(objs(sim), device="cpu")
    want = jsim.world.scene_to_obstacles(objs(jsim))
    for name in ("p0", "p1", "radius"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-6, err_msg=name)
    assert got.kinds == want.kinds
    assert sim.scene_to_obstacles([sim.Goal()]) is None
    robot = sim.FrankaPanda()
    assert robot.model is robots.franka_panda()
    np.testing.assert_array_equal(robot.q, jsim.FrankaPanda().q)
    assert sim.TwoJointRobot().model.n_q == 2


def test_cameras_equal_jax():
    for name in list(jenvs.REGISTRY) + ["unknown/scene"]:
        assert cameras.camera_for(name) == jcameras.camera_for(name)
        assert (cameras.eye_target(cameras.camera_for(name), 30.0)
                == jcameras.eye_target(jcameras.camera_for(name), 30.0))


def _reference_loop(pkg_sim, pkg_tm, pkg_v1, core, model, steps=200):
    """tests/test_subsystems.py's wrapper loop: a v1 EE target, 'cholesky',
    a new q̈ every 10 steps."""
    s = (pkg_sim.Simulation(delta_t=0.01, device="cpu") if pkg_sim is sim
         else pkg_sim.Simulation(delta_t=0.01)).connect()
    robot = pkg_sim.FrankaPanda()
    s.populate_scene([robot, pkg_sim.Goal(base_position=(0.6, 0.0, 0.4),
                                          radius=0.02),
                      pkg_sim.Sphere(base_position=(1.5, 1.5, 1.5),
                                     radius=0.05)])
    core.add_rmp(pkg_v1.target_policy(
        goal=[0.6, 0.0, 0.4],
        taskmap=pkg_tm.chain(pkg_tm.fk_frame(model, EE), pkg_tm.to_position()),
        alpha=0.1, beta=0.5, c=0.1, name="target"))
    qdd = None
    for i in range(steps):
        if i % 10 == 0:
            q, qd, ctx = s.state()
            qdd = np.asarray(core.evaluate(q, qd, context=ctx))
        s.step(qdd)
    return s


def test_simulation_wrapper_reference_loop_matches_jax():
    """The loop with a far sphere in the scene (its distance context reaches
    RmpCore.evaluate through `context` and no policy reads it): the EE ends
    nearer the goal than it started, and q after 200 steps lies within
    SIM_Q_TOL of the JAX wrapper's."""
    model = robots.franka_panda()
    s = _reference_loop(sim, tm, v1, RmpCore(method="cholesky", device="cpu"),
                        model)
    ee = model.frame_index(EE)
    goal = np.asarray([0.6, 0.0, 0.4])
    d_end = np.linalg.norm(
        K.fk_frame(model, torch.tensor(s.q), ee)[:3, 3].numpy() - goal)
    d_start = np.linalg.norm(
        K.fk_frame(model, torch.tensor(robots.PANDA_Q_READY),
                   ee)[:3, 3].numpy() - goal)
    assert d_end < d_start
    assert s.t == pytest.approx(2.0) and s.n_obstacles == 1
    q, qd, ctx = s.state()
    assert q.shape == qd.shape == (9,)
    assert ctx["panda_hand_joint"]["distance"].shape == (1,)
    js = _reference_loop(jsim, jtm, jv1, JRmpCore(method="cholesky"),
                         jrobots.franka_panda())
    np.testing.assert_allclose(s.q, js.q, atol=SIM_Q_TOL, rtol=0)
    np.testing.assert_allclose(s.qd, js.qd, atol=SIM_Q_TOL, rtol=0)
    s.reset()
    np.testing.assert_array_equal(s.q, robots.PANDA_Q_READY)
    s.q = np.zeros(9)
    assert not s.q.any()
    s.disconnect()
    assert s.robot is None and s.n_obstacles == 0


def test_simulation_animation_capture_raises(tmp_path, monkeypatch):
    """Animation capture, which raised NotImplementedError until the
    renderers were ported, now captures a frame every 1/16 s of simulated
    time with the native ray tracer (where a C++ compiler is there) or
    matplotlib, and save_animation writes them as a GIF."""
    from PIL import Image

    from rmp_tpu_torch.utils import native
    for renderer in ("native", "matplotlib"):
        if renderer == "matplotlib":
            monkeypatch.setattr(native, "available", lambda: False)
        path = str(tmp_path / f"{renderer}.gif")
        s = sim.Simulation(animation_save_path=path, device="cpu")
        s.populate_scene([sim.FrankaPanda(), sim.Goal([0.6, 0.0, 0.4])])
        for _ in range(20):             # 0.2 s: frames at 0.07, 0.14 s
            s.step(np.zeros(9))
        s.save_animation()
        assert s.renderer == renderer
        assert Image.open(path).n_frames == 2


def test_simulation_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.Simulation()
