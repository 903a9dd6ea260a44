"""The port's RmpCore and `resolve` against the JAX package, and the three
committed goldens of tests/test_golden.py that run through RmpCore
(franka01, two_joint01, franka01_torque), reproduced by the port on the CPU
with that file's loops and tolerances."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu import core as jcore
from rmp_tpu import taskmaps as jtm
from rmp_tpu.models import robots as jrobots
from rmp_tpu.policies import v1 as jv1
from rmp_tpu.sim import data as jdata
from rmp_tpu.sim.collision import cylinder_obstacle as jcylinder
from rmp_tpu.models import kinematics as jK
from rmp_tpu_torch import core
from rmp_tpu_torch import taskmaps as tm
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.models.urdf import pybullet_collision_inertia
from rmp_tpu_torch.policies import v1
from rmp_tpu_torch.sim import dynamics

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
REL = 1e-4           # |Δq̈| <= REL * max(1, |q̈|)


def assert_close_scaled(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, err_msg=what,
                               atol=REL * max(1.0, float(np.abs(want).max())))


def test_pinv_takes_the_jax_cutoff():
    """A symmetric 9x9 A with singular values (1, 0.5, 0.2, 3e-6, 0, ...):
    3e-6 lies between torch's default cutoff (9 eps = 1.1e-6) and JAX's
    (90 eps = 1.1e-5), so the two defaults part by orders of magnitude and
    core.resolve must follow jnp.linalg.pinv."""
    rng = np.random.default_rng(0)
    U, _ = np.linalg.qr(rng.normal(size=(9, 9)))
    s = np.array([1.0, 0.5, 0.2, 3e-6] + [0.0] * 5)
    A = ((U * s) @ U.T).astype(np.float32)
    f = rng.normal(size=9).astype(np.float32)
    want = np.asarray(jnp.linalg.pinv(jnp.asarray(A)) @ jnp.asarray(f))
    got = core.resolve(torch.tensor(A)[None], torch.tensor(f)[None],
                       "pinv")[0].numpy()
    assert_close_scaled(got, want, "q̈")
    torch_default = (torch.linalg.pinv(torch.tensor(A))
                     @ torch.tensor(f)).numpy()
    assert np.abs(torch_default).max() > 100 * np.abs(want).max()


def _two_joint_policies(pkg, model, obstacle_ctx: bool):
    tmap, pol = (tm, v1) if pkg == "torch" else (jtm, jv1)
    ee = tmap.chain(tmap.fk_frame(model, "link_23"), tmap.to_position())
    out = [pol.target_policy(goal=[1.4, -1.4, 0.1], taskmap=ee, alpha=0.1,
                             beta=0.5, c=0.1, name="target"),
           pol.configuration_space_biasing(q0=[np.pi / 2, 0.0], gamma_p=0.01,
                                           gamma_d=0.1, name="bias")]
    if obstacle_ctx:
        out.append(pol.collision_avoidance(
            taskmap=tmap.chain(tmap.multi_fk_frames(model,
                                                    model.collision_frames),
                               tmap.frames_relative_points()),
            eta_rep=0.1 * np.e, nu_rep=0.3, eta_damp=1.0, nu_damp=0.3, r=1.1,
            c=1e5, name="collision_avoidance"))
    return out


@pytest.mark.parametrize("method", ["pinv", "solve"])
def test_rmpcore_evaluate_matches_jax(method):
    """RmpCore.evaluate on single states of the two-joint robot: target, c-
    space bias and the grouped collision policy, whose per-tick context
    (the JAX package's distance context of one cylinder, unbatched) goes in
    through `context`."""
    rng = np.random.default_rng(1)
    jmodel, model = jrobots.two_joint_robot(), robots.two_joint_robot()
    jc = jcore.RmpCore(method=method)
    tc = core.RmpCore(method=method, device="cpu")
    for p in _two_joint_policies("jax", jmodel, True):
        jc.add_rmp(p)
    for p in _two_joint_policies("torch", model, True):
        tc.add_rmp(p)
    obstacle = jcylinder([1.6, -0.8, 0.0], [0.0, 0.0, 0.0], radius=0.1,
                         height=0.8)
    for _ in range(4):
        q = rng.uniform(-2.0, 2.0, 2).astype(np.float32)
        qd = rng.uniform(-0.5, 0.5, 2).astype(np.float32)
        ctx = jdata.distance_context(jmodel, jK.fk_all(jmodel, q),
                                     obstacle)[jdata.PAIRS_KEY]
        context = {"collision_avoidance": ctx}
        want = np.asarray(jc.evaluate(q, qd, context))
        got = tc.evaluate(q, qd, {"collision_avoidance": {
            k: np.array(v) for k, v in ctx.items()}})
        assert got.shape == (2,) and got.device == torch.device("cpu")
        assert_close_scaled(got.numpy(), want, f"q̈ at q={q}")


def test_rmpcore_registry_surface():
    tc = core.RmpCore(device="cpu")
    assert str(tc) == "no RMPs in use.\n"
    model = robots.two_joint_robot()
    for p in _two_joint_policies("torch", model, False):
        tc.add_rmp(p)
    assert [p.name for p in tc.policies] == ["target", "bias"]
    assert "target" in str(tc) and "bias" in str(tc)
    tc.remove_rmp_by_name("bias")
    assert [p.name for p in tc.policies] == ["target"]
    params = tc.gather_params()
    assert params[0]["goal"].device == torch.device("cpu")
    qdd = tc.make_evaluate()(torch.zeros(3, 2), torch.zeros(3, 2), params,
                             (None,))
    assert qdd.shape == (3, 2)
    assert core.RmpCore(derivatives="jacfwd", device="cpu").derivatives \
        == "jacfwd"
    with pytest.raises(ValueError, match="derivatives"):
        core.RmpCore(derivatives="finite_differences", device="cpu")


@pytest.mark.parametrize("method", ["pinv", "solve"])
def test_rmpcore_jacfwd_matches_jax(method):
    """RmpCore(derivatives='jacfwd') on the two-joint stack of
    test_rmpcore_evaluate_matches_jax, with its obstacle context, against
    the JAX package's RmpCore(derivatives='jacfwd'), and against the port's
    own 'analytic' core."""
    rng = np.random.default_rng(2)
    jmodel, model = jrobots.two_joint_robot(), robots.two_joint_robot()
    jc = jcore.RmpCore(method=method, derivatives="jacfwd")
    tc = core.RmpCore(method=method, derivatives="jacfwd", device="cpu")
    ta = core.RmpCore(method=method, device="cpu")
    for p in _two_joint_policies("jax", jmodel, True):
        jc.add_rmp(p)
    for p in _two_joint_policies("torch", model, True):
        tc.add_rmp(p)
        ta.add_rmp(p)
    obstacle = jcylinder([1.6, -0.8, 0.0], [0.0, 0.0, 0.0], radius=0.1,
                         height=0.8)
    for _ in range(4):
        q = rng.uniform(-2.0, 2.0, 2).astype(np.float32)
        qd = rng.uniform(-0.5, 0.5, 2).astype(np.float32)
        ctx = jdata.distance_context(jmodel, jK.fk_all(jmodel, q),
                                     obstacle)[jdata.PAIRS_KEY]
        want = np.asarray(jc.evaluate(q, qd, {"collision_avoidance": ctx}))
        tctx = {"collision_avoidance": {k: np.array(v)
                                        for k, v in ctx.items()}}
        got = tc.evaluate(q, qd, tctx)
        assert_close_scaled(got.numpy(), want, f"jacfwd q̈ at q={q}")
        assert_close_scaled(got.numpy(), ta.evaluate(q, qd, tctx).numpy(),
                            f"jacfwd against analytic at q={q}")


def test_rmpcore_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        core.RmpCore()


def _target_core(model, ee, goal):
    c = core.RmpCore(method="pinv", device="cpu")
    c.add_rmp(v1.target_policy(
        goal=goal, taskmap=tm.chain(tm.fk_frame(model, ee), tm.to_position()),
        alpha=0.1, beta=0.5, c=0.1, name="target"))
    return c


def _euler(model, q, qd, qdd):
    q, qd = dynamics.semi_implicit_euler_step(
        model, torch.tensor(q), torch.tensor(qd), torch.as_tensor(qdd), 0.01)
    return q.numpy(), qd.numpy()


def test_franka01_golden_trajectory():
    data = np.load(os.path.join(GOLDEN, "franka01_trajectory.npz"))
    model = robots.franka_panda()
    c = _target_core(model, robots.PANDA_EE_FRAME, data["goal"])
    q, qd = robots.PANDA_Q_READY.copy(), np.zeros(9, np.float32)
    max_q_err = max_qdd_err = 0.0
    for t in range(data["qdd"].shape[0]):
        qdd = c.evaluate(q, qd).numpy()
        max_qdd_err = max(max_qdd_err, float(np.abs(qdd - data["qdd"][t]).max()))
        for _ in range(10):
            q, qd = _euler(model, q, qd, qdd)
        max_q_err = max(max_q_err, float(np.abs(q - data["q"][t + 1]).max()))
    assert max_qdd_err < 2e-3, f"command divergence {max_qdd_err}"
    assert max_q_err < 5e-3, f"trajectory divergence {max_q_err}"


def test_two_joint01_golden_trajectory():
    data = np.load(os.path.join(GOLDEN, "two_joint01_trajectory.npz"))
    model = robots.two_joint_robot()
    c = _target_core(model, "link_23", data["goal"])
    q, qd = np.asarray(data["q0"], np.float32), np.zeros(2, np.float32)
    max_err = 0.0
    for t in range(data["qdd"].shape[0]):
        qdd = c.evaluate(q, qd).numpy()
        max_err = max(max_err, float(np.abs(qdd - data["qdd"][t]).max()))
        for _ in range(10):
            q, qd = _euler(model, q, qd, qdd)
        max_err = max(max_err, float(np.abs(q - data["q"][t + 1]).max()))
    assert max_err < 5e-3, f"divergence {max_err}"


def test_franka01_torque_golden_trajectory():
    """The torque-mode golden: per substep τ = clip(ID(q, q̇, q̈_des),
    ±effort) on the model with PyBullet's collision-shape inertia, held
    against the recorded torques, then q̈ = FD(q, q̇, τ) and the
    integrator."""
    data = np.load(os.path.join(GOLDEN, "franka01_torque_trajectory.npz"))
    assert float(data["exact_vs_torque_max_q_delta"]) < 1e-4
    model = pybullet_collision_inertia(robots.franka_panda())
    c = _target_core(model, robots.PANDA_EE_FRAME, data["goal"])
    effort = torch.tensor(model.effort_limit)
    q = torch.tensor(robots.PANDA_Q_READY)
    qd = torch.zeros(9)
    max_q_err = max_tau_err = 0.0
    for t in range(data["qdd"].shape[0]):
        qdd_des = c.evaluate(q, qd)
        for s in range(10):
            tau = torch.clamp(dynamics.inverse_dynamics(model, q, qd, qdd_des),
                              -effort, effort)
            max_tau_err = max(max_tau_err, float(
                np.abs(tau.numpy() - data["tau"][t, s]).max()))
            qdd = dynamics.forward_dynamics(model, q, qd, tau)
            q, qd = dynamics.semi_implicit_euler_step(model, q, qd, qdd, 0.01)
        max_q_err = max(max_q_err, float(
            np.abs(q.numpy() - data["q"][t + 1]).max()))
    assert max_tau_err < 5e-3, f"torque divergence {max_tau_err}"
    assert max_q_err < 5e-3, f"trajectory divergence {max_q_err}"
