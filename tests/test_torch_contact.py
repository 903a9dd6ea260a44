"""The port's contact dynamics (sim/contact.py, K3's plain version on the
CPU) against the JAX package: the penalty torques, the contact rows, the
impulse model's q̇ and λ, the push-out and no-contact cases of
tests/test_contact.py, and its enumerative-LCP and KKT checks replayed on
the port's own contact rows (the same random scenes, drawn in the same
order, as a batch of envs). `physics_step` with contact and franka/02:
tests/test_torch_contact_scene.py."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu.models import robots as jrobots
from rmp_tpu.sim import collision as JC
from rmp_tpu.sim import contact as jcontact
from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.ops import cuda_fk
from rmp_tpu_torch.sim import collision as C
from rmp_tpu_torch.sim import contact, dynamics

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6          # penalty torques


def t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _scenes(seed, trials=12):
    """tests/test_contact.py's random Panda scenes, drawn in its order:
    q ± 1.2, q̇ ± 1.0 and one sphere thrown near the arm per trial (some
    penetrate, some do not). -> (q, qd (trials, 9), centres (trials, 3),
    radii (trials,))."""
    rng = np.random.default_rng(seed)
    q, qd, c, r = [], [], [], []
    for _ in range(trials):
        q.append(rng.uniform(-1.2, 1.2, 9))
        qd.append(rng.uniform(-1.0, 1.0, 9))
        c.append(rng.uniform([-0.4, -0.4, 0.0], [0.6, 0.4, 0.8]))
        r.append(rng.uniform(0.1, 0.25))
    f32 = np.float32
    return (np.asarray(q, f32), np.asarray(qd, f32), np.asarray(c, f32),
            np.asarray(r, f32))


def _obstacles(c, r):
    """One sphere per env: the port's (B, 1, ...) set and JAX's, vmapped."""
    c1 = c[:, None]
    return (C.ObstacleSet(t(c1), t(c1), t(r[:, None])),
            JC.ObstacleSet(jnp.asarray(c1), jnp.asarray(c1),
                           jnp.asarray(r[:, None])))


@pytest.fixture(scope="module")
def scenes():
    q, qd, c, r = _scenes(7)
    obs, jobs = _obstacles(c, r)
    return q, qd, obs, jobs


def assert_torques_close(got, want):
    """|got - want| <= 1e-6 + 1e-5 max|want| of each env: a joint's torque
    is a sum of contact torques of up to ~150 N m that can cancel to a few
    tenths, and the float32 rounding of the large terms stays in the sum
    (~7e-6 N m on a 0.5 N m joint, CPU run)."""
    scale = np.abs(want).max(axis=-1, keepdims=True)
    err = np.abs(got - want)
    assert (err <= ATOL + RTOL * scale).all(), (err / (ATOL + RTOL * scale)
                                                ).max()


def test_contact_torques_match_jax(scenes):
    """Penalty torques of 12 scenes with obstacle and ground contacts,
    rtol 1e-5 of each env's largest torque, atol 1e-6
    (assert_torques_close); the point kinematics take K3's plain
    version."""
    q, qd, obs, jobs = scenes
    model, jmodel = robots.franka_panda(), jrobots.franka_panda()
    before = cuda_fk.fk_derivatives_batched.launches
    got = contact.contact_torques(model, t(q), t(qd), obs).numpy()
    assert cuda_fk.fk_derivatives_batched.launches == before  # plain on CPU
    want = np.asarray(jax.jit(jax.vmap(
        lambda a, b, o: jcontact.contact_torques(jmodel, a, b, o)))(
            q, qd, jobs))
    depth = -C.robot_obstacle_distances(
        model, K.fk_all(model, t(q)), obs)[3].numpy()
    assert (depth > 0).any(axis=(1, 2)).sum() >= 3, "too few penetrations"
    assert_torques_close(got, want)
    no_ground = contact.contact_torques(
        model, t(q), t(qd), obs, contact.ContactParams(ground=False))
    want = np.asarray(jax.jit(jax.vmap(
        lambda a, b, o: jcontact.contact_torques(
            jmodel, a, b, o, jcontact.ContactParams(ground=False))))(
            q, qd, jobs))
    assert_torques_close(no_ground.numpy(), want)


def test_contact_torques_push_out_of_obstacle():
    """A sphere inside link_1's capsule skin on the two-joint robot: the
    torque turns joint 1 negative (the link pushed to -y), as in the JAX
    package's test, and equals JAX's."""
    model, jmodel = robots.two_joint_robot(), jrobots.two_joint_robot()
    obs = C.sphere_obstacle([0.5, 0.04, 0.075], 0.05).expand(1)
    params = contact.ContactParams(ground=False)
    tau = contact.contact_torques(model, torch.zeros(1, 2),
                                  torch.zeros(1, 2), obs, params)[0].numpy()
    assert np.any(np.abs(tau) > 1e-3), "no contact torque generated"
    assert tau[0] < 0
    want = np.asarray(jcontact.contact_torques(
        jmodel, jnp.zeros(2), jnp.zeros(2),
        JC.sphere_obstacle([0.5, 0.04, 0.075], 0.05),
        jcontact.ContactParams(ground=False)))
    np.testing.assert_allclose(tau, want, rtol=RTOL, atol=ATOL)


def test_no_contact_no_torque():
    model = robots.two_joint_robot()
    obs = C.sphere_obstacle([5.0, 5.0, 5.0], 0.05).expand(1)
    tau = contact.contact_torques(model, torch.tensor([[0.3, -0.2]]),
                                  torch.zeros(1, 2), obs,
                                  contact.ContactParams(ground=False))
    np.testing.assert_allclose(tau.numpy(), np.zeros((1, 2)), atol=1e-6)


def test_contact_order_is_obstacles_primitive_major_then_ground(scenes):
    """C = P K + P rows per env: the obstacle contacts primitive-major, then
    the ground ones, each row of a contact the JAX package's."""
    q, qd, obs, jobs = scenes
    model, jmodel = robots.franka_panda(), jrobots.franka_panda()
    got = [x.numpy() for x in contact.contact_rows(model, t(q), t(qd), obs,
                                                   True)]
    want = [np.asarray(x) for x in jax.jit(jax.vmap(
        lambda a, b, o: jcontact._contact_rows(jmodel, a, b, o, True)))(
            q, qd, jobs)]
    P = C.link_world_capsules_all(model, K.fk_all(model, t(q)))[0].shape[1]
    assert P == 25 and got[1].shape == (12, P * 1 + P)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=2e-6)


def test_impulse_velocity_and_impulses_match_jax(scenes):
    """The default solve (12 sweeps, friction 0.5, cfm 1e-3): q̇ and λ
    against JAX's, at rtol 1e-4 (λ's Gauss-Seidel sweeps carry the
    rounding of earlier rows) and atol 1e-4."""
    q, qd, obs, jobs = scenes
    model, jmodel = robots.franka_panda(), jrobots.franka_panda()
    got_qd, got_lam = contact.impulse_contact_velocity(
        model, t(q), t(qd), 0.01, obstacles=obs, return_impulses=True)
    want_qd, want_lam = jax.jit(jax.vmap(
        lambda a, b, o: jcontact.impulse_contact_velocity(
            jmodel, a, b, 0.01, obstacles=o, return_impulses=True)))(
        q, qd, jobs)
    assert (np.asarray(want_lam) > 0).any()
    np.testing.assert_allclose(got_qd.numpy(), np.asarray(want_qd),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_lam.numpy(), np.asarray(want_lam),
                               rtol=1e-4, atol=1e-4)


def _enumerate_lcp(A, b, tol=1e-8):
    """tests/test_contact.py's exact small-LCP oracle: z >= 0 with
    w = A z + b >= 0 and z . w = 0, by enumerating active sets."""
    n = len(b)
    for r in range(n + 1):
        for S in itertools.combinations(range(n), r):
            S = list(S)
            z = np.zeros(n)
            if S:
                try:
                    zs = np.linalg.solve(A[np.ix_(S, S)], -b[S])
                except np.linalg.LinAlgError:
                    continue
                if (zs < -tol).any():
                    continue
                z[S] = np.maximum(zs, 0.0)
            w = A @ z + b
            if (w >= -1e-6).all():
                return z
    raise AssertionError("no LCP solution found (A not copositive?)")


def test_impulse_solver_matches_enumerative_lcp():
    """Frictionless impulses (200 sweeps) of tests/test_contact.py's 12
    scenes, all in one batch: the post-impulse q̇ equals the exact
    enumerative LCP solve on the port's own rows and mass matrix
    (float64), atol 2e-4, wherever 1 to 10 contacts are active."""
    q, qd, c, r = _scenes(7)
    obs, _ = _obstacles(c, r)
    model = robots.franka_panda()
    cfm, dt = 1e-3, 0.01
    J_n, depth, v_n, _, _ = (x.double().numpy() for x in contact.contact_rows(
        model, t(q), t(qd), obs, True))
    M = dynamics.mass_matrix(model, t(q)).double().numpy() \
        + 1e-6 * np.eye(model.n_q)
    qd_pgs = contact.impulse_contact_velocity(
        model, t(q), t(qd), dt, obstacles=obs, ground=True, friction=0.0,
        iterations=200, cfm=cfm).double().numpy()
    checked = 0
    for b in range(len(q)):
        idx = np.flatnonzero(depth[b] > 0.0)
        if not len(idx) or len(idx) > 10:
            continue
        MinvJT = np.linalg.solve(M[b], J_n[b].T)
        A = J_n[b] @ MinvJT
        rhs = v_n[b] - 0.2 * np.maximum(depth[b] - 1e-3, 0.0) / dt
        z = _enumerate_lcp(A[np.ix_(idx, idx)] + cfm * np.eye(len(idx)),
                           rhs[idx])
        lam = np.zeros(len(rhs))
        lam[idx] = z
        qd_oracle = qd[b].astype(np.float64) + MinvJT @ lam
        np.testing.assert_allclose(qd_pgs[b], qd_oracle, atol=2e-4)
        checked += 1
    assert checked >= 3, f"only {checked} penetrating scenes drawn"


def test_impulse_friction_kkt_residuals():
    """With friction (1500 sweeps, tests/test_contact.py's seed-3 scenes in
    one batch) λ satisfies the cfm-regularised box-friction KKT
    conditions: λ_n >= 0; v⁺_n + bias + cfm λ_n >= -5e-3, within 5e-3 of
    0 where λ_n > 1e-6; |λ_t| <= μ λ_n + 1e-6."""
    q, qd, c, r = _scenes(3)
    obs, _ = _obstacles(c, r)
    model = robots.franka_panda()
    mu, dt, cfm = 0.5, 0.01, 1e-3
    J_n, depth, _, _, _ = (x.double().numpy() for x in contact.contact_rows(
        model, t(q), t(qd), obs, True))
    qd_post, lam = contact.impulse_contact_velocity(
        model, t(q), t(qd), dt, obstacles=obs, friction=mu, iterations=1500,
        cfm=cfm, return_impulses=True)
    qd_post, lam = qd_post.double().numpy(), lam.double().numpy()
    checked = 0
    for b in range(len(q)):
        act = depth[b] > 0
        if not act.any():
            continue
        Cn = depth.shape[1]
        lam_n, lam_t = lam[b, :Cn], lam[b, Cn:].reshape(Cn, 2)
        resid = (J_n[b] @ qd_post[b]
                 - 0.2 * np.maximum(depth[b] - 1e-3, 0.0) / dt + cfm * lam_n)
        assert (lam_n[act] >= 0).all()
        assert (resid[act] >= -5e-3).all()                 # no approach
        pushing = act & (lam_n > 1e-6)
        assert (np.abs(resid[pushing]) <= 5e-3).all()      # complementarity
        assert (np.abs(lam_t[act]).max(axis=-1)
                <= mu * lam_n[act] + 1e-6).all()           # Coulomb box
        checked += 1
    assert checked >= 3
