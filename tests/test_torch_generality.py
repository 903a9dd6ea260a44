"""The N-link planar arm (models/specs.make_planar_arm_spec), the JAX
package's generality helper, through the port: tests/test_generality.py's
checks on the port's own five-link arm, the spec field for field against
JAX's, and the arm's batched 'solve' env (envs/planar.py) against the same
env built from the JAX package's public pieces."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu import taskmaps as jtm
from rmp_tpu.envs import base as jbase
from rmp_tpu.envs import franka as jfranka
from rmp_tpu.models import specs as jspecs
from rmp_tpu.policies import v2 as jv2
from rmp_tpu.sim import collision as jcollision
from rmp_tpu.sim import world as jworld
from rmp_tpu_torch import convert, core, envs
from rmp_tpu_torch import taskmaps as tm
from rmp_tpu_torch.envs import planar
from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.models.fk_derivatives import fk_derivatives
from rmp_tpu_torch.models.specs import build_model, make_planar_arm_spec
from rmp_tpu_torch.ops import cuda_resolve
from rmp_tpu_torch.policies import v1, v2
from rmp_tpu_torch.sim import dynamics
from rmp_tpu_torch.sim.world import init_state, physics_step
from test_torch_envs import jax_state_leaves

torch.set_num_threads(1)

B, T = 8, 5
Q_TOL = 1e-3         # |Δq| after T ticks, port against JAX
STABLE = 1e-5        # a float64 run of the port moves a compared env less


def five_link():
    model = build_model(make_planar_arm_spec(5))
    return model, model.frame_index("ee_joint")


def test_five_link_fk_reaches_its_length():
    """The stretched arm's EE at n_links x link_length = 2.5 in x, 0.05 up."""
    model, ee = five_link()
    assert model.n_q == 5 and model.n_frames == 6
    T0 = K.fk_frame(model, torch.zeros(5), ee)
    np.testing.assert_allclose(T0[:3, 3].numpy(), [2.5, 0.0, 0.05], atol=1e-5)
    np.testing.assert_allclose(K.fk_position(model, torch.zeros(5), ee),
                               T0[:3, 3], atol=0)


def test_five_link_analytic_derivatives_match_autodiff():
    model, ee = five_link()
    rng = np.random.default_rng(21)
    q = torch.tensor(rng.uniform(-1, 1, (1, 5)), dtype=torch.float32)
    qd = torch.tensor(rng.uniform(-1, 1, (1, 5)), dtype=torch.float32)
    _, _, J16, _ = fk_derivatives(model, q, qd)
    _, _, J, _ = K.fk_differentiate(model, q, qd, ee)
    np.testing.assert_allclose(J16[0, ee].numpy(), J[0].numpy(), atol=1e-4)


def test_five_link_crba_matches_id_trick():
    model, _ = five_link()
    q = torch.tensor(np.random.default_rng(22).uniform(-1, 1, (3, 5)),
                     dtype=torch.float32)
    np.testing.assert_allclose(dynamics.mass_matrix(model, q).numpy(),
                               dynamics.mass_matrix_crba(model, q).numpy(),
                               atol=2e-4)


def test_five_link_closed_loop_reaches_the_goal():
    """tests/test_generality.py's loop: a v1 target and joint damping
    through RmpCore ('cholesky'), 700 physics steps at 10 ms, the command
    renewed every 10."""
    model, ee = five_link()
    goal = [1.2, 1.2, 0.05]
    rmp = core.RmpCore(method="cholesky", device="cpu")
    rmp.add_rmp(v1.target_policy(
        goal=goal, taskmap=tm.chain(tm.fk_frame(model, ee), tm.to_position()),
        alpha=0.3, beta=0.8, c=0.1, name="target", device="cpu"))
    rmp.add_rmp(v2.joint_damping(accel_d_gain=1, metric_scalar=0.01,
                                 inertia=0.2))
    state = init_state(model, 1, "cpu", q=[0.3] * 5, goal=goal)
    fn, params = rmp.make_evaluate(), rmp.gather_params()
    for t in range(700):
        if t % 10 == 0:
            qdd = fn(state.q, state.qd, params, (None, None))
        state = physics_step(model, state, qdd, 0.01)
    ee_pos = K.fk_position(model, state.q, ee)[0].numpy()
    assert np.linalg.norm(ee_pos - np.asarray(goal)) < 0.05


def _fields(x):
    """A spec (or a tuple of them) as plain nested tuples of its fields."""
    if dataclasses.is_dataclass(x):
        return tuple((f.name, _fields(getattr(x, f.name)))
                     for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(_fields(v) for v in x)
    return x


@pytest.mark.parametrize("n_links", [1, 5, 12, 24, 32])
def test_planar_spec_and_model_field_for_field(n_links):
    want = jspecs.make_planar_arm_spec(n_links)
    got = make_planar_arm_spec(n_links)
    assert _fields(got) == _fields(want)
    jm, m = jspecs.build_model(want), build_model(got)
    for f in dataclasses.fields(jm):
        a, b = getattr(jm, f.name), getattr(m, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert _fields(b) == _fields(a), f.name


def jax_planar_env(n_links: int, model=None):
    """envs/planar.planar_arm_env(n_links) built from the JAX package's
    public pieces, with the port module's constants; on `model` (a JAX
    model that keeps the arm's 'ee_joint' frame), envs/planar.planar_env's
    counterpart."""
    if model is None:
        model = jspecs.build_model(jspecs.make_planar_arm_spec(n_links))
    policies = (
        jv2.target_attractor(
            goal=planar.GOAL, taskmap=jtm.chain(
                jtm.fk_frame(model, planar.EE), jtm.to_position()),
            accel_p_gain=0.3, accel_d_gain=0.6, accel_norm_eps=0.075,
            metric_alpha_length_scale=0.05, min_metric_alpha=0.03,
            max_metric_scalar=1, min_metric_scalar=0.5,
            proximity_metric_boost_scalar=1.0,
            proximity_metric_boost_length_scale=0.02, name="attractor"),
        jv2.joint_velocity_cap(max_velocity=0.5, velocity_damping_region=0.15,
                               damping_gain=5.0, metric_weight=0.05),
        jv2.joint_damping(accel_d_gain=1, metric_scalar=0.005, inertia=0.3),
        *jfranka._obstacle_policies(model))
    obstacle = jcollision.cylinder_obstacle(*planar.OBSTACLE)

    def reset(key):
        return jbase.env_state(jworld.init_state(
            model, q=[planar.Q_START] * model.n_q, obstacles=obstacle,
            goal=planar.GOAL), key)

    return jbase.Env(name=f"planar_{n_links}link", model=model,
                     policies=policies, reset=reset,
                     ee_frame=model.frame_index(planar.EE),
                     bind_params=jfranka._goal_bind(), resolve_method="solve")


def perturbed(jenv, seed: int):
    rng = np.random.default_rng(seed)
    states = jbase.make_batched_reset(jenv, B)(jax.random.PRNGKey(0))
    n = jenv.model.n_q
    q = (np.asarray(states.sim.q)
         + rng.uniform(-0.1, 0.1, (B, n))).astype(np.float32)
    qd = rng.uniform(-0.05, 0.05, (B, n)).astype(np.float32)
    return dataclasses.replace(states, sim=dataclasses.replace(
        states.sim, q=jnp.asarray(q), qd=jnp.asarray(qd)))


def as_dtype(x, dtype):
    """Every floating tensor of a (nested) state or param tree as dtype."""
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: as_dtype(getattr(x, f.name),
                                                          dtype)
                                         for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: as_dtype(v, dtype) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(as_dtype(v, dtype) for v in x)
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(dtype)
    return x


@pytest.mark.parametrize("n_links", [5, 12, 24])
def test_planar_env_tick_parity_with_jax(n_links, monkeypatch):
    """T ticks of the port's batched 'solve' step (K1's plain version on
    the CPU) against JAX's batched rollout (per env, its unrolled LU) from
    8 perturbed reset states: q within Q_TOL on every env that a float64
    run of the port keeps within STABLE of the float32 one. The obstacle
    rows' metric is live on the first tick."""
    jenv = jax_planar_env(n_links)
    states = perturbed(jenv, 3 + n_links)
    params = jenv.gather_params()
    jfinal, _ = jax.jit(jbase.make_batched_rollout(jenv, T))(states, params)

    env = planar.planar_arm_env(n_links, device="cpu")
    assert [p.name for p in env.policies] == [p.name for p in jenv.policies]
    leaves = jax.tree.map(np.asarray, jax_state_leaves(states))
    state = convert.state_from_numpy(leaves, "cpu")
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu")
    q, qd, prm, ctxs, fk = envs.base._policy_inputs(env, state, tparams)
    tags, blocks = core.policy_row_blocks_structured(env.policies, q, qd,
                                                     prm, ctxs, fk=fk)
    assert tags == ("dense", "identity", "identity", "scalar")
    assert float(blocks[3][1].abs().max()) > 0.0, "obstacle metric is zero"

    final, _ = envs.make_batched_rollout(env, T)(state, tparams)
    # the float64 witness: the kernels' plain versions (their wrappers
    # take float32 and bfloat16 only) on the same problem
    monkeypatch.setattr(envs.base, "pullback_resolve_structured",
                        cuda_resolve.pullback_resolve_structured_plain)
    monkeypatch.setattr(core, "fk_derivatives_batched", fk_derivatives)
    f64, _ = envs.make_batched_rollout(env, T)(
        as_dtype(state, torch.float64), as_dtype(tparams, torch.float64))
    assert f64.sim.q.dtype == torch.float64
    held = (f64.sim.q - final.sim.q.double()).abs().amax(dim=1) <= STABLE
    assert int(held.sum()) >= B // 2
    err = np.abs(final.sim.q.numpy() - np.asarray(jfinal.sim.q)).max(axis=1)
    assert np.isfinite(final.sim.q.numpy()).all()
    assert err[held.numpy()].max() < Q_TOL, f"q after {T} ticks: {err}"
