"""The port's rotation conversions, the taskmaps built on them and the
generic forward-mode derivatives against the JAX package, on the same numpy
inputs made from a seed: values and jvps of ops/geom's conversions (after
tests/test_geom.py), every new taskmap's (x, ẋ, J, c) (after
tests/test_taskmaps.py) by the generic path, the closed-form path and the
stacked jacfwd path, and derivatives='jacfwd' against 'analytic' on the
flagship's whole stack (after tests/test_policies_core.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation
from torch.func import jvp

from rmp_tpu import core as jcore
from rmp_tpu import envs as jenvs
from rmp_tpu import taskmaps as jtm
from rmp_tpu.models import kinematics as jK
from rmp_tpu.models import robots as jrobots
from rmp_tpu.ops import geom as jgeom
from rmp_tpu.policies import v1 as jv1
from rmp_tpu_torch import core, envs
from rmp_tpu_torch import taskmaps as tm
from rmp_tpu_torch.envs.base import _policy_inputs
from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.ops import geom
from rmp_tpu_torch.ops.cuda_resolve import assemble_structured
from rmp_tpu_torch.policies import v1

torch.set_num_threads(1)

VALUE_ATOL = 2e-6     # conversions of O(1) inputs, float32
REL = 1e-4            # |Δ| <= REL * max(1, max |reference|), per array
B = 6
EE = robots.PANDA_EE_FRAME


def assert_close_scaled(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=REL * scale, rtol=0,
                               err_msg=what)


def rotations(seed: int) -> np.ndarray:
    """(16, 3, 3) float32 rotations: random ones, and rotations near 180°
    about x, y and z and near the identity, so that each of Shepperd's four
    candidates (trace, r00, r11, r22 largest) is taken."""
    rng = np.random.default_rng(seed)
    R = list(Rotation.random(8, random_state=seed).as_matrix())
    for axis in np.eye(3):
        R.append(Rotation.from_rotvec(axis * 3.0).as_matrix())
        tilt = axis + rng.normal(scale=0.1, size=3)
        R.append(Rotation.from_rotvec(tilt / np.linalg.norm(tilt) * 2.9)
                 .as_matrix())
    R.append(Rotation.from_rotvec(rng.normal(scale=0.1, size=3)).as_matrix())
    R.append(np.eye(3))
    return np.asarray(R, np.float32)


def tangent_like(x: np.ndarray, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=x.shape).astype(np.float32)


def _euler_in(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.2, 1.2, (16, 3)).astype(np.float32)


def _quat_in(seed):
    return Rotation.random(16, random_state=seed).as_quat().astype(np.float32)


GEOM_CASES = {
    "euler_from_rotation_matrix": rotations,
    "quaternion_from_rotation_matrix": rotations,
    "rotation_matrix_from_quaternion": _quat_in,
    "angular_velocity_to_euler_rates_matrix": _euler_in,
}


@pytest.mark.parametrize("name", GEOM_CASES)
def test_conversion_values_and_jvps_match_jax(name):
    """Values and forward-mode derivatives (one random tangent) of each
    conversion, batched, against jnp; the quaternion conversion on
    rotations that take each of its four branches."""
    x = GEOM_CASES[name](3)
    v = tangent_like(x, 4)
    jfn, tfn = getattr(jgeom, name), getattr(geom, name)
    jval, jtan = jax.jvp(jfn, (jnp.asarray(x),), (jnp.asarray(v),))
    tval, ttan = jvp(tfn, (torch.tensor(x),), (torch.tensor(v),))
    np.testing.assert_allclose(tval.numpy(), np.asarray(jval), rtol=0,
                               atol=VALUE_ATOL, err_msg=name)
    assert_close_scaled(ttan, jtan, f"{name} jvp")


def test_quaternion_roundtrip_and_sign():
    """R -> quaternion -> R returns R; w >= 0; and every Shepperd branch is
    taken by the test rotations."""
    R = torch.tensor(rotations(5))
    quat = geom.quaternion_from_rotation_matrix(R)
    assert (quat[:, 3] >= 0).all()
    np.testing.assert_allclose(
        geom.rotation_matrix_from_quaternion(quat).numpy(), R.numpy(),
        atol=1e-5)
    scores = torch.stack([R.diagonal(dim1=-2, dim2=-1).sum(-1),
                          R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]], dim=-1)
    assert set(torch.argmax(scores, dim=-1).tolist()) == {0, 1, 2, 3}


def test_safe_sqrt_jvp_is_finite_at_zero():
    """A rotation of exactly 180° about x makes Shepperd's trace candidate
    take sqrt(0): its jvp, unselected, must still be finite, and the
    selected one equal JAX's."""
    R = torch.tensor(np.diag([1.0, -1.0, -1.0]).astype(np.float32))[None]
    v = torch.tensor(tangent_like(R.numpy(), 9))
    _, tan = jvp(geom.quaternion_from_rotation_matrix, (R,), (v,))
    _, jtan = jax.jvp(jgeom.quaternion_from_rotation_matrix,
                      (jnp.asarray(R.numpy()),), (jnp.asarray(v.numpy()),))
    assert torch.isfinite(tan).all()
    assert_close_scaled(tan, jtan, "jvp at a 180° rotation")


def test_rotate_vector_and_mm_match_jax():
    rng = np.random.default_rng(6)
    T = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    T[:, :3, :3] = rotations(6)[:5]
    T[:, :3, 3] = rng.normal(size=(5, 3))
    v = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        geom.rotate_vector(torch.tensor(T), torch.tensor(v)).numpy(),
        np.asarray(jgeom.rotate_vector(jnp.asarray(T), jnp.asarray(v))),
        atol=VALUE_ATOL)
    a = rng.normal(size=(5, 4, 9)).astype(np.float32)
    b = rng.normal(size=(5, 9, 3)).astype(np.float32)
    np.testing.assert_allclose(
        geom.mm(torch.tensor(a), torch.tensor(b)).numpy(),
        np.asarray(jgeom.mm(jnp.asarray(a), jnp.asarray(b))), atol=1e-5)


# ------------------------------------------------------------ taskmaps ----

def _state(seed: int, n: int):
    rng = np.random.default_rng(seed)
    q = (jrobots.PANDA_Q_READY + rng.uniform(-0.5, 0.5, (B, n))).astype(
        np.float32)
    qd = rng.uniform(-0.5, 0.5, (B, n)).astype(np.float32)
    return q, qd


def _ctx(seed: int, shapes: dict) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-0.2, 0.2, (B,) + s).astype(np.float32)
            for k, s in shapes.items()}


def _chains(pkg, model):
    """name -> (taskmap, ctx field shapes per env) for both packages."""
    t = tm if pkg == "torch" else jtm
    fk = t.fk_frame(model, EE)
    hand = "panda_hand_joint"
    frames = model.collision_frames[:3]
    if pkg == "torch":
        def bent(q, ctx):
            return torch.stack([torch.sin(q[..., 0]) * q[..., 1],
                                q[..., 2] * q[..., 3]], dim=-1)[..., None, :]
    else:
        def bent(q, ctx):
            return jnp.stack([jnp.sin(q[0]) * q[1], q[2] * q[3]])[None, :]
    return {
        "to_euler": (t.chain(fk, t.to_euler()), {}),
        "to_quaternion": (t.chain(fk, t.to_quaternion()), {}),
        "to_rotation6": (t.chain(fk, t.to_rotation6()), {}),
        "relative_offsets": (t.chain(fk, t.relative_offsets()),
                             {"relative_position": (4, 3)}),
        "relative_offsets_to_position": (
            t.chain(fk, t.relative_offsets(), t.to_position()),
            {"relative_position": (4, 3)}),
        "relative_points": (t.chain(fk, t.relative_points()),
                            {"relative_position": (4, 3)}),
        "frames_relative_offsets": (
            t.chain(t.multi_fk_frames(model, frames),
                    t.frames_relative_offsets()),
            {"relative_position": (3, 2, 3)}),
        "frame_to_point_distance": (
            t.chain(t.fk_frame(model, hand), t.frame_to_point_distance()),
            {"pos_on_link": (5, 3), "pos_on_obstacle": (5, 3)}),
        "from_function": (t.from_function(bent), {}),
    }


TASKMAPS = tuple(_chains("torch", robots.franka_panda()))


def _jax_derivatives(name, q, qd, ctx):
    tmap, _ = _chains("jax", jrobots.franka_panda())[name]
    fn = jax.jit(jax.vmap(lambda a, b, c: jtm.differentiate(tmap, a, b, c)))
    return jax.tree.map(np.asarray, fn(jnp.asarray(q), jnp.asarray(qd),
                                       {k: jnp.asarray(v)
                                        for k, v in ctx.items()}))


@pytest.fixture(scope="module", params=TASKMAPS)
def taskmap_case(request):
    name = request.param
    model = robots.franka_panda()
    tmap, shapes = _chains("torch", model)[name]
    q, qd = _state(11, model.n_q)
    ctx = _ctx(12, shapes)
    if name == "frame_to_point_distance":
        # body points near the frame origin, obstacle points clear of them
        T = K.fk_all(model, torch.tensor(q))[:, model.frame_index(
            "panda_hand_joint"), :3, 3].numpy()
        ctx["pos_on_link"] += T[:, None]
        ctx["pos_on_obstacle"] += T[:, None] + 0.5
    want = _jax_derivatives(name, q, qd, ctx)
    tctx = {k: torch.tensor(v) for k, v in ctx.items()} or None
    return dict(name=name, tmap=tmap, q=torch.tensor(q), qd=torch.tensor(qd),
                ctx=tctx, want=want)


def test_taskmap_generic_derivatives_match_jax(taskmap_case):
    """taskmaps.differentiate (forward mode through the whole map, FK
    included) against jax's on the same map, env by env."""
    c = taskmap_case
    got = tm.differentiate(c["tmap"], c["q"], c["qd"], c["ctx"])
    for what, g, w in zip(("x", "xd", "J", "c"), got, c["want"]):
        assert_close_scaled(g, w, f"{c['name']} {what}")


def test_taskmap_engine_derivatives_match_jax(taskmap_case):
    """The combine engine's two paths on the same map: 'analytic' (K3's
    plain version and the post map's autodiff; full 16-row blocks for
    maps that read the rotation) and 'jacfwd' (one stacked pass)."""
    c = taskmap_case
    pol = v1.target_policy(goal=np.zeros(3), taskmap=c["tmap"], alpha=1.0,
                           beta=1.0, c=1.0)
    for path in (core._taskmap_derivatives_analytic,
                 core._taskmap_derivatives_jacfwd):
        got = path((pol,), c["q"], c["qd"], (c["ctx"],))
        for what, g, w in zip(("x", "xd", "J", "c"), got, c["want"]):
            assert_close_scaled(g[0], w, f"{c['name']} {path.__name__} "
                                f"{what}")


def test_rotation_reading_chains_take_the_full_rows():
    """Only translation-reading tails fold to 3-row FK blocks: a chain
    through relative_points, to_rotation6, to_euler or to_quaternion keeps
    post_trans None; to_position and the distance maps fold."""
    model = robots.franka_panda()
    fk = tm.fk_frame(model, EE)
    for tail in (tm.relative_points(), tm.to_rotation6(), tm.to_euler(),
                 tm.to_quaternion(), tm.relative_offsets()):
        assert tm.chain(fk, tail).post_trans is None
    assert tm.chain(fk, tm.to_position()).post_trans is not None
    assert tm.chain(fk, tm.frame_to_point_distance()).post_trans is not None
    assert not tm.chain(tm.from_function(lambda q, ctx: q[:, None]),
                        tm.to_position()).fk_rooted


def test_relative_points_equals_chain_of_offsets_and_position():
    """relative_points is the fused form of chain(relative_offsets,
    to_position): equal values and derivatives."""
    model = robots.franka_panda()
    q, qd = (torch.tensor(a) for a in _state(13, model.n_q))
    ctx = {k: torch.tensor(v) for k, v in
           _ctx(14, {"relative_position": (6, 3)}).items()}
    fused = tm.chain(tm.fk_frame(model, EE), tm.relative_points())
    chained = tm.chain(tm.fk_frame(model, EE), tm.relative_offsets(),
                       tm.to_position())
    for g, w in zip(tm.differentiate(fused, q, qd, ctx),
                    tm.differentiate(chained, q, qd, ctx)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)


def test_fk_differentiate_matches_jax():
    model = robots.franka_panda()
    q, qd = _state(15, model.n_q)
    ee = model.frame_index(EE)
    got = K.fk_differentiate(model, torch.tensor(q), torch.tensor(qd), ee)
    want = jax.vmap(lambda a, b: jK.fk_differentiate(
        jrobots.franka_panda(), a, b, ee))(jnp.asarray(q), jnp.asarray(qd))
    for what, g, w in zip(("x", "xd", "J", "c"), got, want):
        assert_close_scaled(g, w, what)


# ------------------------------------------------ jacfwd on the stack -----

def _stack_inputs(name: str, qd_span: float, seed: int):
    rng = np.random.default_rng(seed)
    env = envs.make(name, device="cpu")
    states = envs.make_batched_reset(env, 4)()
    states.sim.qd = torch.tensor(rng.uniform(-qd_span, qd_span, (4, 9)),
                                 dtype=torch.float32)
    return env, _policy_inputs(env, states, env.gather_params())


def test_analytic_derivatives_match_jacfwd_full_stack():
    """franka/06's whole stack from its reset state with q̇ ± 0.5: 'analytic'
    and 'jacfwd' q̈ within the JAX test's 1e-3, and the jacfwd q̈ against
    JAX's jacfwd q̈."""
    name = "franka/06_cluttered_environment"
    env, (q, qd, params, ctxs, fk) = _stack_inputs(name, 0.5, 16)
    qdd = {d: core.evaluate_policies(env.policies, q, qd, params, ctxs,
                                     "pinv", derivatives=d, fk=fk)
           for d in ("analytic", "jacfwd")}
    np.testing.assert_allclose(qdd["analytic"].numpy(),
                               qdd["jacfwd"].numpy(), atol=1e-3)
    jenv = jenvs.make(name)
    jctxs = jax.tree.map(lambda t: jnp.asarray(t.numpy()), ctxs)
    jparams = jenv.gather_params()
    want = jax.jit(jax.vmap(
        lambda a, b, c: jcore.evaluate_policies(
            jenv.policies, a, b, jparams, c, "pinv", derivatives="jacfwd")))(
        jnp.asarray(q.numpy()), jnp.asarray(qd.numpy()), jctxs)
    assert_close_scaled(qdd["jacfwd"], want, "jacfwd q̈ against JAX")


def test_fast_resolves_match_pinv_full_stack():
    """'solve' within 1e-3 of 'pinv' on franka/06's stack from q̇ ± 0.5, and
    'cholesky' too on the envs whose combined metric is positive definite:
    near the velocity cap's band the metric can turn indefinite, where
    'cholesky' is not valid (core.resolve)."""
    name = "franka/06_cluttered_environment"
    env, (q, qd, params, ctxs, fk) = _stack_inputs(name, 0.5, 16)
    tags, blocks = core.policy_row_blocks_structured(env.policies, q, qd,
                                                     params, ctxs, fk=fk)
    A, _ = assemble_structured(tags, blocks)
    pd = torch.linalg.eigvalsh(0.5 * (A + A.transpose(-1, -2)))[:, 0] > 0
    assert pd.any() and not pd.all()
    want = core.evaluate_policies(env.policies, q, qd, params, ctxs, "pinv",
                                  fk=fk)
    got = core.evaluate_policies(env.policies, q, qd, params, ctxs, "solve",
                                 fk=fk)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3)
    got = core.evaluate_policies(env.policies, q, qd, params, ctxs,
                                 "cholesky", fk=fk)
    np.testing.assert_allclose(got[pd].numpy(), want[pd].numpy(), atol=1e-3)


def test_generic_taskmap_policy_matches_jax():
    """A policy on a taskmap that is neither FK-rooted nor the identity
    (from_function) goes through the closed-form path's generic fallback
    and the structured blocks, as in the JAX package."""
    rng = np.random.default_rng(17)
    q = rng.uniform(-1, 1, (B, 9)).astype(np.float32)
    qd = rng.uniform(-1, 1, (B, 9)).astype(np.float32)
    goal = [0.3, -0.2, 0.1]

    def tpol(q, ctx):
        return torch.stack([torch.sin(q[:, 0]) * q[:, 1], q[:, 2] * q[:, 3],
                            torch.cos(q[:, 4])], dim=-1)[:, None, :]

    def jpol(q, ctx):
        return jnp.stack([jnp.sin(q[0]) * q[1], q[2] * q[3],
                          jnp.cos(q[4])])[None, :]

    pols = (v1.target_policy(goal=goal, taskmap=tm.from_function(tpol),
                             alpha=1.0, beta=0.5, c=0.1),
            v1.configuration_space_biasing(q0=np.zeros(9), gamma_p=0.1,
                                           gamma_d=0.2, name="bias"))
    jpols = (jv1.target_policy(goal=goal, taskmap=jtm.from_function(jpol),
                               alpha=1.0, beta=0.5, c=0.1),
             jv1.configuration_space_biasing(q0=np.zeros(9), gamma_p=0.1,
                                             gamma_d=0.2, name="bias"))
    params = tuple(p.params for p in pols)
    got = core.evaluate_policies(pols, torch.tensor(q), torch.tensor(qd),
                                 params, (None, None), "pinv")
    want = jax.vmap(lambda a, b: jcore.evaluate_policies(
        jpols, a, b, tuple(p.params for p in jpols), (None, None),
        "pinv"))(jnp.asarray(q), jnp.asarray(qd))
    assert_close_scaled(got, want, "q̈")
