"""K5, the fused v2 tick (rmp_tpu_torch/ops/cuda_tick.py), and scene 05.

The reference is the JAX package's K5 kernel body
(`rmp_tpu.ops.pallas_tick._make_kernel`) run eagerly on the CPU: it reads
`ref[j, 0]` / `ref[k, i, 0]` and writes `out_ref[i, 0]`, so jnp arrays in
the kernel's (..., 1, 8, 128) layout serve as its input refs and a dict as
its output ref, and it runs exactly the jnp operations of the kernel without
`pallas_call` (about 2 s at B = 1024 for scene 06). The body fixes B to
8 x 128 = 1024. A slow-marked test holds this shim against the real
`make_fused_qdd` in interpret mode.

K5 takes only the first capsule of each collision link, so it is held
against the port's standard q̈ on a model whose links keep their first
capsule, not against the full 25-capsule model.
"""
import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu import envs as jenvs
from rmp_tpu.models import specs as jspecs
from rmp_tpu.ops import pallas_tick as jpt
from rmp_tpu_torch import convert, envs
from rmp_tpu_torch.envs import planar
from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.models import specs
from rmp_tpu_torch.ops import cuda_tick, tick_ops
from rmp_tpu_torch.sim import collision
import test_torch_fk_wide as fk_wide
from test_torch_envs import jax_state_leaves
from test_torch_generality import jax_planar_env

torch.set_num_threads(1)

B = jpt.BLOCK
SCENES = ("franka/06_cluttered_environment", "franka/05_obstacle_avoidance")
INPUTS = ("q", "qd", "goal", "obs_p0", "obs_p1", "obs_r")
TOL = 1e-4      # |Δq̈| <= TOL * max(1, |q̈|), env by env
STABLE = 1e-5   # a one-ulp move of q and q̇ moves the reference less
ACCURATE = 1e-5  # the reference's own float32 error, against float64
SPREAD = 10.0   # an env the screen drops: the port's float32 error may
                # reach SPREAD x the reference's own


def kernel_layout(x: np.ndarray) -> jnp.ndarray:
    """(B, ...) -> (..., 1, 8, 128): the JAX kernel's block layout."""
    x = np.asarray(x, np.float32)
    return jnp.asarray(np.moveaxis(x, 0, -1).reshape(
        *x.shape[1:], 1, jpt.SUBLANES, jpt.LANES))


def jax_k5_body(jenv, inputs: dict, ridge: float = 1e-6) -> np.ndarray:
    """q̈ (B, n) of JAX's K5 kernel body, run eagerly through ref shims."""
    kernel = jpt._make_kernel(jenv.model, jenv, ridge)
    out = {}
    kernel(*(kernel_layout(inputs[k]) for k in INPUTS), out)
    n = jenv.model.n_q
    return np.stack([np.asarray(out[i, 0]).reshape(B) for i in range(n)],
                    axis=1)


def port_k5(scene: str, inputs: dict, dtype=torch.float32) -> np.ndarray:
    env = envs.make(scene, device="cpu")
    args = [torch.tensor(inputs[k], dtype=dtype) for k in INPUTS]
    return cuda_tick.fused_qdd_plain(cuda_tick.fused_tick(env),
                                     *args).double().numpy()


@functools.lru_cache(maxsize=None)
def states(scene: str, wide: bool) -> dict:
    """Seeded inputs at B = 1024 with the scene's obstacles. Near the ready
    pose: reset q ± 0.1, q̇ ± 0.05, goal ± 0.05. Wide: the distribution of
    tests/test_pallas_tick.py (q ± 1, q̇ ± 0.8, goals in its box)."""
    jenv = jenvs.make(scene)
    start = jenv.reset(jax.random.PRNGKey(0)).sim
    obs = start.obstacles
    K = obs.count
    rng = np.random.default_rng(13 if wide else 5)
    if wide:
        q = rng.uniform(-1.0, 1.0, (B, 9))
        qd = rng.uniform(-0.8, 0.8, (B, 9))
        goal = rng.uniform([0.2, -0.5, 0.2], [0.7, 0.5, 0.7], (B, 3))
    else:
        q = np.asarray(start.q) + rng.uniform(-0.1, 0.1, (B, 9))
        qd = rng.uniform(-0.05, 0.05, (B, 9))
        goal = np.asarray(start.goal) + rng.uniform(-0.05, 0.05, (B, 3))
    f32 = functools.partial(np.asarray, dtype=np.float32)
    return dict(q=f32(q), qd=f32(qd), goal=f32(goal),
                obs_p0=f32(np.broadcast_to(obs.p0, (B, K, 3))),
                obs_p1=f32(np.broadcast_to(obs.p1, (B, K, 3))),
                obs_r=f32(np.broadcast_to(obs.radius, (B, K))))


@functools.lru_cache(maxsize=None)
def jax_out(scene: str, wide: bool, ulp: bool = False) -> np.ndarray:
    inputs = dict(states(scene, wide))
    if ulp:
        up = np.float32(np.inf)
        inputs["q"] = np.nextafter(inputs["q"], up)
        inputs["qd"] = np.nextafter(inputs["qd"], up)
    return jax_k5_body(jenvs.make(scene), inputs)


def scale(qdd: np.ndarray) -> np.ndarray:
    return np.maximum(1.0, np.abs(qdd).max(axis=1))


@pytest.mark.parametrize("scene", SCENES)
def test_supports_agrees_with_jax(scene):
    jenv, env = jenvs.make(scene), envs.make(scene, device="cpu")
    assert cuda_tick.supports(env) and jpt.supports(jenv)
    for drop in ("attractor", "collision_avoidance"):
        jcut = dataclasses.replace(jenv, policies=tuple(
            p for p in jenv.policies if p.name != drop))
        cut = dataclasses.replace(env, policies=tuple(
            p for p in env.policies if p.name != drop))
        assert not cuda_tick.supports(cut) and not jpt.supports(jcut)
        with pytest.raises(ValueError, match="K5"):
            cuda_tick.make_fused_qdd(cut)


@pytest.mark.parametrize("scene", SCENES)
def test_plain_matches_jax_kernel_body_near_ready(scene):
    want = jax_out(scene, False)
    got = port_k5(scene, states(scene, False))
    assert np.isfinite(want).all() and np.isfinite(got).all()
    err = np.abs(got - want).max(axis=1) / scale(want)
    print(f"{scene}: near the ready pose, max rel err {err.max():.3e}")
    assert err.max() <= TOL, f"worst env {err.argmax()}: {err.max():.3e}"


@pytest.mark.parametrize("scene", SCENES)
def test_plain_matches_jax_kernel_body_wide_screened(scene):
    """The wide states reach the velocity cap's singularity, where the
    combined metric turns indefinite and the unpivoted Cholesky gives
    garbage or non-finite values, and links that penetrate an obstacle,
    where the 1/d curvature row amplifies float32 rounding. Compared
    envs: finite, moved by at most STABLE x max(1, |q̈|) when q and q̇ move
    up by one ulp, and within ACCURATE x max(1, |q̈|) of the port's
    float64 run (the witness: a one-ulp move misses rounding that the
    inputs do not drive). Every other finite env still holds the port's
    float32 run within SPREAD x the reference's own error of float64."""
    inputs = states(scene, True)
    want = jax_out(scene, True)
    s = scale(np.nan_to_num(want))
    finite = np.isfinite(want).all(axis=1)
    with np.errstate(invalid="ignore"):
        sens = np.abs(jax_out(scene, True, ulp=True) - want).max(axis=1) / s
        witness = port_k5(scene, inputs, torch.float64)
        ref_err = np.abs(want - witness).max(axis=1) / s
        got = port_k5(scene, inputs)
        port_err = np.abs(got - witness).max(axis=1) / s
        err = np.abs(got - want).max(axis=1) / s
    held = finite & (sens <= STABLE) & (ref_err <= ACCURATE)
    print(f"{scene}: {int(finite.sum())} of {B} envs finite, "
          f"{int(held.sum())} compared, max rel err {err[held].max():.3e}; "
          f"{int((finite & ~held).sum())} finite envs held to the witness")
    missed = finite & (sens <= STABLE) & ~held
    if missed.any():
        i = np.flatnonzero(missed)[err[missed].argmax()]
        print(f"  {int(missed.sum())} envs pass the one-ulp screen but not "
              f"the witness; worst, env {i}: one-ulp move {sens[i]:.1e}, "
              f"port vs reference {err[i]:.1e}, reference vs float64 "
              f"{ref_err[i]:.1e}, port vs float64 {port_err[i]:.1e}")
    assert held.sum() >= B // 2
    assert err[held].max() <= TOL, \
        f"worst env {np.flatnonzero(held)[err[held].argmax()]}"
    rest = finite & ~held
    assert np.all(port_err[rest] <= np.maximum(TOL, SPREAD * ref_err[rest]))


@pytest.mark.parametrize("scene", SCENES)
def test_fused_qdd_is_the_standard_qdd_on_first_capsules(scene):
    """The port's standard q̈ (evaluate_policies, 'cholesky', analytic FK)
    on a copy of the model whose links keep their first capsule is what K5
    computes; the full 25-capsule model's is not."""
    env = envs.make(scene, device="cpu")
    args = tuple(torch.tensor(states(scene, False)[k]) for k in INPUTS)
    got = cuda_tick.make_fused_qdd(env)(*args).numpy()
    want = cuda_tick.standard_qdd(env, *args, first_capsule=True).numpy()
    full = cuda_tick.standard_qdd(env, *args, first_capsule=False).numpy()
    err = np.abs(got - want).max(axis=1) / scale(want)
    gap = np.abs(got - full).max()
    print(f"{scene}: K5 vs first-capsule standard q̈ {err.max():.3e}; "
          f"vs the full 25-capsule model {gap:.3e}")
    assert err.max() <= TOL


PLANAR = (5, 12, 17, 24, 32)  # links of the planar arms K5 is held on
# Past 16 links (the wide kernel's models) the chains are ill-conditioned:
# any float32 solve of a 32-link tick, the batched step's pivoted LU too,
# lies up to ~5e-4 x max(1, |q̈|) from float64 on single envs. There an env
# that the one-ulp and float64 screens drop is held to float64 instead:
# K5's error within max(TOL, SPREAD x the reference's, LONG x the float32
# LU's on the same env).
LONG = 2.0


def arm_states(env, seed: int) -> dict:
    """Seeded inputs at B = 1024 near a planar env's reset (q = 0.3 ± 0.1,
    q̇ ± 0.05, goal ± 0.05) with its cylinder."""
    n = env.model.n_q
    obs = env.reset(1).sim.obstacles
    rng = np.random.default_rng(seed)
    f32 = functools.partial(np.asarray, dtype=np.float32)
    return dict(q=f32(planar.Q_START + rng.uniform(-0.1, 0.1, (B, n))),
                qd=f32(rng.uniform(-0.05, 0.05, (B, n))),
                goal=f32(np.asarray(planar.GOAL)
                         + rng.uniform(-0.05, 0.05, (B, 3))),
                obs_p0=f32(np.broadcast_to(obs.p0.numpy(), (B, 1, 3))),
                obs_p1=f32(np.broadcast_to(obs.p1.numpy(), (B, 1, 3))),
                obs_r=f32(np.broadcast_to(obs.radius.numpy(), (B, 1))))


@functools.lru_cache(maxsize=None)
def planar_states(n_links: int) -> dict:
    """arm_states of the n_links arm: every env has links within the
    obstacle policy's 0.5 m, some pierce the cylinder."""
    return arm_states(planar.planar_arm_env(n_links, device="cpu"),
                      50 + n_links)


def batched_step(env, inputs: dict) -> tuple:
    """A planar env's own batched step's q̈ ('solve': K1's plain version,
    pivoted LU, float32) at `inputs`, and K5's plain version in float64 on
    the same inputs (ridge 1e-6 against the step's 0: below 4e-6 of |q̈|,
    the damping metric keeping A's eigenvalues above 0.3)."""
    args = [torch.tensor(inputs[k]) for k in INPUTS]
    start = envs.make_batched_reset(env, args[0].shape[0])()
    states = dataclasses.replace(start, sim=dataclasses.replace(
        start.sim, q=args[0], qd=args[1], goal=args[2],
        obstacles=collision.ObstacleSet(
            *args[3:], kinds=("cylinder",) * args[5].shape[1])))
    _, aux = envs.make_batched_control_step(env)(states,
                                                 env.gather_params())
    witness = cuda_tick.fused_qdd_plain(
        cuda_tick.fused_tick(env), *(a.double() for a in args)).numpy()
    return aux["qdd"].double().numpy(), witness


@functools.lru_cache(maxsize=None)
def planar_step(n_links: int) -> tuple:
    """batched_step of the n_links arm at planar_states."""
    return batched_step(planar.planar_arm_env(n_links, device="cpu"),
                        planar_states(n_links))


@pytest.mark.parametrize("n_links", PLANAR)
def test_planar_plain_matches_jax_kernel_body(n_links):
    """The planar env is K5's path in both packages (both `supports` say
    so), at n = 5 and 12. Its EE carries a sphere, a zero-length segment
    to K5: at n = 5 the EE is within the obstacle policy's reach on some
    envs, so the degenerate branch of the closest-point parameters (s = 0
    where |a1 - a0|² <= 1e-9) is on the compared path. Some links pierce
    the cylinder, where the 1/d curvature row amplifies rounding: the envs
    compared and the rest are screened as in the wide test above, past 16
    links against float64 beside the float32 LU (LONG)."""
    hold_to_jax(jax_planar_env(n_links),
                planar.planar_arm_env(n_links, device="cpu"),
                planar_states(n_links), f"planar {n_links}",
                lambda: planar_step(n_links)[0])


def hold_to_jax(jenv, env, inputs: dict, what: str, step=None):
    """K5's plain version against JAX's kernel body on the same env, envs
    screened as test_planar_plain_matches_jax_kernel_body says; step(): the
    batched step's q̈ (LONG) where the model is past the 16-lane kernel."""
    n_links = env.model.n_q
    assert cuda_tick.supports(env) and jpt.supports(jenv)
    want = jax_k5_body(jenv, inputs)
    up = np.float32(np.inf)
    moved = dict(inputs, q=np.nextafter(inputs["q"], up),
                 qd=np.nextafter(inputs["qd"], up))
    s = scale(want)
    sens = np.abs(jax_k5_body(jenv, moved) - want).max(axis=1) / s
    tick = cuda_tick.fused_tick(env)
    args = [torch.tensor(inputs[k]) for k in INPUTS]
    witness = cuda_tick.fused_qdd_plain(
        tick, *(a.double() for a in args)).numpy()
    got = cuda_tick.make_fused_qdd(env)(*args).numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    ref_err = np.abs(want - witness).max(axis=1) / s
    port_err = np.abs(got - witness).max(axis=1) / s
    err = np.abs(got - want).max(axis=1) / s
    held = (sens <= STABLE) & (ref_err <= ACCURATE)
    ee = K.fk_position(env.model, args[0], env.ee_frame)
    reach = (ee - args[3][:, 0]).norm(dim=-1) < 0.5 + 0.09  # + both radii
    print(f"{what}: {int(held.sum())} of {B} envs compared, max "
          f"rel err {err[held].max():.3e} ({err.max():.3e} over all); EE "
          f"near the cylinder on {int(reach.sum())} envs")
    if n_links == 5:
        assert reach[torch.from_numpy(held)].any()
    assert held.sum() >= B // 2
    assert err[held].max() <= TOL, \
        f"worst env {np.flatnonzero(held)[err[held].argmax()]}"
    rest = ~held
    limit = np.maximum(TOL, SPREAD * ref_err[rest])
    if n_links > cuda_tick.NARROW[0]:
        lu_err = np.abs(step() - witness).max(axis=1) / s
        limit = np.maximum(limit, LONG * lu_err[rest])
    assert np.all(port_err[rest] <= limit)


def test_degenerate_segment_closest_params_match_jax():
    """_seg_closest against sim.collision.segment_closest_params where the
    first segment is a point (the planar EE's sphere), the second a
    segment, a point, or parallel to nothing: the `> EPS` guards pick the
    same branch."""
    rng = np.random.default_rng(7)
    n = 64
    a0 = rng.normal(size=(n, 3)).astype(np.float32)
    b0 = rng.normal(size=(n, 3)).astype(np.float32)
    b1 = b0 + rng.normal(size=(n, 3)).astype(np.float32)
    b1[::4] = b0[::4]                     # a point against a point too
    s, t = collision.segment_closest_params(*(torch.tensor(x) for x in
                                              (a0, a0, b0, b1)))
    js, jt, _, _ = jpt._seg_closest(*([jnp.asarray(x[:, i]) for i in range(3)]
                                      for x in (a0, a0, b0, b1)))
    np.testing.assert_array_equal(s.numpy(), np.zeros(n, np.float32))
    np.testing.assert_array_equal(np.asarray(js), s.numpy())
    np.testing.assert_allclose(np.asarray(jt), t.numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("n_links", PLANAR)
def test_planar_fused_qdd_is_the_batched_step_qdd(n_links):
    """Every collision frame of the planar arm has one primitive, so K5's
    first-primitive reading loses nothing: it equals the env's own batched
    step's q̈ ('solve', K1's plain version, ridge 0) directly, at phase
    11's 2e-4 x max(1, |q̈|) of chip_smoke.py. Past 16 links on the envs
    where the step lies within ACCURATE of float64, and elsewhere K5 within
    max(2e-4, LONG x the step's error) of float64."""
    env = planar.planar_arm_env(n_links, device="cpu")
    inputs = planar_states(n_links)
    args = [torch.tensor(inputs[k]) for k in INPUTS]
    got = cuda_tick.make_fused_qdd(env)(*args).double().numpy()
    hold_to_the_step(got, *planar_step(n_links), f"planar {n_links}",
                     n_links > cuda_tick.NARROW[0])


def hold_to_the_step(got, want, witness, what: str, screened: bool):
    """K5's q̈ `got` against the batched step's `want`: everywhere within
    2e-4 x max(1, |q̈|), or (screened) where the step lies within ACCURATE
    of float64 (`witness`), and elsewhere within max(2e-4, LONG x the
    step's error) of float64."""
    err = np.abs(got - want).max(axis=1) / scale(want)
    print(f"{what}: K5 vs the batched step's q̈ {err.max():.3e}")
    if not screened:
        assert err.max() <= 2e-4
        return
    B = len(got)
    s = scale(witness)
    lu_err = np.abs(want - witness).max(axis=1) / s
    held = lu_err <= ACCURATE
    k5_err = np.abs(got - witness).max(axis=1) / s
    print(f"{what}: {int(held.sum())} of {B} envs held, max "
          f"{err[held].max():.3e}; elsewhere K5 / LU against float64 "
          f"{k5_err[~held].max(initial=0.0):.3e} / "
          f"{lu_err[~held].max(initial=0.0):.3e}")
    assert held.sum() >= B // 2
    assert err[held].max() <= 2e-4
    assert np.all(k5_err[~held] <= np.maximum(2e-4, LONG * lu_err[~held]))


# Two layouts of K5's wide kernel that no planar arm covers, as
# chip_smoke.py's phase 20 holds them on the card: a branched tree
# (test_torch_fk_wide.branched at F = 30, n = 28: a 20-link arm with 8
# revolute links off link 10, so past the branch a frame's parent is not
# the frame before) on the planar env's policies, and the 32-link arm with
# CYLINDERS cylinders an env (its own and copies moved 0.8-1.2 m in the x-y
# plane: 132 pairs an env).
WIDE_CASES = ("branched", "four_cylinders")
CYLINDERS = 4
SMALL = 128     # envs of the batched-step comparison


def branched_tree(sp):
    """The branched tree of specs module `sp` (the port's or JAX's)."""
    return fk_wide.branched(sp, n_links=20, n_branch=8, at=10)


@functools.lru_cache(maxsize=None)
def wide_case(case: str) -> tuple:
    """(env on the CPU, seeded inputs at B = 1024) of a WIDE_CASES case."""
    if case == "branched":
        env = planar.planar_env(branched_tree(specs), device="cpu")
        return env, arm_states(env, 61)
    env = planar.planar_arm_env(32, device="cpu")
    inputs = dict(planar_states(32))
    rng = np.random.default_rng(62)
    shift = np.zeros((B, CYLINDERS, 3), np.float32)
    mag = rng.uniform(0.8, 1.2, (B, CYLINDERS - 1))
    ang = rng.uniform(0.0, 2.0 * np.pi, (B, CYLINDERS - 1))
    shift[:, 1:, 0], shift[:, 1:, 1] = mag * np.cos(ang), mag * np.sin(ang)
    inputs["obs_p0"] = (inputs["obs_p0"] + shift).astype(np.float32)
    inputs["obs_p1"] = (inputs["obs_p1"] + shift).astype(np.float32)
    inputs["obs_r"] = np.repeat(inputs["obs_r"], CYLINDERS, axis=1)
    return env, inputs


@pytest.mark.parametrize("case", WIDE_CASES)
def test_wide_layout_fused_qdd_is_the_batched_step_qdd(case):
    """As test_planar_fused_qdd_is_the_batched_step_qdd past 16 links, on
    the first SMALL envs of each WIDE_CASES layout."""
    env, inputs = wide_case(case)
    small = {k: v[:SMALL] for k, v in inputs.items()}
    tick = cuda_tick.fused_tick(env)
    assert cuda_tick.wide(tick)
    assert small["obs_r"].shape[1] == (1 if case == "branched" else CYLINDERS)
    args = [torch.tensor(small[k]) for k in INPUTS]
    got = cuda_tick.make_fused_qdd(env)(*args).double().numpy()
    hold_to_the_step(got, *batched_step(env, small), case, True)


def test_branched_plain_matches_jax_kernel_body():
    """K5's plain version on the branched tree against JAX's kernel body on
    the same tree built from the JAX package's specs and policies
    (jax_planar_env on it), screened as the planar arms are."""
    env, inputs = wide_case("branched")
    hold_to_jax(jax_planar_env(0, branched_tree(jspecs)), env, inputs,
                "branched", lambda: batched_step(env, inputs)[0])


def test_k5_raises_past_its_capacity():
    """Past 32 motors (and 40 frames, 40 collision frames) the wrapper
    raises before any launch (meta tensors stand in for a device here), as
    it does for any other limit; from 17 motors (or 17 frames) up to them
    it takes the warp-per-env kernel."""
    env = planar.planar_arm_env(33, device="cpu")
    fn = cuda_tick.make_fused_qdd(env)
    args = [torch.zeros(4, 33), torch.zeros(4, 33), torch.zeros(4, 3),
            torch.zeros(4, 1, 3), torch.ones(4, 1, 3), torch.ones(4, 1)]
    with pytest.raises(ValueError, match="exceeds the K5 kernel's capacity"):
        fn(*(a.to("meta") for a in args))
    assert (cuda_tick.MAX_N, cuda_tick.MAX_FRAMES,
            cuda_tick.MAX_COLLISION) == (32, 40, 40)
    assert cuda_tick.NARROW == (16, 16, 16)
    picks = {n: cuda_tick.wide(cuda_tick.fused_tick(
        planar.planar_arm_env(n, device="cpu"))) for n in (12, 15, 16, 32)}
    # 15 links: 16 frames and collision frames; 16 links: 17 of each
    assert picks == {12: False, 15: False, 16: True, 32: True}


# primitives of a jaxpr that move data and compute nothing
LAYOUT = {"convert_element_type", "broadcast_in_dim", "slice", "squeeze"}


def jaxpr_ops(jaxpr, counts: collections.Counter) -> collections.Counter:
    """Arithmetic equations of `jaxpr`, nested jits (jnp.where, jnp.clip)
    included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ("jit", "pjit"):
            jaxpr_ops(eqn.params["jaxpr"].jaxpr, counts)
        elif eqn.primitive.name not in LAYOUT:
            counts[eqn.primitive.name] += 1
    return counts


@pytest.mark.parametrize("K", (None, 2))
@pytest.mark.parametrize("scene", SCENES)
def test_operation_count_is_the_jax_bodys(scene, K):
    """tick_ops counts, without JAX, exactly the arithmetic that JAX's K5
    body runs per env after its trace-time constant folding: the
    equations of its jaxpr at the scene's K and at K = 2."""
    jenv = jenvs.make(scene)
    K = K or jenv.reset(jax.random.PRNGKey(0)).sim.obstacles.count
    n = jenv.model.n_q
    kernel = jpt._make_kernel(jenv.model, jenv, 1e-6)
    tile = (1, jpt.SUBLANES, jpt.LANES)

    def body(*refs):
        out = {}
        kernel(*refs, out)
        return [out[i, 0] for i in range(n)]
    refs = [jnp.zeros(s + tile, jnp.float32) for s in
            ((n,), (n,), (3,), (K, 3), (K, 3), (K,))]
    want = jaxpr_ops(jax.make_jaxpr(body)(*refs).jaxpr, collections.Counter())
    tick = cuda_tick.fused_tick(envs.make(scene, device="cpu"))
    total, mirrored = tick_ops.fused_qdd_ops(tick, K)
    print(f"{scene}, K = {K}: {total} operations per env, {mirrored} of "
          f"them on A's mirrored upper triangle; jaxpr {dict(want)}")
    assert total == sum(want.values())
    assert 0 < mirrored < want["add"] + want["mul"]


@pytest.mark.parametrize("n_links", PLANAR)
def test_planar_operation_count_is_the_jax_bodys(n_links):
    """tick_ops' count on the planar arms, where K5's bound reads it in
    chip_smoke.py phase 18: the arithmetic equations of JAX's K5 body's
    jaxpr at n = 5 and 12, K = 1."""
    jenv = jax_planar_env(n_links)
    kernel = jpt._make_kernel(jenv.model, jenv, 1e-6)
    tile = (1, jpt.SUBLANES, jpt.LANES)
    n = n_links

    def body(*refs):
        out = {}
        kernel(*refs, out)
        return [out[i, 0] for i in range(n)]
    refs = [jnp.zeros(s + tile, jnp.float32) for s in
            ((n,), (n,), (3,), (1, 3), (1, 3), (1,))]
    want = jaxpr_ops(jax.make_jaxpr(body)(*refs).jaxpr, collections.Counter())
    tick = cuda_tick.fused_tick(planar.planar_arm_env(n_links, "cpu"))
    total, mirrored = tick_ops.fused_qdd_ops(tick, 1)
    assert total == sum(want.values())
    assert 0 < mirrored < want["add"] + want["mul"]


def test_wrapper_takes_the_plain_version_on_the_cpu_and_checks_inputs():
    scene = SCENES[1]
    env = envs.make(scene, device="cpu")
    fn = cuda_tick.make_fused_qdd(env)
    args = [torch.tensor(states(scene, False)[k][:8]) for k in INPUTS]
    before = cuda_tick.fused_qdd.launches
    got = fn(*args)
    assert got.shape == (8, 9) and cuda_tick.fused_qdd.launches == before
    want = cuda_tick.fused_qdd_plain(cuda_tick.fused_tick(env), *args)
    assert torch.equal(got, want)
    with pytest.raises(TypeError, match="float32"):
        fn(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="goal"):
        fn(*args[:2], args[2][:, :2], *args[3:])
    with pytest.raises(ValueError, match="no K5 kernel"):
        fn(*(a.to("meta") for a in args))


def test_constants_are_folded_in_float64_and_rounded_once():
    tick = cuda_tick.fused_tick(envs.make(SCENES[0], device="cpu"))
    c = tick.consts
    assert c.dtype == np.float32
    assert c[cuda_tick.ATT_SOFT] == np.float32(0.075 / 10.0)
    assert c[cuda_tick.ATT_ONE_MINUS_MIN_ALPHA] == np.float32(1.0 - 0.03)
    assert c[cuda_tick.OBS_RMOD_SQ] == np.float32(0.5 * 0.5)
    kinds = [k for k, _ in tick.identity]
    assert kinds == [cuda_tick.VELCAP, cuda_tick.DAMPING, cuda_tick.CSPACE]
    o = dict((k, o) for k, o in tick.identity)
    assert c[o[cuda_tick.VELCAP]] == np.float32(0.5 - 0.15)
    assert c[o[cuda_tick.VELCAP] + 2] == np.float32(0.15 - 1e-6)
    assert c[o[cuda_tick.CSPACE] + 3] == np.float32(0.005 + 0.0001)
    assert tick.caps.shape == (10, 7)


def test_scene05_reset_matches_jax():
    jenv = jenvs.make(SCENES[1])
    jstate = jenvs.make_batched_reset(jenv, 4)(jax.random.PRNGKey(0))
    state = envs.make_batched_reset(envs.make(SCENES[1], device="cpu"), 4)()
    np.testing.assert_array_equal(state.sim.q.numpy(), np.asarray(jstate.sim.q))
    np.testing.assert_array_equal(state.sim.goal.numpy(),
                                  np.asarray(jstate.sim.goal))
    for name in ("p0", "p1", "radius"):
        np.testing.assert_allclose(
            getattr(state.sim.obstacles, name).numpy(),
            np.asarray(getattr(jstate.sim.obstacles, name)), atol=1e-7)


def test_scene05_tick_parity_with_jax_rollout():
    """Scene 05 through the port's batched rollout (capsule tier, plain
    kernels) against rmp_tpu's, 8 perturbed envs x 5 ticks, with the
    tolerances of the flagship's test in test_torch_envs.py."""
    T = 5
    rng = np.random.default_rng(41)
    jenv = jenvs.make(SCENES[1])
    jenv.resolve_method = "solve"
    start = jenvs.make_batched_reset(jenv, 8)(jax.random.PRNGKey(0))
    q = (np.asarray(start.sim.q)
         + rng.uniform(-0.1, 0.1, (8, 9))).astype(np.float32)
    qd = rng.uniform(-0.05, 0.05, (8, 9)).astype(np.float32)
    start = dataclasses.replace(start, sim=dataclasses.replace(
        start.sim, q=jnp.asarray(q), qd=jnp.asarray(qd)))
    params = jenv.gather_params()
    jfinal, jaux = jax.jit(jenvs.make_batched_rollout(jenv, T))(start, params)

    env = envs.make(SCENES[1], device="cpu")
    env.resolve_method = "solve"
    tstate = convert.state_from_numpy(
        jax.tree.map(np.asarray, jax_state_leaves(start)), "cpu")
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu")
    final, aux = envs.make_batched_rollout(env, T)(tstate, tparams)
    qdd_err = np.abs(aux["qdd"][:, 0].numpy()
                     - np.asarray(jaux["qdd"])[:, 0]).max()
    assert qdd_err < 2e-3, f"first-tick q̈ divergence {qdd_err}"
    q_err = np.abs(final.sim.q.numpy() - np.asarray(jfinal.sim.q)).max()
    assert q_err < 5e-4, f"q divergence after {T} ticks: {q_err}"
    for name in ("steps", "solved_count", "phase"):
        np.testing.assert_array_equal(getattr(final, name).numpy(),
                                      np.asarray(getattr(jfinal, name)))


@pytest.mark.slow
def test_kernel_body_shim_matches_pallas_interpret():
    """The eager shim against JAX's real make_fused_qdd under
    force_tpu_interpret_mode (~3 min on the CPU; outside tier-1). The
    interpret run jits the body, and XLA rewrites and fuses its arithmetic,
    so the two part by rounding (1.2e-5 x max(1, |q̈|) near the ready
    pose)."""
    from jax.experimental.pallas import tpu as pltpu

    scene = SCENES[0]
    inputs = states(scene, False)
    fused = jpt.make_fused_qdd(jenvs.make(scene))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused(*(jnp.asarray(inputs[k]) for k in INPUTS)))
    got = jax_out(scene, False)
    err = np.abs(got - want).max(axis=1) / scale(want)
    print(f"shim vs interpret mode: max rel err {err.max():.3e}")
    assert err.max() <= TOL
