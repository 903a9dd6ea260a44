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
from rmp_tpu.ops import pallas_tick as jpt
from rmp_tpu_torch import convert, envs
from rmp_tpu_torch.ops import cuda_tick, tick_ops
from test_torch_envs import jax_state_leaves

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
