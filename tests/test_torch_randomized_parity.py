"""Tick parity of franka/randomized_cluttered with the JAX package, from
the JAX package's reset states carried across by `convert`: 60 ticks at
B = 16 through the port's batched rollout and its per-env semantics
(make_control_step) against JAX's rollout, and 5 ticks of the hull tier.

The scene is chaotic in float32: fast motion (velocity cap 0.8 with its
clip, max_qdd 100) and spawns in penetration turn a one-ulp move of the
start into up to ~1.8 rad in q within 60 ticks on some envs, as far as the
two packages part there. So each (env, tick) is compared while two screens
of the port's own run hold, as chip_smoke.witness_q screens the GPU/CPU
parity: the port in float64 (plain versions of the kernels) and the port
from a start moved by one ulp stay within STABLE of it. Each env is
compared up to the tick before its first trigger or resample event in any
run (after one, the runs' random draws differ). The hull tier's 5 ticks
hold every env to a bound scaled by its rounding moves instead."""
import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

from rmp_tpu import envs as jenvs
from rmp_tpu_torch import convert, core, envs
from rmp_tpu_torch.envs import base, franka
from rmp_tpu_torch.models.fk_derivatives import fk_derivatives
from rmp_tpu_torch.ops import cuda_gjk
from rmp_tpu_torch.ops.cuda_resolve import pullback_resolve_structured_plain
from rmp_tpu_torch.sim import collision
from test_torch_conditioning import _to
from test_torch_randomized import SCENE, jax_leaves

torch.set_num_threads(1)

B, T = 16, 60
HULL_B, HULL_T = 8, 5
Q_TOL = 5e-4         # tests/test_torch_scenes.py's tolerances
QDD_TOL = 2e-3
STABLE = 1e-5        # a screen keeps an (env, tick) while it moves less
KEPT_SHARE = 0.3     # least share of the window's (env, tick) pairs kept
SPREAD = 5.0         # an env may part from JAX by SPREAD x its rounding move
FIELDS = ("no_progress", "man_ticks", "man_count", "push_on")


@contextlib.contextmanager
def plain_float64():
    """The kernel wrappers (float32 only) replaced by their plain versions,
    which run in float64."""
    hull_table = collision.hull_table
    patches = ((core, "fk_derivatives_batched", fk_derivatives),
               (franka, "fk_derivatives_batched", fk_derivatives),
               (base, "pullback_resolve_structured",
                pullback_resolve_structured_plain),
               (collision, "gjk_hull_obstacles",
                cuda_gjk.gjk_hull_obstacles_plain),
               (collision, "hull_table",
                lambda model, dev: hull_table(model, dev).double()))
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    try:
        for m, n, fn in patches:
            setattr(m, n, fn)
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def _record(state, aux) -> dict:
    sc = state.scratch
    return dict(q=state.sim.q.double().numpy(),
                goal_best=state.goal_best.double().numpy(),
                no_progress=state.no_progress.numpy(),
                man_ticks=sc["man_ticks"].numpy(),
                man_count=sc["man_count"].numpy(),
                push_on=sc["push_on"].numpy(),
                resample=aux["resample"].numpy(), qdd=aux["qdd"].numpy())


def port_run(start: dict, params, ticks: int, per_env: bool = False,
             float64: bool = False, ulp: bool = False,
             geometry: str = "capsule") -> list:
    """Per-tick records of the port's run from the numpy leaves `start`."""
    env = envs.make(SCENE, device="cpu")
    env.collision_geometry = geometry
    state = convert.state_from_numpy(start, "cpu")
    if ulp:
        up = torch.tensor(float("inf"))
        state = dataclasses.replace(state, sim=dataclasses.replace(
            state.sim, q=torch.nextafter(state.sim.q, up),
            qd=torch.nextafter(state.sim.qd, up)))
    if float64:
        state = _to(state, torch.float64)
        params = tuple(_to(p, torch.float64) for p in params)
    step = (envs.make_control_step if per_env
            else envs.make_batched_control_step)(env)
    out = []
    with plain_float64() if float64 else contextlib.nullcontext():
        for _ in range(ticks):
            state, aux = step(state, params)
            out.append(_record(state, aux))
    return out


def jax_run(jenv, states, params, ticks: int) -> list:
    step = jax.jit(jax.vmap(jenvs.make_control_step(jenv), in_axes=(0, None)))
    out = []
    for _ in range(ticks):
        states, aux = step(states, params)
        sc = states.scratch
        rec = jax.tree.map(np.asarray, dict(
            q=states.sim.q, goal_best=states.goal_best,
            no_progress=states.no_progress, man_ticks=sc["man_ticks"],
            man_count=sc["man_count"], push_on=sc["push_on"],
            resample=aux["resample"], qdd=aux["qdd"]))
        out.append(dict(rec, q=rec["q"].astype(np.float64)))
    return out


def first_events(runs, start_count) -> np.ndarray:
    """(B,) the first tick with a trigger (the detour count rises) or a
    resample event, in any run; the tick count where none comes."""
    n = start_count.shape[0]
    first = np.full(n, len(runs[0]))
    for run in runs:
        prev = start_count
        for t, rec in enumerate(run):
            hit = rec["resample"] | (rec["man_count"] > prev)
            first = np.where(hit & (first > t), t, first)
            prev = rec["man_count"]
    return first


def q_gap(a, b) -> np.ndarray:
    """(T, B) max |Δq| per tick and env."""
    return np.stack([np.abs(x["q"] - y["q"]).max(axis=1)
                     for x, y in zip(a, b)])


def kept_pairs(runs: dict, first: np.ndarray) -> np.ndarray:
    """(T, B) bool: ticks before the env's first event at which the
    float64 and the one-ulp runs have stayed within STABLE of the port's
    float32 run so far."""
    moved = np.maximum.accumulate(np.maximum(
        q_gap(runs["port"], runs["float64"]),
        q_gap(runs["port"], runs["ulp"])), axis=0)
    ticks = np.arange(len(runs["port"]))[:, None]
    return (ticks < first[None]) & (moved <= STABLE)


@pytest.fixture(scope="module")
def capsule_runs():
    jenv = jenvs.make(SCENE)
    states = jenvs.make_batched_reset(jenv, B)(jax.random.PRNGKey(0))
    params = jenv.gather_params()
    start = jax_leaves(states)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu")
    runs = dict(jax=jax_run(jenv, states, params, T),
                port=port_run(start, tparams, T),
                per_env=port_run(start, tparams, T, per_env=True),
                float64=port_run(start, tparams, T, float64=True),
                ulp=port_run(start, tparams, T, ulp=True))
    first = first_events(list(runs.values()),
                         start["scratch"]["man_count"])
    return runs, first, kept_pairs(runs, first)


def assert_parity(runs, name, first, keep):
    """On the kept (env, tick) pairs: q within Q_TOL, the stall count, the
    detour timer and count and the push latch equal, goal_best within
    Q_TOL; the first tick's q̈ of the kept envs within QDD_TOL x
    max(1, |q̈|)."""
    window = np.arange(len(runs["port"]))[:, None] < first[None]
    assert keep.sum() >= KEPT_SHARE * window.sum(), (keep.sum(),
                                                     window.sum())
    gap = q_gap(runs["jax"], runs[name])
    assert gap[keep].max() <= Q_TOL, gap[keep].max()
    for t, (j, p) in enumerate(zip(runs["jax"], runs[name])):
        k = keep[t]
        for field in FIELDS:
            np.testing.assert_array_equal(p[field][k], j[field][k],
                                          err_msg=f"{field} at tick {t}")
        finite = k & np.isfinite(j["goal_best"])
        np.testing.assert_array_equal(np.isfinite(p["goal_best"][k]),
                                      np.isfinite(j["goal_best"][k]))
        np.testing.assert_allclose(p["goal_best"][finite],
                                   j["goal_best"][finite], atol=Q_TOL)
    k0 = keep[0]
    want = runs["jax"][0]["qdd"][k0]
    err = np.abs(runs[name][0]["qdd"][k0] - want).max(axis=1)
    assert (err <= QDD_TOL * np.maximum(1.0, np.abs(want).max(axis=1))).all()


def test_batched_tick_parity_with_jax(capsule_runs):
    """The port's batched rollout (K1's and K3's plain versions on the
    CPU) against JAX's, 60 ticks at B = 16."""
    runs, first, keep = capsule_runs
    assert (first < T).any() and keep.any(axis=0).sum() >= B // 2
    assert_parity(runs, "port", first, keep)


def test_per_env_tick_parity_with_jax(capsule_runs):
    """make_control_step (evaluate_policies and core.resolve, never K1)
    against JAX's rollout, on the batched run's screens."""
    runs, first, keep = capsule_runs
    assert_parity(runs, "per_env", first, keep)


def test_hull_tier_tick_parity_with_jax():
    """The hull tier at B = 8: the per-env semantics in both packages
    (every pair, cold, 10 GJK iterations; no warm carry), 5 ticks. Spawns
    in penetration clamp q̈ at max_qdd here within the first ticks, where
    rounding parts runs fast; so every env's gap to JAX is held to
    max(Q_TOL, SPREAD x the larger move of the float64 and one-ulp runs),
    as tests/test_torch_conditioning.py holds wide flagship states."""
    jenv = jenvs.make(SCENE)
    jenv.collision_geometry = "hull"
    states = jenvs.make_batched_reset(jenv, HULL_B)(jax.random.PRNGKey(0))
    params = jenv.gather_params()
    start = jax_leaves(states)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu")
    jfinal, jaux = jax.jit(jenvs.make_batched_rollout(jenv, HULL_T))(
        states, params)
    assert not np.asarray(jaux["resample"]).any()
    kw = dict(geometry="hull")
    runs = dict(port=port_run(start, tparams, HULL_T, **kw),
                float64=port_run(start, tparams, HULL_T, float64=True, **kw),
                ulp=port_run(start, tparams, HULL_T, ulp=True, **kw))
    assert first_events(list(runs.values()),
                        start["scratch"]["man_count"]).min() == HULL_T
    move = np.maximum(q_gap(runs["port"], runs["float64"])[-1],
                      q_gap(runs["port"], runs["ulp"])[-1])
    gap = np.abs(runs["port"][-1]["q"] - np.asarray(jfinal.sim.q)).max(1)
    assert (gap <= np.maximum(Q_TOL, SPREAD * move)).all(), (gap, move)
    assert (move <= STABLE).sum() >= HULL_B // 4, move
