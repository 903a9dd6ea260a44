"""The port's maneuver substrate (rmp_tpu_torch/envs/maneuver.py), each of
its ten functions against the JAX package's under jax.vmap, on random
per-env knobs, timers, counts and phases (numpy, seeded)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rmp_tpu.envs import maneuver as jmv
from rmp_tpu.sim import collision as jcollision
from rmp_tpu_torch.envs import maneuver as mv
from rmp_tpu_torch.envs.franka import RANDOMIZED_CFG
from rmp_tpu_torch.sim import collision

torch.set_num_threads(1)

B = 64
ATOL = 1e-6      # float32 distances of the two packages


def _cfg(rng) -> dict:
    """Per-env knobs around the shipped ones, with the branches mixed:
    man_first_only and man_arrive on and off, budgets 0-2 (0 disables)."""
    cfg = {k: np.full(B, v, np.float32) for k, v in RANDOMIZED_CFG.items()}
    cfg["man_first_only"] = rng.integers(0, 2, B).astype(np.float32)
    cfg["man_arrive"] = rng.integers(0, 2, B).astype(np.float32)
    cfg["man_budget"] = rng.integers(0, 3, B).astype(np.float32)
    cfg["man_budget_late"] = rng.integers(0, 2, B).astype(np.float32)
    cfg["man_ticks"] = rng.choice([7.0, 22.0, 22.9], B).astype(np.float32)
    cfg["push_trigger"] = rng.choice([10.0, 20.0], B).astype(np.float32)
    return cfg


def _both(cfg):
    return ({k: torch.tensor(v) for k, v in cfg.items()},
            {k: jnp.asarray(v) for k, v in cfg.items()})


def _ints(rng, high):
    x = rng.integers(0, high, B).astype(np.int32)
    return torch.tensor(x), jnp.asarray(x)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cfg_scratch_matches_jax():
    got = mv.cfg_scratch(RANDOMIZED_CFG, B, "cpu")
    want = jmv.cfg_scratch(RANDOMIZED_CFG)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == (B,)
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.full(B, np.asarray(v)))


def _obstacles(rng, K=8):
    p0 = rng.uniform(-0.8, 0.8, (B, K, 3)).astype(np.float32)
    p1 = (p0 + rng.uniform(-0.3, 0.3, (B, K, 3))).astype(np.float32)
    p1[:, 0] = p0[:, 0]                       # a sphere among the segments
    r = rng.uniform(0.01, 0.1, (B, K)).astype(np.float32)
    return (collision.ObstacleSet(*(torch.tensor(x) for x in (p0, p1, r))),
            jcollision.ObstacleSet(*(jnp.asarray(x) for x in (p0, p1, r))))


def test_point_clearance_matches_jax():
    """Per env, one point and four candidates at once (the stacked form
    score_candidates uses), with and without a seed."""
    rng = np.random.default_rng(0)
    obs, jobs = _obstacles(rng)
    p = rng.uniform(-1, 1, (B, 4, 3)).astype(np.float32)
    seed = rng.uniform(-0.1, 0.3, B).astype(np.float32)
    want = jax.vmap(jax.vmap(jmv.point_clearance, in_axes=(None, 0)))(
        jobs, jnp.asarray(p))
    got = mv.point_clearance(obs, torch.tensor(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    want = jax.vmap(jmv.point_clearance)(jobs, jnp.asarray(p[:, 0]),
                                         jnp.asarray(seed))
    got = mv.point_clearance(obs, torch.tensor(p[:, 0]), torch.tensor(seed))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_score_candidates_matches_jax_and_keeps_the_first_on_ties():
    """Four candidates scored on clearance and detour length. Envs
    [0, B/2) hold ties: candidate 1 repeats candidate 0 and candidate 3
    repeats candidate 2, so equal scores must keep the earlier one (the
    chain's strict '>'); both packages pick the same candidate everywhere."""
    rng = np.random.default_rng(1)
    obs, jobs = _obstacles(rng)
    c = rng.uniform(-0.8, 0.8, (4, B, 3)).astype(np.float32)
    half = B // 2
    c[1, :half], c[3, :half] = c[0, :half], c[2, :half]
    goal = rng.uniform(-0.8, 0.8, (B, 3)).astype(np.float32)

    def jscore(cands, g, o):
        return jmv.score_candidates(list(cands), g,
                                    lambda x: jmv.point_clearance(o, x))
    jbest, jscore_ = jax.vmap(jscore, in_axes=(1, 0, 0))(
        jnp.asarray(c), jnp.asarray(goal), jobs)
    best, score = mv.score_candidates(
        [torch.tensor(x) for x in c], torch.tensor(goal),
        lambda x: mv.point_clearance(obs, x))
    _eq(best, jbest)
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore_),
                               atol=ATOL)
    # which candidate won, per env: never a later copy of a tie
    idx = np.argmax((c == best.numpy()[None]).all(-1), axis=0)
    assert not np.isin(idx[:half], (1, 3)).any()


def test_budget_timers_and_timeouts_match_jax():
    """budget_free, maneuver_timers (arrival within and beyond the
    tolerance, triggers, man_ticks truncated to int32), spent_timeout with
    and without a phase, on every mix of the knobs; allowed == 0 (a late
    phase with man_budget_late 0 under man_first_only) takes the
    count >= man_budget rule."""
    rng = np.random.default_rng(2)
    cfg = _cfg(rng)
    tcfg, jcfg = _both(cfg)
    timer, jtimer = _ints(rng, 3)
    count, jcount = _ints(rng, 4)
    phase, jphase = _ints(rng, 2)
    trigger = rng.integers(0, 2, B).astype(bool)
    ee = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    wp_old = (ee + rng.choice([0.01, 0.2], (B, 1))
              * rng.normal(size=(B, 3))).astype(np.float32)
    wp_new = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    _eq(mv.budget_free(tcfg, timer, count, phase),
        jax.vmap(jmv.budget_free)(jcfg, jtimer, jcount, jphase))
    got = mv.maneuver_timers(tcfg, timer, count, torch.tensor(trigger),
                             torch.tensor(ee), torch.tensor(wp_old),
                             torch.tensor(wp_new), arrive_tol=0.06)
    want = jax.vmap(lambda c, t, n, tr, e, wo, wn: jmv.maneuver_timers(
        c, t, n, tr, e, wo, wn, arrive_tol=0.06))(
        jcfg, jtimer, jcount, jnp.asarray(trigger), jnp.asarray(ee),
        jnp.asarray(wp_old), jnp.asarray(wp_new))
    for g, w in zip(got, want):
        _eq(g, w)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
    _eq(mv.spent_timeout(tcfg, count, phase),
        jax.vmap(jmv.spent_timeout)(jcfg, jcount, jphase))
    _eq(mv.spent_timeout(tcfg, count),
        jax.vmap(jmv.spent_timeout)(jcfg, jcount))
    zero_late = ((cfg["man_first_only"] > 0.5) & (cfg["man_budget_late"] == 0)
                 & (phase.numpy() != 0) & (cfg["man_budget"] > 0))
    assert zero_late.sum() >= 3


def test_arm_axis_broadcasts_like_the_jax_vmap():
    """Timers, counts and points with an arm axis (B, 2, ...) and per-env
    knobs and phase (B,): the JAX functions under a vmap over envs."""
    rng = np.random.default_rng(3)
    tcfg, jcfg = _both(_cfg(rng))
    timer = rng.integers(0, 3, (B, 2)).astype(np.int32)
    count = rng.integers(0, 4, (B, 2)).astype(np.int32)
    phase, jphase = _ints(rng, 2)
    trigger = rng.integers(0, 2, (B, 2)).astype(bool)
    ee = rng.uniform(-1, 1, (B, 2, 3)).astype(np.float32)
    wp_old = (ee + 0.03).astype(np.float32)
    wp_new = rng.uniform(-1, 1, (B, 2, 3)).astype(np.float32)
    t = [torch.tensor(x) for x in (timer, count, trigger, ee, wp_old, wp_new)]
    j = [jnp.asarray(x) for x in (timer, count, trigger, ee, wp_old, wp_new)]
    _eq(mv.budget_free(tcfg, t[0], t[1], phase),
        jax.vmap(jmv.budget_free)(jcfg, j[0], j[1], jphase))
    for g, w in zip(mv.maneuver_timers(tcfg, *t, arrive_tol=0.06),
                    jax.vmap(lambda c, *a: jmv.maneuver_timers(
                        c, *a, arrive_tol=0.06))(jcfg, *j)):
        _eq(g, w)
    _eq(mv.spent_timeout(tcfg, t[1], phase),
        jax.vmap(jmv.spent_timeout)(jcfg, j[1], jphase))
    obs, jobs = _obstacles(rng)
    np.testing.assert_allclose(
        mv.point_clearance(obs, t[3]).numpy(),
        np.asarray(jax.vmap(jax.vmap(jmv.point_clearance,
                                     in_axes=(None, 0)))(jobs, j[3])),
        atol=ATOL)


def test_push_and_progress_match_jax():
    """push_engaged (goal_best +inf never engages) and freeze_progress."""
    rng = np.random.default_rng(4)
    tcfg, jcfg = _both(_cfg(rng))
    noprog, jnoprog = _ints(rng, 40)
    best = rng.choice([0.03, 0.07, 0.09, 0.5, np.inf], B).astype(np.float32)
    _eq(mv.push_engaged(tcfg, noprog, torch.tensor(best)),
        jax.vmap(jmv.push_engaged)(jcfg, jnoprog, jnp.asarray(best)))
    inf = mv.push_engaged(tcfg, torch.full((B,), 99, dtype=torch.int32),
                          torch.full((B,), float("inf")))
    assert not inf.any()

    @dataclasses.dataclass
    class S:
        no_progress: object
        goal_best: object
    trig = rng.integers(0, 2, B).astype(bool)
    timer = rng.integers(0, 2, B).astype(bool)
    got = mv.freeze_progress(S(noprog, torch.tensor(best)),
                             torch.tensor(trig), torch.tensor(timer))
    want = jax.vmap(lambda n, g, a, b: jmv.freeze_progress(
        S(n, g), a, b))(jnoprog, jnp.asarray(best), jnp.asarray(trig),
                        jnp.asarray(timer))
    for g, w in zip(got, want):
        _eq(g, w)


def test_param_scalings_match_jax():
    """scaled_attractor and relaxed_obstacle with per-env (B,) factors
    against the JAX functions vmapped over the same factors; 1.0 leaves the
    params as they are."""
    rng = np.random.default_rng(5)
    boost = rng.choice([1.0, 3.0], B).astype(np.float32)
    mscale = rng.choice([1.0, 2.0], B).astype(np.float32)
    goal = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    att = dict(accel_p_gain=2.5, accel_d_gain=1.5, max_metric_scalar=1.0,
               min_metric_scalar=0.5, accel_norm_eps=0.075)
    got = mv.scaled_attractor(att, goal=torch.tensor(goal),
                              gain_boost=torch.tensor(boost),
                              metric_scale=torch.tensor(mscale))
    want = jax.vmap(lambda g, b, m: jmv.scaled_attractor(
        att, goal=g, gain_boost=b, metric_scale=m))(
        jnp.asarray(goal), jnp.asarray(boost), jnp.asarray(mscale))
    for k in ("goal", "accel_p_gain", "accel_d_gain", "max_metric_scalar",
              "min_metric_scalar"):
        _eq(got[k], want[k])
    assert got["accel_norm_eps"] == 0.075
    assert mv.scaled_attractor(att) == att
    obs = dict(repulsion_gain=800.0, metric_scalar=1.0, margin=0.0)
    relax = rng.choice([1.0, 4.0, 10.0], (2, B)).astype(np.float32)
    got = mv.relaxed_obstacle(obs, *(torch.tensor(r) for r in relax))
    want = jax.vmap(lambda a, b: jmv.relaxed_obstacle(obs, a, b))(
        *(jnp.asarray(r) for r in relax))
    for k in ("repulsion_gain", "metric_scalar"):
        _eq(got[k], want[k])
    assert got["margin"] == 0.0
