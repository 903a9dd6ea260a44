"""The port's sweep tools (rmp_tpu_torch/experiments/sweep_randomized.py,
sweep_escape.py) on the CPU: a fold of G = 2 gain configs (envs.base.
fold_batch, per-env gains) equals the two configs run apart, draws
included; the sweep CLI's hard error on a key that matches no params
(tests/test_subsystems.py's contract); sweep_escape's pairing (every config
from the same reset and the same stream state)."""
import dataclasses
import os
import subprocess
import sys

import torch

from rmp_tpu_torch import envs
from rmp_tpu_torch.envs.base import fold_batch
from rmp_tpu_torch.experiments import sweep_escape, sweep_randomized
from rmp_tpu_torch.utils.checkpoint import _leaves

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
SCENE = "franka/randomized_cluttered"
B, TICKS = 4, 12
# the solved check widened so that goals are reached, and resampled from
# the stream, inside the short run
TOL = 0.5


def scene():
    env = envs.make(SCENE, device="cpu")
    env.solved_tol = TOL
    return env


def test_fold_of_two_configs_equals_two_runs():
    """G = 2 configs of the attractor's p gain folded into 2 B envs (copies
    of one reset drawing the same rows of one stream) equal each config's
    own run of B envs bit for bit, resamples included: a gain read as a
    Python number, or draws that differ per copy, would break it."""
    env = scene()
    axes = sweep_randomized.parse_axes(["accel_p_gain=0.3,2.5"])
    grid = [(0.3,), (2.5,)]
    params, dead = sweep_randomized.folded_params(env, axes, grid, B, "cpu")
    assert dead == []
    states = fold_batch(envs.make_batched_reset(env, B, 3)(), 2)
    rollout = envs.make_batched_rollout(env, TICKS)
    with torch.no_grad():
        final, aux = rollout(states, params)
    assert int(aux["resample"].sum()) > 0
    for g, (gain,) in enumerate(grid):
        alone, _ = sweep_randomized.folded_params(env, axes, [(gain,)], B,
                                                  "cpu")
        with torch.no_grad():
            want, want_aux = rollout(envs.make_batched_reset(env, B, 3)(),
                                     alone)
        rows = slice(g * B, (g + 1) * B)
        assert torch.equal(aux["resample"][rows], want_aux["resample"])
        for got_leaf, want_leaf in zip(_leaves(final), _leaves(want)):
            if isinstance(want_leaf, torch.Tensor):
                assert torch.equal(got_leaf[rows], want_leaf)
    # the whole sweep's report: one row per config, its rates in [0, 1]
    rep = sweep_randomized.sweep(SCENE, axes, B, 3, 3, "cpu")
    assert sorted(r["accel_p_gain"] for r in rep["results"]) == [0.3, 2.5]
    assert all(0.0 <= r["success"] <= 1.0 for r in rep["results"])


def test_fold_rejects_a_rank_slice():
    env = scene()
    states = envs.make_batched_reset(env, B)()
    sliced = dataclasses.replace(states, rng_size=2 * B, rng_offset=B)
    try:
        fold_batch(sliced, 2)
        raise AssertionError("a slice was folded")
    except ValueError:
        pass


def test_sweep_cli_rejects_unknown_gain_keys():
    """The CLI hard-errors on --set keys that match no policy params (a
    typo'd key would sweep nothing), naming the key and the keys there
    are."""
    out = subprocess.run(
        [sys.executable, "-m", "rmp_tpu_torch.experiments.sweep_randomized",
         "--cpu", "--set", "attractor_p_gain=0.3,2.5"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert "attractor_p_gain" in out.stderr and "accel_p_gain" in out.stderr


def test_sweep_escape_pairs_every_config():
    """Every config starts from the same reset and the same state of the
    stream: two configs with the same overrides give the same report, the
    reset's generator is left where it was, and an override lands on
    every env."""
    env = scene()
    states0 = envs.make_batched_reset(env, B, 2)()
    before = states0.rng.get_state()
    a = sweep_escape.configured(states0, dict(man_budget=1.0))
    b = sweep_escape.configured(states0, {})
    assert torch.equal(a.rng.get_state(), before)
    assert torch.equal(b.rng.get_state(), before)
    assert a.rng is not states0.rng and a.rng is not b.rng
    assert (a.scratch["cfg"]["man_budget"] == 1.0).all()
    rollout = envs.make_batched_rollout(env, TICKS)
    with torch.no_grad():
        fa, _ = rollout(a, env.gather_params())
        fb, _ = rollout(sweep_escape.configured(states0,
                                                dict(man_budget=1.0)),
                        env.gather_params())
    assert torch.equal(states0.rng.get_state(), before)
    assert torch.equal(fa.sim.q, fb.sim.q)
    assert torch.equal(fa.sim.goal, fb.sim.goal)
    configs = dict(sweep_escape.CONFIGS[SCENE])
    sweep_escape.CONFIGS[SCENE]["again"] = configs["first_b1"]
    try:
        rep = sweep_escape.sweep(SCENE, B, 3, 2, "cpu",
                                 names=["first_b1", "again"], log=print)
    finally:
        sweep_escape.CONFIGS[SCENE] = configs
    g = rep["groups"]
    assert {k: v for k, v in g["first_b1"].items() if k != "wall_s"} == \
        {k: v for k, v in g["again"].items() if k != "wall_s"}
