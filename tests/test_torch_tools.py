"""The port's entry points (rmp_tpu_torch/experiments/: evaluate, latency,
soak, run) held to the JAX tools' report contracts
(tests/test_subsystems.py), and `sim.randomizer.SceneRandomizer` to the
JAX package's ranges and shapes. Everything runs on the CPU (--cpu,
device='cpu'), at tiny batches."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rmp_tpu import envs as jenvs
from rmp_tpu_torch import envs
from rmp_tpu_torch.experiments import common, latency, run, soak
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.sim.randomizer import SceneRandomizer

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
REPORT_KEYS = {"env", "geometry", "batch", "ticks", "success_rate",
               "goal_feasible_rate", "first_goal_success_rate",
               "success_rate_feasible_goals", "goals_reached_mean",
               "goals_reached_max", "final_penetration_rate", "nan_rate",
               "control_steps_per_sec", "wall_seconds"}
RATES = ("success_rate", "goal_feasible_rate", "first_goal_success_rate",
         "success_rate_feasible_goals", "final_penetration_rate", "nan_rate")


def module(name: str, *args: str, timeout: int = 600):
    """`python -m rmp_tpu_torch.experiments.<name> args` from the repo."""
    return subprocess.run(
        [sys.executable, "-m", f"rmp_tpu_torch.experiments.{name}", *args],
        capture_output=True, text=True, cwd=ROOT, timeout=timeout)


@pytest.mark.parametrize("scene,batch,ticks", [
    ("franka/randomized_cluttered", 8, 5),
    # the multi-goal (2, 3) feasibility path of the JAX tool's own test
    ("dual_panda/randomized_clutter", 2, 2)])
def test_evaluate_report_contract(scene, batch, ticks):
    out = module("evaluate", "--env", scene, "--cpu", "--batch", str(batch),
                 "--ticks", str(ticks))
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout)
    assert REPORT_KEYS <= set(r), REPORT_KEYS - set(r)
    assert (r["env"], r["batch"], r["ticks"]) == (scene, batch, ticks)
    assert r["device"] == "cpu"
    assert r["nan_rate"] == 0.0
    for k in RATES:
        assert r[k] is not None and 0.0 <= r[k] <= 1.0, k
    assert r["control_steps_per_sec"] > 0 and r["wall_seconds"] >= 0


def test_latency_report_contract():
    """latency.measure's report (tests/test_subsystems.py's contract)."""
    rep = latency.measure("two_joint/01_target_rmp_only", [2], ticks=3,
                          geometry="capsule", device="cpu")
    assert rep["platform"] == "cpu"
    assert rep["control_period_s"] > 0
    (pt,) = rep["points"]
    assert pt["batch"] == 2 and not pt["fused_resolve"]
    for k in ("p50_ms", "p90_ms", "p99_ms", "realtime_factor_p50",
              "control_rate_hz_p50", "batched_steps_per_sec_p50"):
        assert pt[k] > 0, k
    assert pt["p50_ms"] <= pt["p90_ms"] <= pt["p99_ms"]


def test_soak_report_and_its_place(tmp_path):
    """The soak's report at 8 envs x 20 ticks in chunks of 10: every q
    finite and within limits, the per-chunk series; written to --out, and
    by default to chiprun_out/, never to reports/."""
    out = tmp_path / "soak.json"
    res = module("soak", "--cpu", "--batch", "8", "--ticks", "20", "--chunk",
                 "10", "--out", str(out))
    assert res.returncode == 0, res.stderr[-2000:]
    with open(out) as f:
        r = json.load(f)
    assert r == json.loads(res.stdout)
    assert (r["batch"], r["ticks"]) == (8, 20)
    assert r["all_finite"] and r["always_in_limits"]
    assert len(r["solve_events_per_chunk"]) == 2
    assert [c["tick"] for c in r["checkpoints"]] == [10, 20]
    assert 0.0 <= r["final_max_abs_qd"] <= r["max_abs_qd_overall"]
    default = common.report_path("soak_franka_06_cluttered_environment.json")
    assert os.path.dirname(default) == os.path.abspath(
        os.path.join(ROOT, "chiprun_out"))


def test_reports_are_never_overwritten():
    """A tool refuses a report path under reports/ and an existing file of
    the repository outside chiprun_out/."""
    for path in (os.path.join(ROOT, "reports", "latency.json"),
                 os.path.join(ROOT, "reports", "new_report.json"),
                 os.path.join(ROOT, "README.md")):
        with pytest.raises(ValueError):
            common.report_path("x.json", path)


def test_run_lists_the_registry(capsys):
    run.main(["--list"])
    assert capsys.readouterr().out.split() == sorted(jenvs.REGISTRY)


def test_run_saves_jax_trajectory_keys_and_the_control_step(tmp_path):
    """`run franka/01 --cpu --ticks 5 --save` writes the JAX tool's npz
    keys and shapes (its own run on the same flags), and its final q is
    make_control_step's after 5 ticks from the same reset."""
    ours, theirs = tmp_path / "port.npz", tmp_path / "jax.npz"
    res = module("run", "franka/01_target_rmp_only", "--cpu", "--ticks", "5",
                 "--save", str(ours))
    assert res.returncode == 0, res.stderr[-2000:]
    jres = subprocess.run(
        [sys.executable, os.path.join(ROOT, "experiments", "run.py"),
         "franka/01_target_rmp_only", "--cpu", "--ticks", "5", "--save",
         str(theirs)], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert jres.returncode == 0, jres.stderr[-2000:]
    got, want = np.load(ours), np.load(theirs)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].shape == want[k].shape, k
    np.testing.assert_array_equal(got["t"], want["t"])
    env = envs.make("franka/01_target_rmp_only", device="cpu")
    state = env.reset(1, 0)
    step = envs.make_control_step(env)
    for _ in range(5):
        state, _ = step(state, env.gather_params())
    np.testing.assert_array_equal(got["q"][-1], state.sim.q[0].numpy())
    np.testing.assert_allclose(got["q"], want["q"], atol=1e-3)


def test_run_gif_raises(tmp_path, capsys):
    """`run --gif`, which raised NotImplementedError until the renderers
    were ported, writes a frame of every second tick to a GIF (the native
    ray tracer where a C++ compiler is there)."""
    from PIL import Image
    path = str(tmp_path / "run.gif")
    run.main(["franka/01_target_rmp_only", "--cpu", "--ticks", "5",
              "--gif", path])
    assert Image.open(path).n_frames == 3
    assert "3 frames, native renderer" in capsys.readouterr().out


def test_scene_randomizer_ranges_and_shapes():
    """tests/test_subsystems.py's SceneRandomizer checks on the port's."""
    r = SceneRandomizer(seed=1, device="cpu")
    obs = r.randomize_obstacles(5)
    assert obs.count == 5 and obs.p0.shape == (5, 3)
    centers = 0.5 * (obs.p0 + obs.p1).numpy()
    radii_xy = np.linalg.norm(centers[:, :2], axis=-1)
    assert np.all(radii_xy >= 0.4 - 1e-6) and np.all(radii_xy <= 0.9 + 1e-6)
    assert np.all(obs.radius.numpy() >= 0.05)
    assert np.all(obs.radius.numpy() <= 0.1)
    q, qd = r.randomize_robot_config()
    np.testing.assert_allclose(q.numpy(), robots.PANDA_Q_READY, atol=0.11)
    assert np.max(np.abs(qd.numpy())) <= 0.005
    goal = r.randomize_goal().numpy()
    assert goal.shape == (3,)
    assert 0.4 <= np.linalg.norm(goal[:2]) <= 0.9
    # successive draws differ; the same seed repeats them
    assert not torch.equal(r.randomize_goal(), r.randomize_goal())
    again = SceneRandomizer(seed=1, device="cpu")
    assert torch.equal(again.randomize_obstacles(5).p0, obs.p0)
