"""The port's batched flagship rollout against the JAX package: tick parity,
the committed golden trajectory, the default device, and the port's
independence from JAX."""
import ast
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu import envs as jenvs
from rmp_tpu_torch import convert, envs

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = "franka/06_cluttered_environment"
GOLDEN6 = os.path.join(ROOT, "tests", "golden",
                       "franka06_cluttered_trajectory.npz")


def jax_state_leaves(state):
    obs = state.sim.obstacles
    return dict(q=state.sim.q, qd=state.sim.qd, t=state.sim.t,
                goal=state.sim.goal, steps=state.steps,
                solved_count=state.solved_count, phase=state.phase,
                goal_best=state.goal_best, no_progress=state.no_progress,
                obstacles=dict(p0=obs.p0, p1=obs.p1, radius=obs.radius,
                               kinds=obs.kinds))


def test_tick_parity_with_jax_rollout():
    """8 perturbed reset states carried across: 5 ticks of the port's
    rollout (CPU, plain kernels) against the JAX batched rollout with
    resolve 'solve'. The moves stay near the ready pose (q ± 0.1,
    q̇ ± 0.05), where every env is well conditioned; wider moves are held
    env by env in test_torch_conditioning.py."""
    B, T = 8, 5
    rng = np.random.default_rng(31)
    jenv = jenvs.make(SCENE)
    jenv.resolve_method = "solve"
    states = jenvs.make_batched_reset(jenv, B)(jax.random.PRNGKey(0))
    q = (np.asarray(states.sim.q)
         + rng.uniform(-0.1, 0.1, (B, 9))).astype(np.float32)
    qd = rng.uniform(-0.05, 0.05, (B, 9)).astype(np.float32)
    states = dataclasses.replace(states, sim=dataclasses.replace(
        states.sim, q=jnp.asarray(q), qd=jnp.asarray(qd)))
    params = jenv.gather_params()
    jfinal, jaux = jax.jit(jenvs.make_batched_rollout(jenv, T))(states, params)

    env = envs.make(SCENE, device="cpu")
    env.resolve_method = "solve"
    tstate = convert.state_from_numpy(
        jax.tree.map(np.asarray, jax_state_leaves(states)), "cpu")
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
    np.testing.assert_allclose(final.sim.goal.numpy(),
                               np.asarray(jfinal.sim.goal), atol=0)


def test_golden_cluttered_trajectory():
    """tests/golden/franka06_cluttered_trajectory.npz through the port's
    batched path at B = 1, no resampling, with the tolerances of
    tests/test_golden.py (the fixture was made with resolve 'pinv'; on an
    invertible metric 'solve' agrees to fp32)."""
    data = np.load(GOLDEN6)
    q_gold, qdd_gold = data["q"], data["qdd"]
    env = envs.make(SCENE, device="cpu")
    env.resolve_method = "solve"
    env.on_solved = None
    state = envs.make_batched_reset(env, 1)()
    np.testing.assert_allclose(state.sim.goal[0].numpy(), data["goal"], atol=0)
    step = envs.make_batched_control_step(env)
    params = env.gather_params()
    traj, qdd_err0 = [state.sim.q[0].numpy()], None
    T = qdd_gold.shape[0]
    for _ in range(T):
        state, aux = step(state, params)
        if qdd_err0 is None:
            qdd_err0 = np.abs(aux["qdd"][0].numpy() - qdd_gold[0]).max()
        traj.append(state.sim.q[0].numpy())
    traj = np.stack(traj)
    assert qdd_err0 < 2e-3, f"first-command divergence {qdd_err0}"
    err_half = np.abs(traj[:T // 2] - q_gold[:T // 2]).max()
    assert err_half < 5e-3, f"early divergence {err_half}"
    err = np.abs(traj - q_gold).max()
    assert err < 2e-2, f"cluttered golden divergence {err}"


@pytest.mark.parametrize("method", ["pinv", "cholesky"])
def test_batched_step_honours_resolve_method(method):
    """Non-'solve' methods take the einsum + core.resolve branch and solve
    the same (positive definite, at the reset pose) system as K1."""
    env = envs.make(SCENE, device="cpu")
    states = envs.make_batched_reset(env, 2)()
    params = env.gather_params()
    env.resolve_method = "solve"
    _, want = envs.make_batched_control_step(env)(states, params)
    env.resolve_method = method
    _, got = envs.make_batched_control_step(env)(states, params)
    scale = max(1.0, float(want["qdd"].abs().max()))
    # cholesky adds its 1e-6 ridge; pinv goes through an SVD
    np.testing.assert_allclose(got["qdd"].numpy(), want["qdd"].numpy(),
                               atol=1e-3 * scale)


def test_goal_event_select_reaches_nested_scratch():
    """_advance's select by the goal event recurses into EnvState.scratch:
    an on_solved that edits nested dicts and a tuple of (B, ...) tensors
    changes them on the envs that reached their goal and nowhere else, and
    a leaf it leaves alone stays the same object."""
    env = envs.make("franka/01_target_rmp_only", device="cpu")
    state = envs.make_batched_reset(env, 4)()
    ee = envs.base.ee_position(env, state.sim)
    at_goal = torch.tensor([True, False, True, False])
    sim = dataclasses.replace(state.sim, goal=torch.where(
        at_goal[:, None], ee, state.sim.goal))
    kept = torch.arange(4.0)
    state = dataclasses.replace(state, sim=sim, scratch=dict(
        timers=dict(left=torch.zeros(4, dtype=torch.int32),
                    inner=dict(wp=torch.zeros(4, 3))),
        pair=(torch.zeros(4), torch.ones(4, 2)), kept=kept))

    def on_solved(s):
        sc = s.scratch
        return dataclasses.replace(s, scratch=dict(
            sc, timers=dict(left=sc["timers"]["left"] + 7,
                            inner=dict(wp=sc["timers"]["inner"]["wp"] + 1.0)),
            pair=(sc["pair"][0] - 1.0, sc["pair"][1] * 3.0)))
    env.on_solved = on_solved
    out, aux = envs.base._advance(env, state, torch.zeros(4, 9))
    assert aux["solved"].tolist() == at_goal.tolist()
    sc = out.scratch
    assert sc["timers"]["left"].tolist() == [7, 0, 7, 0]
    assert sc["timers"]["inner"]["wp"][:, 0].tolist() == [1.0, 0, 1.0, 0]
    assert sc["pair"][0].tolist() == [-1.0, 0, -1.0, 0]
    assert sc["pair"][1][:, 1].tolist() == [3.0, 1.0, 3.0, 1.0]
    assert sc["kept"] is kept
    assert out.solved_count.tolist() == [1, 0, 1, 0]


def test_default_device_is_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        envs.make(SCENE)
    assert envs.make(SCENE, device="cpu").device == torch.device("cpu")


def test_params_from_numpy_keeps_scalars_as_floats():
    params = convert.params_from_numpy(
        [dict(goal=np.ones(3, np.float32), gain=np.asarray(0.3))], "cpu")
    assert isinstance(params[0]["gain"], float) and params[0]["gain"] == 0.3
    assert params[0]["goal"].dtype == torch.float32
    assert params[0]["goal"].shape == (3,)


def _port_files():
    pkg = os.path.join(ROOT, "rmp_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(pkg):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_no_jax_ast():
    """No module of the port imports JAX, the JAX package or a script of
    the root experiments/ (the port keeps its own copies of what it
    needs)."""
    bad = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "rmp_tpu", "flax",
                           "experiments"):
                    bad.append(f"{os.path.relpath(path, ROOT)}: {name}")
    assert not bad, bad


def test_port_imports_no_jax_subprocess():
    code = (
        "import sys\n"
        "import rmp_tpu_torch, rmp_tpu_torch.envs, rmp_tpu_torch.convert\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'rmp_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
