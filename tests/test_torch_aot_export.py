"""The port's exported serving step (rmp_tpu_torch/experiments/aot_export.py)
on the CPU.

- JAX's `test_aot_export_roundtrip` on the port: two_joint/01_target_rmp_only
  at B = 4, 2 ticks a call. The saved and loaded artifact equals the eager
  `make_batched_rollout` bit for bit, on the Python-number gains and on the
  same gains as 0-d tensors, and the manifest's counts add up. The scene
  resamples its goal each tick from the env's stream, so the artifact takes
  those draws as inputs: made from the manifest's stream state, they are
  the eager rollout's.
- franka/06_cluttered_environment at B = 8, one tick: the port's artifact
  against JAX's `experiments/aot_export.export_step` artifact on the same
  converted state, q and q̇ within 5e-4, the port's 5-tick parity
  tolerance (tests/test_torch_envs.py::test_tick_parity_with_jax_rollout);
  its graph holds K1's and K3's ops.
- The artifact loads and runs in a process that imports torch and the ops
  module only (rmp_tpu_torch.envs never imported), to the same outputs.
- The draws: a wrong draw raises, and so does a platform the artifact does
  not serve; `smoke_run`'s finiteness and state-advance checks.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from experiments import aot_export as jax_aot
from rmp_tpu import envs as jenvs
from rmp_tpu_torch import convert, envs
from rmp_tpu_torch.experiments import aot_export
from rmp_tpu_torch.sim.randomizer import Draws

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWO_JOINT = "two_joint/01_target_rmp_only"
SCENE = "franka/06_cluttered_environment"
PARITY_ATOL = 5e-4     # q after 5 ticks, tests/test_torch_envs.py


@pytest.fixture(scope="module")
def two_joint(tmp_path_factory):
    """(path, manifest, flat) of the saved two-joint artifact."""
    path = str(tmp_path_factory.mktemp("aot") / "two_joint.pt2")
    artifact, manifest, flat = aot_export.export_step(TWO_JOINT, 4, 2,
                                                      device="cpu")
    aot_export.save(path, artifact, manifest, flat)
    return path, manifest, flat


def eager_leaves(name, B, ticks, tensor_gains, geometry=None):
    env = envs.make(name, device="cpu")
    env.resolve_method = "solve"
    if geometry is not None:
        env.collision_geometry = geometry
    params = (aot_export.gains_as_tensors(env) if tensor_gains
              else env.gather_params())
    states = envs.make_batched_reset(env, B)()
    final, _ = envs.make_batched_rollout(env, ticks, with_aux=False)(
        states, params)
    return aot_export._tensors(final)


def test_roundtrip_equals_the_eager_rollout(two_joint):
    path, manifest, flat = two_joint
    n_state, n_param = manifest["n_state_leaves"], manifest["n_param_leaves"]
    assert n_state + n_param + len(manifest["draws"]) == len(flat) \
        == len(manifest["inputs"])
    assert len(manifest["outputs"]) == n_state
    assert manifest["draws"] == [
        {"kind": "uniform", "shape": [4, 3], "dtype": "float32"}] * 2
    for key in ("env", "batch", "ticks_per_call", "platforms", "inputs",
                "n_state_leaves", "n_param_leaves", "outputs", "ops",
                "torch"):
        assert key in manifest, key
    step, loaded, leaves = aot_export.load(path)
    assert loaded == json.loads(json.dumps(manifest))
    draws = aot_export.make_draws(manifest["draws"], "cpu",
                                  manifest["rng_state"])
    got = step(*leaves, *draws)
    for tensor_gains in (False, True):
        want = eager_leaves(TWO_JOINT, 4, 2, tensor_gains)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_draws_are_inputs_and_checked():
    """A drawing scene's artifact takes each call's draws as inputs; the
    traced stream checks every draw against what the tick asks for."""
    given = Draws("cpu", [torch.zeros(4, 3)])
    assert given.take(torch.rand, 4, (3,), None) is given.given[0]
    with pytest.raises(ValueError, match="given 1"):
        given.take(torch.rand, 4, (3,), None)
    with pytest.raises(ValueError, match="draw 1 is"):
        Draws("cpu", [torch.zeros(4, 2)]).take(torch.rand, 4, (3,), None)
    record = Draws("cpu")
    assert torch.equal(record.take(torch.randn, 2, (5,), torch.float32),
                       torch.zeros(2, 5))
    assert record.specs == [("normal", (2, 5), torch.float32)]


def test_smoke_run_and_platforms(two_joint):
    path, manifest, _ = two_joint
    report = aot_export.smoke_run(path, "cpu")
    assert report["outputs_finite"] and report["state_advances"]
    assert report["env"] == TWO_JOINT and report["platforms"] == ["cpu"]
    with pytest.raises(ValueError, match="serves"):
        aot_export.load(path, "cuda")
    with pytest.raises(ValueError, match="platforms"):
        aot_export.export_step(TWO_JOINT, 4, 1, platforms=["cuda"],
                               device="cpu")


def test_loads_in_a_process_with_torch_and_the_ops_alone(two_joint):
    """What a serving host runs: torch, the ops module, the artifact and its
    example inputs; the same outputs as in this process."""
    path, manifest, flat = two_joint
    step, _, leaves = aot_export.load(path)
    want = step(*flat)
    code = (
        "import sys, json, numpy as np, torch\n"
        "import rmp_tpu_torch.ops.library\n"
        "path = sys.argv[1]\n"
        "step = torch.export.load(path).module()\n"
        "manifest = json.load(open(path + '.json'))\n"
        "ex = np.load(path + '.npz')\n"
        "x = [torch.from_numpy(ex[f'arr_{i}']) for i in range(len(ex.files))]\n"
        "g = torch.Generator().set_state(torch.frombuffer(\n"
        "    bytearray.fromhex(manifest['rng_state']), dtype=torch.uint8))\n"
        "x += [torch.rand(*d['shape'], generator=g) for d in manifest['draws']]\n"
        "out = step(*x)\n"
        "np.savez(path + '.out.npz', *[o.numpy() for o in out])\n"
        "bad = [m for m in sys.modules if m.startswith('rmp_tpu_torch.envs')\n"
        "       or m.split('.')[0] in ('jax', 'rmp_tpu', 'experiments')]\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code, path], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    got = np.load(path + ".out.npz")
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got[f"arr_{i}"], w.numpy())


def jax_leaves(states):
    obs = states.sim.obstacles
    return dict(q=states.sim.q, qd=states.sim.qd, t=states.sim.t,
                goal=states.sim.goal, steps=states.steps,
                solved_count=states.solved_count, phase=states.phase,
                goal_best=states.goal_best, no_progress=states.no_progress,
                obstacles=dict(p0=obs.p0, p1=obs.p1, radius=obs.radius,
                               kinds=obs.kinds))


def test_flagship_against_the_jax_artifact():
    """One tick of scene 06 at B = 8 from moved reset states, the port's
    artifact against JAX's exported step on the same state."""
    B = 8
    data, _, jflat = jax_aot.export_step(SCENE, B, 1, None)
    jstep = jax.export.deserialize(data)
    jenv = jenvs.make(SCENE)
    states = jenvs.make_batched_reset(jenv, B)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(15)
    q = np.asarray(states.sim.q) + rng.uniform(-0.1, 0.1, (B, 9))
    qd = rng.uniform(-0.05, 0.05, (B, 9))
    states = dataclasses.replace(states, sim=dataclasses.replace(
        states.sim, q=jax.numpy.asarray(q, np.float32),
        qd=jax.numpy.asarray(qd, np.float32)))
    leaves, treedef = jax.tree.flatten(states)
    jout = jax.tree.unflatten(treedef, jstep.call(
        *leaves, *jflat[len(leaves):])[:len(leaves)])

    artifact, manifest, flat = aot_export.export_step(SCENE, B, 1,
                                                      device="cpu")
    assert set(manifest["ops"]) == {
        "rmp_tpu_torch::pullback_resolve_structured",
        "rmp_tpu_torch::fk_derivatives"}
    tstate = convert.state_from_numpy(
        jax.tree.map(np.asarray, jax_leaves(states)), "cpu")
    state_leaves = aot_export._tensors(tstate)
    n_state = manifest["n_state_leaves"]
    assert len(state_leaves) == n_state
    out = artifact.module()(*state_leaves, *flat[n_state:])
    final = aot_export._with_tensors(tstate, out)
    for name in ("q", "qd"):
        err = np.abs(getattr(final.sim, name).numpy()
                     - np.asarray(getattr(jout.sim, name))).max()
        print(f"scene 06, one exported tick, {name}: max |port - JAX| "
              f"{err:.3e}")
        assert err < PARITY_ATOL, (name, err)
    np.testing.assert_array_equal(final.steps.numpy(),
                                  np.asarray(jout.steps))
