"""Env-sharded rollouts and sharded checkpoints of the port
(rmp_tpu_torch/parallel/, utils/checkpoint.py), after the JAX package's
tests/test_subsystems.py and tests/distributed_worker.py: two worker
processes join a gloo process group over the loopback address, each runs
its slice of a global batch through make_sharded_rollout, and the result is
held against a single-process make_rollout on the same global states and
against JAX's make_sharded_rollout. The workers also audit their
collectives and write a sharded checkpoint that this process restores."""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu import envs as jenvs
from rmp_tpu.parallel import make_mesh as jmake_mesh
from rmp_tpu.parallel import make_sharded_rollout as jsharded
from rmp_tpu.parallel import shard_env_batch as jshard
from rmp_tpu_torch import convert, core, envs
from rmp_tpu_torch.models.fk_derivatives import fk_derivatives
from rmp_tpu_torch.parallel import (audit_collectives, distributed,
                                    make_mesh, make_sharded_rollout,
                                    record_collectives, shard_env_batch)
from rmp_tpu_torch.utils import checkpoint
from test_torch_generality import as_dtype

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
# (scene, global batch): JAX's distributed worker's two-joint case and its
# collective audit's flagship; 'solve', 2 ticks, nothing drawn mid-rollout
SCENES = (("two_joint/01_target_rmp_only", 8),
          ("franka/06_cluttered_environment", 16))
TICKS = 2
WORLD = 2
SHARDED_TOL = 1e-6    # sharded against one process: the same arithmetic
JAX_TOL = 1e-5        # the port's metrics against JAX's
# the two-joint arm starts near its straight pose, where the target metric
# is nearly singular and float32 q̈ parts by up to ~7e-3 between the two
# packages: its mean |q̈| is held against a float64 run instead
SCREENED = "two_joint/01_target_rmp_only"
WORKER_TIMEOUT = 240

# One rank of the process group, run as `python -c WORKER <port> <rank>
# <dir>`: the global states come from <dir>/<scene>.pt; it writes
# <dir>/rank<rank>.pt and the sharded checkpoint <dir>/ckpt.
WORKER = r"""
import sys
import torch
from rmp_tpu_torch import envs
from rmp_tpu_torch.parallel import (audit_collectives, distributed,
                                    make_sharded_rollout, record_collectives,
                                    shard_env_batch)
from rmp_tpu_torch.utils import checkpoint

torch.set_num_threads(1)
port, rank, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
scenes = [(s, int(b)) for s, b in (x.split("=") for x in sys.argv[4:])]
device = distributed.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu")
assert torch.distributed.get_world_size() == 2
mesh = distributed.global_env_mesh()
assert (mesh.rank, mesh.size, mesh.device.type) == (rank, 2, "cpu"), mesh
result = {}
for scene, B in scenes:
    env = envs.make(scene, device=device)
    env.resolve_method = "solve"
    states = checkpoint.restore_checkpoint(
        f"{out}/{scene.replace('/', '_')}.pt",
        envs.make_batched_reset(env, B)())
    start, size = distributed.local_batch_slice(B)
    assert size == B // 2, (start, size)
    local = shard_env_batch(states, mesh)
    assert torch.equal(local.sim.q, states.sim.q[start:start + size])
    rollout = make_sharded_rollout(env, 2, mesh)
    with record_collectives() as rec:
        final, metrics = rollout(local, env.gather_params())
    audit = audit_collectives(rec)
    planted = {}
    for what, call in (
            ("all_gather", lambda: torch.distributed.all_gather(
                [torch.zeros(size, 2) for _ in range(2)],
                torch.zeros(size, 2))),
            ("all_reduce (2, 9)", lambda: torch.distributed.all_reduce(
                torch.zeros(2, 9)))):
        with record_collectives() as bad:
            call()
        try:
            audit_collectives(rec + bad)
            planted[what] = False
        except AssertionError:
            planted[what] = True
    leaves = [x for x in checkpoint._leaves(final)
              if isinstance(x, torch.Tensor)]
    result[scene] = dict(start=start, leaves=leaves,
                         metrics={k: float(v) for k, v in metrics.items()},
                         audit=audit, planted=planted)
    if scene == scenes[-1][0]:
        checkpoint.save_checkpoint_sharded(f"{out}/ckpt", final)
        back = checkpoint.restore_checkpoint_sharded(f"{out}/ckpt", final)
        result["ckpt_two_ranks"] = all(
            torch.equal(a, b) for a, b in zip(
                checkpoint._leaves(back)[:-1],
                checkpoint._leaves(final)[:-1])) and torch.equal(
            back.rng.get_state(), final.rng.get_state())
torch.save(result, f"{out}/rank{rank}.pt")
distributed.shutdown()
print(f"rank {rank}: ok", flush=True)
"""


# Scenes that draw mid-rollout: the randomized Panda (its pre_tick's normal
# draw every tick, its goals on every resample) and the randomized dual arm
# (jitter every tick, goals per arm), B envs x RESAMPLE_TICKS with the
# solved check widened to RESAMPLE_TOL m, so that every env of the Panda
# reaches a goal, and resamples, within the run (17 resamples over its 8
# envs, 178 goal events of the dual arm's; CPU run)
RESAMPLING = (("franka/randomized_cluttered", 8),
              ("dual_panda/randomized_clutter", 8))
RESAMPLE_TICKS = 30
RESAMPLE_TOL = 0.5

# One rank of the resampling case, run as `python -c RESAMPLE_WORKER <port>
# <rank> <dir> <scene>=<B> ...`: make_sharded_rollout with its aux on the
# rank's slice of <dir>/<scene>.pt; writes <dir>/resample<rank>.pt.
RESAMPLE_WORKER = r"""
import sys
import torch
from rmp_tpu_torch import envs
from rmp_tpu_torch.parallel import distributed, make_sharded_rollout, \
    shard_env_batch
from rmp_tpu_torch.utils import checkpoint

torch.set_num_threads(1)
port, rank, out, ticks, tol = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], int(sys.argv[4]),
                               float(sys.argv[5]))
scenes = [(s, int(b)) for s, b in (x.split("=") for x in sys.argv[6:])]
device = distributed.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu")
mesh = distributed.global_env_mesh()
result = {}
for scene, B in scenes:
    env = envs.make(scene, device=device)
    env.solved_tol = tol
    states = checkpoint.restore_checkpoint(
        f"{out}/{scene.replace('/', '_')}.pt",
        envs.make_batched_reset(env, B)())
    local = shard_env_batch(states, mesh)
    final, _, aux = make_sharded_rollout(env, ticks, mesh, collect_aux=True)(
        local, env.gather_params())
    result[scene] = dict(
        leaves=[x for x in checkpoint._leaves(final)
                if isinstance(x, torch.Tensor)],
        rng=final.rng.get_state(), resamples=int(aux["resample"].sum()))
torch.save(result, f"{out}/resample{rank}.pt")
distributed.shutdown()
print(f"rank {rank}: ok", flush=True)
"""


def free_port() -> int:
    """A port on the loopback address that nothing holds (bound to 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def jax_leaves(state) -> dict:
    """convert.state_from_numpy's leaves of a batched JAX EnvState."""
    obs = state.sim.obstacles
    return jax.tree.map(np.asarray, dict(
        q=state.sim.q, qd=state.sim.qd, t=state.sim.t, goal=state.sim.goal,
        steps=state.steps, solved_count=state.solved_count,
        phase=state.phase, goal_best=state.goal_best,
        no_progress=state.no_progress,
        obstacles=None if obs is None else dict(
            p0=obs.p0, p1=obs.p1, radius=obs.radius, kinds=obs.kinds)))


def global_states(scene: str, B: int):
    """JAX's batched reset of `scene` moved by q ± 0.1, q̇ ± 0.05 (seeded),
    with its 'solve' env."""
    jenv = jenvs.make(scene)
    jenv.resolve_method = "solve"
    states = jenvs.make_batched_reset(jenv, B)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(B)
    n = jenv.model.n_q
    q = (np.asarray(states.sim.q)
         + rng.uniform(-0.1, 0.1, (B, n))).astype(np.float32)
    qd = rng.uniform(-0.05, 0.05, (B, n)).astype(np.float32)
    return jenv, dataclasses.replace(states, sim=dataclasses.replace(
        states.sim, q=jnp.asarray(q), qd=jnp.asarray(qd)))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The workers' results, the global states and JAX's metrics."""
    out = tmp_path_factory.mktemp("ranks")
    cases = {}
    for scene, B in SCENES:
        jenv, jstates = global_states(scene, B)
        states = convert.state_from_numpy(jax_leaves(jstates), "cpu")
        checkpoint.save_checkpoint(str(out / f"{scene.replace('/', '_')}.pt"),
                                   states)
        _, jmetrics, jaux = jsharded(jenv, TICKS, jmake_mesh(),
                                     collect_aux=True)(
            jshard(jstates, jmake_mesh()), jenv.gather_params())
        cases[scene] = dict(
            B=B, states=states,
            jax={k: float(v) for k, v in jmetrics.items()},
            jax_env_abs_qdd=np.abs(np.asarray(jaux["qdd"])).mean(axis=(1, 2)))
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(port), str(rank), str(out)]
        + [f"{s}={b}" for s, b in SCENES],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(WORLD)]
    try:
        logs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log}"
        assert f"rank {rank}: ok" in log, log
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=True)
             for r in range(WORLD)]
    return dict(out=out, cases=cases, ranks=ranks)


def run_ranks(worker: str, out, *args) -> list:
    """The logs of WORLD worker processes `python -c worker <port> <rank>
    <out> *args`, each checked to have ended well."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(port), str(rank), str(out),
         *args], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(WORLD)]
    try:
        logs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log}"
        assert f"rank {rank}: ok" in log, log
    return logs


@pytest.fixture(scope="module")
def resampling_ranks(tmp_path_factory):
    """Each resampling scene's global reset (seed 0) and the two ranks'
    results on it."""
    out = tmp_path_factory.mktemp("resample")
    states = {}
    for scene, B in RESAMPLING:
        env = envs.make(scene, device="cpu")
        states[scene] = envs.make_batched_reset(env, B)()
        checkpoint.save_checkpoint(str(out / f"{scene.replace('/', '_')}.pt"),
                                   states[scene])
    run_ranks(RESAMPLE_WORKER, out, str(RESAMPLE_TICKS), str(RESAMPLE_TOL),
              *(f"{s}={b}" for s, b in RESAMPLING))
    return states, [torch.load(out / f"resample{r}.pt", weights_only=True)
                    for r in range(WORLD)]


@pytest.mark.parametrize("scene", [s for s, _ in RESAMPLING])
def test_two_rank_resampling_rollout_equals_one_process(resampling_ranks,
                                                        scene):
    """A scene that draws mid-rollout, sharded over two gloo ranks, equals
    make_rollout of the global batch in one process bit for bit: every
    leaf of the final states, stacked, and the generator's state on each
    rank, with goals resampled on both ranks. Each rank draws for the
    global batch's rows and keeps its own (EnvState.stream); a generator
    per rank that drew for its slice alone gave other goals and q."""
    states, ranks = resampling_ranks
    env = envs.make(scene, device="cpu")
    env.solved_tol = RESAMPLE_TOL
    final, aux = envs.make_rollout(env, RESAMPLE_TICKS)(
        states[scene], env.gather_params())
    expect = [x for x in checkpoint._leaves(final)
              if isinstance(x, torch.Tensor)]
    got = [torch.cat([r[scene]["leaves"][i] for r in ranks])
           for i in range(len(expect))]
    counts = [r[scene]["resamples"] for r in ranks]
    print(f"{scene}: resamples per rank {counts}, in one process "
          f"{int(aux['resample'].sum())}")
    assert all(c > 0 for c in counts), counts
    assert sum(counts) == int(aux["resample"].sum())
    for i, (g, e) in enumerate(zip(got, expect)):
        assert torch.equal(g, e), (i, float((g.double() - e.double())
                                            .abs().max()))
    for r in ranks:
        assert torch.equal(r[scene]["rng"], final.rng.get_state())


def test_row_streams_draw_the_global_rows():
    """randomizer.uniform / normal on a RowStream: a slice at an offset
    draws the whole stream's rows (offset .. offset + B), a fold repeats
    them, and the generator moves as for the whole stream."""
    from rmp_tpu_torch.sim import randomizer as rnd
    for draw in (rnd.uniform, rnd.normal):
        whole = draw(torch.Generator().manual_seed(5), 8, 2, 3)
        gen = torch.Generator().manual_seed(5)
        part = draw(rnd.RowStream(gen, 8, 4), 4, 2, 3)
        assert torch.equal(part, whole[4:])
        fold = draw(rnd.RowStream(torch.Generator().manual_seed(5), 8), 16,
                    2, 3)
        assert torch.equal(fold, torch.cat([whole, whole]))
        after = torch.Generator().manual_seed(5)
        draw(after, 8, 2, 3)
        assert torch.equal(gen.get_state(), after.get_state())


def unsharded(scene: str, states, aux: bool = False):
    """make_rollout on the global states in this process, and the
    sharded rollout's three metrics computed on the whole batch (and the
    rollout's aux)."""
    env = envs.make(scene, device="cpu")
    env.resolve_method = "solve"
    params = env.gather_params()
    if states.sim.q.dtype == torch.float64:
        params = tuple(as_dtype(p, torch.float64) for p in params)
    final, out = envs.make_rollout(env, TICKS)(states, params)
    metrics = dict(success_rate=float(out["solved"].any(dim=1).float().mean()),
                   goals_reached=float(final.solved_count.float().mean()),
                   mean_abs_qdd=float(out["qdd"].abs().mean()))
    return (final, metrics, out) if aux else (final, metrics)


@pytest.mark.parametrize("scene", [s for s, _ in SCENES])
def test_two_rank_rollout_equals_one_process(two_ranks, scene):
    """q, q̇ and every other leaf of the two ranks' final states, stacked,
    against make_rollout on the global batch in one process; the metrics
    too (within SHARDED_TOL), and against JAX's make_sharded_rollout on the
    same states (within JAX_TOL)."""
    case = two_ranks["cases"][scene]
    final, want = unsharded(scene, case["states"])
    expect = [x for x in checkpoint._leaves(final)
              if isinstance(x, torch.Tensor)]
    got = [torch.cat([r[scene]["leaves"][i] for r in two_ranks["ranks"]])
           for i in range(len(expect))]
    assert [r[scene]["start"] for r in two_ranks["ranks"]] == [
        0, case["B"] // WORLD]
    gaps = [float((g.double() - e.double()).abs().max())
            for g, e in zip(got, expect)]
    exact = all(torch.equal(g, e) for g, e in zip(got, expect))
    print(f"{scene}: sharded against one process, max leaf gap "
          f"{max(gaps):.3e}{' (bit for bit)' if exact else ''}")
    assert max(gaps) <= SHARDED_TOL, gaps
    for r in two_ranks["ranks"]:
        for k, v in want.items():
            assert abs(r[scene]["metrics"][k] - v) <= SHARDED_TOL, (k, v)
            if scene != SCREENED or k != "mean_abs_qdd":
                assert abs(r[scene]["metrics"][k] - case["jax"][k]) \
                    <= JAX_TOL, (k, r[scene]["metrics"][k], case["jax"][k])


def test_two_joint_mean_abs_qdd_against_jax_behind_float64(two_ranks,
                                                           monkeypatch):
    """SCREENED's mean |q̈| (the ranks' metric, equal to the one-process
    run's above) against a float64 run of the port on the same states: no
    farther from it than JAX's float32 metric is, plus JAX_TOL. Both
    packages round the nearly singular metric (each float32 run lies up to
    ~2e-2 from float64 on single envs)."""
    case = two_ranks["cases"][SCREENED]
    monkeypatch.setattr(core, "fk_derivatives_batched", fk_derivatives)
    _, exact = unsharded(SCREENED, as_dtype(case["states"], torch.float64))
    port = two_ranks["ranks"][0][SCREENED]["metrics"]["mean_abs_qdd"]
    jax_gap = abs(case["jax"]["mean_abs_qdd"] - exact["mean_abs_qdd"])
    port_gap = abs(port - exact["mean_abs_qdd"])
    print(f"{SCREENED}: mean |q̈| port {port:.7f}, JAX "
          f"{case['jax']['mean_abs_qdd']:.7f}, float64 "
          f"{exact['mean_abs_qdd']:.7f}")
    assert port_gap <= jax_gap + JAX_TOL, (port_gap, jax_gap)


@pytest.mark.parametrize("scene", [s for s, _ in SCENES])
def test_two_rank_collectives_are_scalar_all_reduces(two_ranks, scene):
    """Each rank's rollout issued only scalar all-reduces (two for the
    equal-shard check, three for the metrics), and the audit rejected a
    planted all-gather and a planted (2, 9) all-reduce."""
    for r in two_ranks["ranks"]:
        assert r[scene]["audit"] == {"all_reduce": 5, "scalar_only": True}
        assert r[scene]["planted"] == {"all_gather": True,
                                       "all_reduce (2, 9)": True}


def test_sharded_checkpoint_of_two_ranks_restores_in_one_and_two(two_ranks):
    """The checkpoint the two ranks wrote restores bit for bit in each rank
    (checked there) and in this one process onto a global template."""
    assert all(r["ckpt_two_ranks"] for r in two_ranks["ranks"])
    scene, B = SCENES[-1]
    like = envs.make_batched_reset(envs.make(scene, device="cpu"), B)()
    back = checkpoint.restore_checkpoint_sharded(
        str(two_ranks["out"] / "ckpt"), like)
    leaves = [x for x in checkpoint._leaves(back)
              if isinstance(x, torch.Tensor)]
    for i, x in enumerate(leaves):
        want = torch.cat([r[scene]["leaves"][i] for r in two_ranks["ranks"]])
        assert torch.equal(x, want), i
    with open(two_ranks["out"] / "ckpt" / "manifest.json") as f:
        assert json.load(f)["world"] == WORLD


def test_audit_rejects_data_moving_and_wide_collectives():
    """audit_collectives on records: scalar all-reduces pass; an
    all-gather, a broadcast and a (2, 9) all-reduce raise."""
    ok = [dict(op="all_reduce", shapes=[()])] * 3
    assert audit_collectives(ok) == {"all_reduce": 3, "scalar_only": True}
    for planted in (dict(op="all_gather", shapes=[(16, 9)]),
                    dict(op="broadcast", shapes=[(16, 9)]),
                    dict(op="all_reduce", shapes=[(2, 9)])):
        with pytest.raises(AssertionError):
            audit_collectives(ok + [planted])


def test_one_process_mesh_runs_without_a_group():
    """Without a process group the mesh is one rank, the shard is the whole
    batch on the named device, the rollout issues no collective and its
    metrics are the batch's."""
    scene, B = SCENES[0]
    env = envs.make(scene, device="cpu")
    env.resolve_method = "solve"
    mesh = make_mesh(["cpu"])
    assert (mesh.rank, mesh.size, mesh.axis_names) == (0, 1, ("env",))
    assert distributed.local_batch_slice(B) == (0, B)
    states = envs.make_batched_reset(env, B)()
    local = shard_env_batch(states, mesh)
    assert torch.equal(local.sim.q, states.sim.q)
    with record_collectives() as rec:
        final, metrics = make_sharded_rollout(env, TICKS, mesh)(
            local, env.gather_params())
    assert rec == []
    _, want = unsharded(scene, states)
    assert {k: float(v) for k, v in metrics.items()} == pytest.approx(want)
    with pytest.raises(ValueError):
        shard_env_batch(states, dataclasses.replace(mesh, size=3))


def test_sharded_checkpoint_restores_onto_other_slices(tmp_path):
    """A one-process checkpoint restored as rank 1 of 2 would take it (the
    template's batch and world decide the rows): here, in one process, the
    whole batch; a template of another batch raises."""
    scene, B = SCENES[1]
    env = envs.make(scene, device="cpu")
    states = envs.make_batched_reset(env, B, seed=3)()
    checkpoint.save_checkpoint_sharded(str(tmp_path), states)
    back = checkpoint.restore_checkpoint_sharded(str(tmp_path), states)
    for a, b in zip(checkpoint._leaves(back)[:-1],
                    checkpoint._leaves(states)[:-1]):
        assert torch.equal(a, b)
    assert torch.equal(back.rng.get_state(), states.rng.get_state())
    with pytest.raises(ValueError):
        checkpoint.restore_checkpoint_sharded(
            str(tmp_path), envs.make_batched_reset(env, B // 2)())
