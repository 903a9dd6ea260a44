"""The JAX package's model tools, ported with the N-link arm (M18): URDF
export and its round trip through the port's parser, the fine capsule set
and RMP_PANDA_CAPS, the base pose of fk_all and fk_position, the cylinder
support without a unit axis, and the dense row producers that K2a and K2b
read (core.policy_rows, core.policy_row_blocks), each against JAX's on the
same numpy inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu import core as jcore
from rmp_tpu import envs as jenvs
from rmp_tpu.envs import base as jbase
from rmp_tpu.models import kinematics as jK
from rmp_tpu.models import robots as jrobots
from rmp_tpu.models import specs as jspecs
from rmp_tpu.ops import gjk as jgjk
from rmp_tpu_torch import convert, core, envs
from rmp_tpu_torch.envs import planar
from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.models import robots, specs
from rmp_tpu_torch.models.urdf import parse_urdf
from rmp_tpu_torch.ops import cuda_resolve, gjk
from rmp_tpu_torch.sim import collision as C
from test_torch_envs import jax_state_leaves
from test_torch_generality import _fields, jax_planar_env

torch.set_num_threads(1)

ROW_TOL = 1e-5       # the producers' rows against JAX's
K1_TOL = 2e-4        # the dense path's q̈ against K1's, x max(1, |q̈|)

SPECS = {"two_joint": specs.TWO_JOINT_SPEC, "panda": specs.PANDA_SPEC,
         "dual_panda": specs.make_dual_spec(specs.PANDA_SPEC),
         "planar_5link": specs.make_planar_arm_spec(5)}
JAX_SPECS = {"two_joint": jspecs.TWO_JOINT_SPEC, "panda": jspecs.PANDA_SPEC,
             "dual_panda": jspecs.make_dual_spec(jspecs.PANDA_SPEC),
             "planar_5link": jspecs.make_planar_arm_spec(5)}


@pytest.mark.parametrize("name", list(SPECS))
def test_urdf_roundtrip(name, tmp_path):
    """write_urdf writes JAX's file byte for byte, and the port's parser
    reads it back into the model build_model gives (tests/test_kinematics.py
    's round trip: structure exact, constants to 1e-6 / 1e-7), with FK of
    every frame bit for bit by frame name, motors mapped by name (the
    dual-arm case of the same file)."""
    spec = SPECS[name]
    path, jpath = tmp_path / "port.urdf", tmp_path / "jax.urdf"
    specs.write_urdf(spec, str(path))
    jspecs.write_urdf(JAX_SPECS[name], str(jpath))
    assert path.read_text() == jpath.read_text()
    direct, parsed = specs.build_model(spec), parse_urdf(str(path))
    if name != "dual_panda":
        for field in ("frame_names", "parent", "joint_type", "q_index",
                      "motor_names"):
            assert getattr(parsed, field) == getattr(direct, field), field
        np.testing.assert_allclose(parsed.T_constant, direct.T_constant,
                                   atol=1e-6)
        for field in ("axis", "mass", "com"):
            np.testing.assert_allclose(getattr(parsed, field),
                                       getattr(direct, field), atol=0)
        np.testing.assert_allclose(parsed.inertia, direct.inertia, atol=1e-7)
    q = torch.tensor(np.random.default_rng(0).uniform(-1, 1, direct.n_q),
                     dtype=torch.float32)
    qmap = [direct.motor_names.index(m) for m in parsed.motor_names]
    T1, T2 = K.fk_all(direct, q), K.fk_all(parsed, q[qmap])
    f1 = dict(zip(direct.frame_names, T1))
    f2 = dict(zip(parsed.frame_names, T2))
    assert set(f1) == set(f2)
    for k in f1:
        torch.testing.assert_close(f1[k], f2[k], rtol=0, atol=0)


def test_fine_capsules_match_jax_and_stay_close(monkeypatch):
    """with_fine_capsules field for field as JAX's, 47 primitives against
    25 on the same collision frames, per-frame obstacle distances within
    the two fits' 2.5 cm (tests/test_collision.py); RMP_PANDA_CAPS=fine
    reaches franka_panda() whenever it is set (the port caches per capsule
    mode, where JAX's first call decides)."""
    got = specs.with_fine_capsules(specs.PANDA_SPEC)
    assert _fields(got) == _fields(jspecs.with_fine_capsules(
        jspecs.PANDA_SPEC))
    fine, coarse = specs.build_model(got), robots.franka_panda()
    count = lambda m: sum(len(m.collision[i]) for i in m.collision_frames)
    assert (count(fine), count(coarse)) == (47, 25)
    assert fine.collision_frames == coarse.collision_frames
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.uniform(-1.5, 1.5, (3, coarse.n_q)),
                     dtype=torch.float32)
    c = np.asarray([0.5, 0.1, 0.5]) + rng.uniform(-0.2, 0.2, (3, 3))
    obs = C.ObstacleSet(torch.tensor(c[:, None], dtype=torch.float32),
                        torch.tensor(c[:, None] + [0, 0, 0.4],
                                     dtype=torch.float32),
                        torch.full((3, 1), 0.06))
    df = C.robot_obstacle_distances(fine, K.fk_all(fine, q), obs)[3]
    dc = C.robot_obstacle_distances(coarse, K.fk_all(coarse, q), obs)[3]
    assert float((df - dc).abs().max()) < 0.025
    monkeypatch.setenv("RMP_PANDA_CAPS", "fine")
    assert count(robots.franka_panda()) == 47
    assert count(envs.make("franka/06_cluttered_environment",
                           device="cpu").model) == 47
    monkeypatch.delenv("RMP_PANDA_CAPS")
    assert robots.franka_panda() is coarse


def test_fk_all_base_and_fk_position_match_jax():
    model, jmodel = robots.franka_panda(), jrobots.franka_panda()
    rng = np.random.default_rng(3)
    q = rng.uniform(-1, 1, model.n_q).astype(np.float32)
    yaw = 0.7
    base = np.eye(4, dtype=np.float32)
    base[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    base[:3, 3] = [0.2, -0.4, 0.1]
    want = np.asarray(jK.fk_all(jmodel, jnp.asarray(q), jnp.asarray(base)))
    got = K.fk_all(model, torch.tensor(q), torch.tensor(base)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    plain = K.fk_all(model, torch.tensor(q)).numpy()
    np.testing.assert_allclose(got, base @ plain, atol=1e-6)
    ee = model.frame_index(robots.PANDA_EE_FRAME)
    np.testing.assert_allclose(
        K.fk_position(model, torch.tensor(q), ee).numpy(),
        np.asarray(jK.fk_position(jmodel, jnp.asarray(q), ee)), atol=1e-6)


def test_support_cylinder_matches_jax_and_keeps_flat_caps():
    """support_cylinder against JAX's on random cylinders, directions along
    the axis included, degenerate (r = 0, p0 = p1) ones too; and
    tests/test_gjk.py's flat-cap case through the port's closest_points."""
    rng = np.random.default_rng(5)
    n = 64
    p0 = rng.normal(size=(n, 3)).astype(np.float32)
    p1 = p0 + rng.normal(size=(n, 3)).astype(np.float32)
    p1[:4] = p0[:4]
    r = rng.uniform(0, 0.5, n).astype(np.float32)
    r[4:8] = 0.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[8:12] = p1[8:12] - p0[8:12]
    want = np.asarray(jgjk.support_cylinder(*(jnp.asarray(x)
                                              for x in (p0, p1, r, d))))
    got = gjk.support_cylinder(*(torch.tensor(x) for x in (p0, p1, r, d)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    a0, a1, ra = (torch.tensor([0.0, 0.0, 0.0]), torch.tensor([0.0, 0.0, 1.0]),
                  torch.tensor(0.3))
    for c, exact in [([0.0, 0.0, 1.5], 0.5), ([0.3, 0.0, 1.5], 0.5),
                     ([0.6, 0.0, 1.2], float(np.hypot(0.2, 0.3)))]:
        c = torch.tensor(c)
        _, _, _, dist, _ = gjk.closest_points(
            lambda dd: gjk.support_cylinder(a0, a1, ra, dd),
            lambda dd: gjk.support_sphere(c, torch.tensor(0.0), dd),
            c - torch.tensor([0.0, 0.0, 0.5]))
        assert abs(float(dist) - exact) < 1e-5


def test_hull_query_takes_its_own_vertices():
    """hull_verts stands in for the robot's hull table: the Panda's own
    table passed in gives the same answer, and a planar arm, which has no
    hull asset, runs on a box per link."""
    model = robots.franka_panda()
    rng = np.random.default_rng(8)
    q = torch.tensor(rng.uniform(-1, 1, (4, 9)), dtype=torch.float32)
    T = K.fk_all(model, q)
    obs = C.ObstacleSet(torch.tensor([[[0.5, 0.1, 0.3]]] * 4),
                        torch.tensor([[[0.5, 0.1, 0.7]]] * 4),
                        torch.full((4, 1), 0.05))
    table = C.hull_table(model, "cpu")
    want = C.robot_obstacle_distances_hull(model, T, obs)
    got = C.robot_obstacle_distances_hull(model, T, obs, hull_verts=table)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    arm = specs.build_model(specs.make_planar_arm_spec(3))
    with pytest.raises(ValueError, match="no hull asset"):
        C.robot_obstacle_distances_hull(arm, K.fk_all(arm, q[:, :3]), obs)
    box = torch.tensor([[x, y, z] for x in (0.0, 0.5) for y in (-0.04, 0.04)
                        for z in (-0.04, 0.04)]).expand(4, 8, 3)
    d = C.robot_obstacle_distances_hull(arm, K.fk_all(arm, q[:, :3]), obs,
                                        hull_verts=box)[3]
    assert d.shape == (4, 4, 1) and torch.isfinite(d).all()


def jax_rows(jenv, states, params, producer):
    """JAX's producer per env under vmap, on JAX's own _policy_inputs."""
    def one(state):
        q, qd, prm, ctxs, fk = jbase._policy_inputs(jenv, state, params)
        return producer(jenv.policies, q, qd, prm, ctxs)
    return jax.tree.map(np.asarray, jax.jit(jax.vmap(one))(states))


def perturbed(jenv, B: int, seed: int):
    rng = np.random.default_rng(seed)
    states = jbase.make_batched_reset(jenv, B)(jax.random.PRNGKey(0))
    n = jenv.model.n_q
    q = (np.asarray(states.sim.q)
         + rng.uniform(-0.1, 0.1, (B, n))).astype(np.float32)
    qd = rng.uniform(-0.05, 0.05, (B, n)).astype(np.float32)
    return dataclasses.replace(states, sim=dataclasses.replace(
        states.sim, q=jnp.asarray(q), qd=jnp.asarray(qd)))


@pytest.mark.parametrize("which", ["franka/06_cluttered_environment",
                                   "planar_5link"])
def test_dense_row_producers_match_jax(which):
    """core.policy_row_blocks and core.policy_rows against JAX's on the
    same states (8 envs moved by q ± 0.1, q̇ ± 0.05), at 1e-5; then the
    dense rows through K2b and K2a (plain versions) give K1's q̈ on the
    structured blocks of the same tick, at 2e-4 x max(1, |q̈|)."""
    if which == "planar_5link":
        jenv, env = jax_planar_env(5), planar.planar_arm_env(5, "cpu")
    else:
        jenv, env = jenvs.make(which), envs.make(which, device="cpu")
    states = perturbed(jenv, 8, 9)
    params = jenv.gather_params()
    jblocks = jax_rows(jenv, states, params, jcore.policy_row_blocks)
    jrows = jax_rows(jenv, states, params, jcore.policy_rows)
    state = convert.state_from_numpy(
        jax.tree.map(np.asarray, jax_state_leaves(states)), "cpu")
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu")
    q, qd, prm, ctxs, fk = envs.base._policy_inputs(env, state, tparams)
    blocks = core.policy_row_blocks(env.policies, q, qd, prm, ctxs, fk=fk)
    rows = core.policy_rows(env.policies, q, qd, prm, ctxs, fk=fk)
    for got_list, want_list in zip(blocks, jblocks):
        assert len(got_list) == len(want_list) == len(env.policies)
        for got, want in zip(got_list, want_list):
            np.testing.assert_allclose(got.numpy(), want, atol=ROW_TOL)
    for got, want in zip(rows, jrows):
        np.testing.assert_allclose(got.numpy(), want, atol=ROW_TOL)
    tags, sblocks = core.policy_row_blocks_structured(env.policies, q, qd,
                                                      prm, ctxs, fk=fk)
    want = cuda_resolve.pullback_resolve_structured(tags, sblocks).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    for got in (cuda_resolve.pullback_resolve_blocks(*blocks),
                cuda_resolve.pullback_resolve(*rows, ridge=0.0)):
        err = float(np.abs(got.numpy() - want).max())
        print(f"{which}: the dense rows' q̈ against K1's {err:.3e}")
        assert err <= K1_TOL * scale
