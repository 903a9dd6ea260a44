"""The port's GJK pieces and its batched hull query (K4 through its plain
version on the CPU) against the JAX package: `ops/gjk._johnson`, the lane
port `pallas_gjk._johnson_lanes`, the obstacle and hull supports, and
`sim/collision.robot_obstacle_distances_hull_batched` run on its Pallas
kernel in interpret mode, on the same numpy inputs.

The query tolerances are quantile-based, as in tests/test_pallas_gjk.py: the
two support reduces break exact ties and sum in different orders, so a rare
pair converges along another path within the 10-iteration accuracy band."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu import envs as jenvs
from rmp_tpu.models import kinematics as JK
from rmp_tpu.models.hulls import hulls_for as jhulls_for
from rmp_tpu.ops import gjk as jgjk
from rmp_tpu.ops import pallas_gjk as jpg
from rmp_tpu.sim import collision as JC
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.models.hulls import hulls_for
from rmp_tpu_torch.ops import cuda_gjk, gjk
from rmp_tpu_torch.sim import collision as C

torch.set_num_threads(1)

SCENE = "franka/06_cluttered_environment"
B = 128


def check_quantiles(diff):
    """p99 < 1e-4 and median < 1e-6 of a distance difference."""
    assert np.percentile(diff, 99) < 1e-4, np.percentile(diff, 99)
    assert np.median(diff) < 1e-6, np.median(diff)


def check_query(got, want, witness_p99=1e-4):
    """(pos_on_link, pos_on_obstacle, normal or None, distance): every
    output finite and the distances at the quantiles. Where the distances
    agree to 1e-5, the witnesses agree at p99 < witness_p99 (max < 1e-2)
    and the normals at p99 < 10 witness_p99. On near-parallel features (a
    cylinder's side) the 10-iteration GJK converges only linearly and the
    witness slides along them at unchanged distance (the JAX package's own
    kernel and XLA paths part by up to 1.5e-3 there; this file run as a
    script prints it), and a normal is a witness difference over the
    distance."""
    for g in got:
        assert g is None or np.isfinite(g).all()
    diff = np.abs(got[3] - want[3])
    check_quantiles(diff)
    agree = diff < 1e-5
    assert agree.mean() > 0.95
    for i, (g, w) in enumerate(zip(got[:3], want[:3])):
        if g is None:
            continue
        err = np.abs(g - w).max(-1)[agree]
        if i < 2:
            assert np.percentile(err, 99) < witness_p99, i
            assert err.max() < 1e-2, i
        else:
            assert np.percentile(err, 99) < 10 * witness_p99


def t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("newest_only", [True, False])
def test_johnson_matches_jax(newest_only):
    rng = np.random.default_rng(0)
    Y = rng.normal(size=(4000, 4, 3)).astype(np.float32)
    Y[::7, 1] = Y[::7, 0]           # degenerate duplicate slots
    Y[::11, 2] = Y[::11, 3]
    x, lam = (a.numpy() for a in gjk.johnson(t(Y), newest_only=newest_only))
    x_ref, lam_ref = jgjk._johnson(jnp.asarray(Y), newest_only=newest_only)
    np.testing.assert_allclose(x, np.asarray(x_ref), atol=1e-5)
    np.testing.assert_allclose(lam, np.asarray(lam_ref), atol=1e-5)
    y = [tuple(jnp.asarray(Y[:, i, c].reshape(40, 100)) for c in range(3))
         for i in range(4)]
    x_l, lam_l = jpg._johnson_lanes(y, newest_only=newest_only)
    np.testing.assert_allclose(
        x, np.stack([np.asarray(c).reshape(-1) for c in x_l], -1), atol=1e-5)
    np.testing.assert_allclose(
        lam, np.stack([np.asarray(c).reshape(-1) for c in lam_l], -1),
        atol=1e-5)


def test_supports_match_jax():
    rng = np.random.default_rng(1)
    N = 512
    p0 = rng.normal(size=(N, 3)).astype(np.float32)
    p1 = (p0 + rng.normal(size=(N, 3))).astype(np.float32)
    p1[::5] = p0[::5]                                   # spheres
    r = rng.uniform(0.01, 0.1, N).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d[::9] = np.float32(1e-7) * d[::9]                  # tiny directions
    axis = p1 - p0
    an = (axis / (np.linalg.norm(axis, axis=-1, keepdims=True)
                  + 1e-12)).astype(np.float32)
    np.testing.assert_allclose(
        gjk.support_capsule(t(p0), t(p1), t(r), t(d)).numpy(),
        np.asarray(jgjk.support_capsule(p0, p1, r, d)), atol=1e-6)
    np.testing.assert_allclose(
        gjk.support_cylinder_unit(t(p0), t(p1), t(an), t(r), t(d)).numpy(),
        np.asarray(jgjk.support_cylinder_unit(p0, p1, an, r, d)), atol=1e-6)
    cyl = np.arange(N) % 2 == 0
    got = gjk.support_obstacle(t(p0), t(p1), t(an), t(r), t(cyl),
                               t(d)).numpy()
    np.testing.assert_array_equal(got[cyl], gjk.support_cylinder_unit(
        t(p0), t(p1), t(an), t(r), t(d)).numpy()[cyl])

    # hull support: the Panda's padded tables (the fingers repeat vertex 0
    # 78 times, so ties are common) against the JAX mask average
    verts = hulls_for(robots.franka_panda())
    dirs = rng.normal(size=(verts.shape[0], 64, 3)).astype(np.float32)
    dirs[:, ::8] = verts[:, :1] * 3.0                   # toward vertex 0
    got = gjk.support_hull_avg(t(verts)[:, None], t(dirs)).numpy()
    want = np.asarray(jgjk.support_hull(jnp.asarray(verts)[:, None],
                                        jnp.asarray(dirs)))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_hull_table_matches_jax():
    jmodel = jenvs.make(SCENE).model
    np.testing.assert_array_equal(hulls_for(robots.franka_panda()),
                                  jhulls_for(jmodel))
    assert hulls_for(robots.franka_panda()).shape == (10, 96, 3)


def flagship_inputs():
    """B flagship states moved by q ± 0.3, with their world transforms
    (from the JAX FK, so both queries see the same poses) and the scene's
    seven cylinders per env."""
    jenv = jenvs.make(SCENE)
    states = jenvs.make_batched_reset(jenv, B)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    q = np.asarray(states.sim.q) + rng.uniform(-0.3, 0.3, (B, 9))
    T = np.asarray(jax.vmap(lambda x: JK.fk_all(jenv.model, x))(
        jnp.asarray(q, jnp.float32)))
    return jenv.model, T, states.sim.obstacles


def jax_kernel_queries(jmodel, T, jobs):
    """JAX's kernel path (interpret mode): a cold 10-iteration query, then a
    warm 4-iteration query seeded from its carry."""
    cold = JC.robot_obstacle_distances_hull_batched(
        jmodel, jnp.asarray(T), jobs, interpret=True)
    warm = JC.robot_obstacle_distances_hull_batched(
        jmodel, jnp.asarray(T), jobs, interpret=True, iters=4, warm=cold[4])
    return [np.asarray(x) for x in cold], [np.asarray(x) for x in warm]


@pytest.fixture(scope="module")
def flagship():
    return flagship_inputs()


def port_obstacles(jobs):
    return C.ObstacleSet(t(jobs.p0), t(jobs.p1), t(jobs.radius),
                         kinds=jobs.kinds)


@pytest.fixture(scope="module")
def jax_cold_warm(flagship):
    return jax_kernel_queries(*flagship)


@pytest.mark.parametrize("mode", ["cold", "warm"])
def test_batched_query_matches_jax_kernel_path(flagship, jax_cold_warm, mode):
    """Top-3 broad phase over 7 cylinders (it compacts), near-contact
    handoff (the moves bring pairs into contact) and, warm, the carry."""
    _, T, jobs = flagship
    cold, warm = jax_cold_warm
    model = robots.franka_panda()
    before = cuda_gjk.gjk_hull_obstacles.launches
    if mode == "cold":
        got = C.robot_obstacle_distances_hull_batched(
            model, t(T), port_obstacles(jobs))
        want = cold
    else:
        got = C.robot_obstacle_distances_hull_batched(
            model, t(T), port_obstacles(jobs), iters=4, warm=t(cold[4]))
        want = warm
    assert cuda_gjk.gjk_hull_obstacles.launches == before   # plain on CPU
    got = [x.numpy() for x in got]
    assert (want[3] <= C.HULL_CONTACT).any(), "no pair reaches the handoff"
    check_query(got, want)
    assert np.isfinite(got[4]).all()
    check_quantiles(np.linalg.norm(got[4] - want[4], axis=-1))


def test_all_pairs_cold_matches_jax_per_env(flagship):
    """top_m = K, cold, 10 iterations: JAX's per-env robot_obstacle_
    distances_hull (the XLA GJK) on a mixed set of capsules, a sphere and
    cylinders, so both obstacle supports run."""
    jmodel, T, _ = flagship
    rng = np.random.default_rng(3)
    K = 5
    center = np.array([0.4, 0.0, 0.5]) + rng.uniform(-0.25, 0.25, (K, 3))
    half = rng.normal(size=(K, 3)) * 0.1
    half[2] = 0.0                                        # a sphere
    p0 = np.broadcast_to(center - half, (B, K, 3)).astype(np.float32)
    p1 = np.broadcast_to(center + half, (B, K, 3)).astype(np.float32)
    radius = np.broadcast_to(rng.uniform(0.02, 0.08, K),
                             (B, K)).astype(np.float32)
    kinds = ("capsule", "cylinder", "capsule", "cylinder", "capsule")
    jobs = JC.ObstacleSet(jnp.asarray(p0), jnp.asarray(p1),
                          jnp.asarray(radius), kinds=kinds)
    want = [np.asarray(x) for x in jax.jit(jax.vmap(
        lambda T_, o: JC.robot_obstacle_distances_hull(jmodel, T_, o)))(
            jnp.asarray(T), jobs)]
    obs = C.ObstacleSet(t(p0), t(p1), t(radius), kinds=kinds)
    got = [x.numpy() for x in C.robot_obstacle_distances_hull_batched(
        robots.franka_panda(), t(T), obs, top_m=K)]
    assert (want[3] <= C.HULL_CONTACT).any()
    # the XLA path takes the first maximising vertex where K4 averages the
    # tied ones, so its witnesses part further on near-parallel features
    check_query(got[:4], want, witness_p99=1e-3)


def test_broad_phase_ties_pick_the_lowest_index():
    cap_d = torch.tensor([[[0.3, 0.1, 0.1, 0.2, 0.1, 0.1, 0.3],
                           [0.2, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2],
                           [0.5, 0.4, 0.3, 0.2, 0.1, 0.0, 0.0]]])
    idx = C.broad_phase(cap_d, 3)
    assert idx.tolist() == [[[1, 2, 4], [0, 1, 2], [5, 6, 4]]]
    # the same choice as the JAX package's where-chain on a wider batch
    rng = np.random.default_rng(4)
    d = np.round(rng.uniform(0, 1, (64, 10, 7)), 1).astype(np.float32)
    taken = np.zeros(d.shape, bool)
    for m in range(3):
        dm = np.where(taken, np.inf, d)
        first = np.argmax(dm <= dm.min(-1, keepdims=True), axis=-1)
        np.testing.assert_array_equal(C.broad_phase(t(d), 3)[..., m].numpy(),
                                      first)
        taken |= np.arange(7) == first[..., None]


def agreement(got, want) -> dict:
    """Distance quantiles, and witness errors where distances agree."""
    diff = np.abs(got[3] - want[3])
    agree = diff < 1e-5
    werr = np.concatenate([np.abs(g - w).max(-1)[agree]
                           for g, w in zip(got[:2], want[:2])])
    return dict(dist_p99=float(np.percentile(diff, 99)),
                dist_median=float(np.median(diff)),
                dist_max=float(diff.max()), agree_share=float(agree.mean()),
                witness_p99=float(np.percentile(werr, 99)),
                witness_max=float(werr.max()))


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_gjk.py: the agreement the tests
    # hold, and that of the JAX package's own two hull paths (its Pallas
    # kernel over every pair against its per-env XLA GJK) on the same poses
    jmodel, T, jobs = flagship_inputs()
    cold, warm = jax_kernel_queries(jmodel, T, jobs)
    model, obs = robots.franka_panda(), port_obstacles(jobs)
    port_cold = [x.numpy() for x in C.robot_obstacle_distances_hull_batched(
        model, t(T), obs)]
    port_warm = [x.numpy() for x in C.robot_obstacle_distances_hull_batched(
        model, t(T), obs, iters=4, warm=t(cold[4]))]
    every = [np.asarray(x) for x in JC.robot_obstacle_distances_hull_batched(
        jmodel, jnp.asarray(T), jobs, interpret=True, top_m=jobs.count)]
    xla = [np.asarray(x) for x in jax.jit(jax.vmap(
        lambda T_, o: JC.robot_obstacle_distances_hull(jmodel, T_, o)))(
            jnp.asarray(T), jobs)]
    for name, got, want in (("port vs JAX kernel path, cold", port_cold, cold),
                            ("port vs JAX kernel path, warm", port_warm, warm),
                            ("JAX kernel (every pair) vs JAX XLA per-env",
                             every, xla)):
        print(name, agreement(got, want))
