"""The port's GJK pieces and its batched hull query (K4 through its plain
version on the CPU) against the JAX package: `ops/gjk._johnson`, the lane
port `pallas_gjk._johnson_lanes`, the obstacle and hull supports,
`sim/collision.robot_obstacle_distances_hull_batched` run on its Pallas
kernel in interpret mode, and K4 alone against the Pallas kernel's body run
eagerly on tie-heavy and odd-sized tables, on the same numpy inputs.

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


KERNEL_ARGS = ("verts", "R", "t", "p0", "p1", "an", "radius", "is_cyl",
               "d0")


def kernel_operands(verts, seed, B=128, M=2, unrotated=3):
    """K4's batch-minor operands (float32 numpy) for the link tables verts
    (L, V, 3): M slots per link, B envs with random poses (every
    `unrotated`-th env keeps R = I, so face ties stay axis-aligned),
    segments near the link, half of them cylinders, and random start
    directions, every fourth along +x."""
    rng = np.random.default_rng(seed)
    L = verts.shape[0]
    a, c = rng.uniform(-np.pi, np.pi, (2, L, B))
    Rz = np.zeros((L, B, 3, 3))
    Rz[..., 0, 0], Rz[..., 0, 1] = np.cos(a), -np.sin(a)
    Rz[..., 1, 0], Rz[..., 1, 1], Rz[..., 2, 2] = np.sin(a), np.cos(a), 1.0
    Ry = np.zeros((L, B, 3, 3))
    Ry[..., 0, 0], Ry[..., 0, 2] = np.cos(c), np.sin(c)
    Ry[..., 1, 1], Ry[..., 2, 0], Ry[..., 2, 2] = 1.0, -np.sin(c), np.cos(c)
    R = Rz @ Ry
    R[:, ::unrotated] = np.eye(3)
    t = rng.uniform(-0.05, 0.05, (L, B, 3))
    p0 = rng.uniform(-0.3, 0.3, (L, M, B, 3))
    p1 = p0 + rng.normal(size=(L, M, B, 3)) * 0.1
    an = (p1 - p0) / (np.linalg.norm(p1 - p0, axis=-1, keepdims=True)
                      + 1e-12)
    d0 = rng.normal(size=(L, M, B, 3))
    d0[:, :, ::4] = (1.0, 0.0, 0.0)

    def f(x):
        return np.ascontiguousarray(x, dtype=np.float32)
    return dict(verts=f(verts), R=f(R.transpose(0, 2, 3, 1)),
                t=f(t.transpose(0, 2, 1)), p0=f(p0.transpose(0, 1, 3, 2)),
                p1=f(p1.transpose(0, 1, 3, 2)), an=f(an.transpose(0, 1, 3, 2)),
                radius=f(rng.uniform(0.02, 0.08, (L, M, 1, B))),
                is_cyl=f(rng.uniform(size=(L, M, 1, B)) < 0.5),
                d0=f(d0.transpose(0, 1, 3, 2)))


class _OutRef:
    """A Pallas output ref for JAX's kernel body run eagerly."""

    def __init__(self, shape):
        self.a = np.zeros(shape, np.float32)

    def __setitem__(self, idx, value):
        self.a[idx] = np.asarray(value)


def jax_kernel_body(ops, iters):
    """JAX's K4 body (pallas_gjk._kernel) run eagerly, op by op, one
    (link, slot) block at a time, on jnp arrays standing in for its refs:
    (pa, pb, dist) in the kernel's layout. Eagerly every op's result is
    materialised once, so the mask average's max and its == test read the
    same dots; the jitted interpret-mode kernel may round them apart where
    vertices tie (it then misses tied maximisers: on a cube's faces 61 of
    256 pairs ended more than 1e-4 from a float64 run, the port 2)."""
    L, _, _ = ops["verts"].shape
    M, B = ops["p0"].shape[1], ops["p0"].shape[3]
    j = {k: jnp.asarray(v) for k, v in ops.items()}
    pa = np.zeros((L, M, 3, B), np.float32)
    pb = np.zeros_like(pa)
    dist = np.zeros((L, M, B), np.float32)
    with jax.disable_jit():
        for l in range(L):
            for k in range(M):
                refs = [j["verts"][l:l + 1], j["R"][l:l + 1],
                        j["t"][l:l + 1]]
                refs += [j[name][l:l + 1, k:k + 1] for name in KERNEL_ARGS[3:]]
                out = [_OutRef((1, 1, 3, B)), _OutRef((1, 1, 3, B)),
                       _OutRef((1, 1, 1, B))]
                jpg._kernel(*refs, *out, iters=iters, sub=B // jpg.LANES)
                pa[l, k], pb[l, k] = out[0].a[0, 0], out[1].a[0, 0]
                dist[l, k] = out[2].a[0, 0, 0]
    return pa, pb, dist


def plain_kernel(ops, iters=10):
    """The port's K4 (its plain version on the CPU) on numpy operands."""
    return [x.numpy() for x in cuda_gjk.gjk_hull_obstacles(
        *(t(ops[k]) for k in KERNEL_ARGS), iters=iters)]


def plain_and_jax(ops, iters=10):
    """(port plain K4, JAX's K4 body run eagerly) on ops, each as (pa, pb,
    dist) numpy arrays in the kernel's batch-minor layout."""
    return plain_kernel(ops, iters), jax_kernel_body(ops, iters)


def check_kernel_outputs(got, want):
    """check_query on batch-minor (pa, pb, dist): pairs last."""
    def pairs(x):
        return np.moveaxis(x, 2, -1)
    check_query([pairs(got[0]), pairs(got[1]), None, got[2]],
                [pairs(want[0]), pairs(want[1]), None, want[2]])


def link_dots(ops, direction):
    """Each (link, slot, env) table's dots with R^T direction, direction
    (L, M, 3, B): (L, M, B, V)."""
    local = np.einsum("lrcb,lmrb->lmbc", ops["R"], direction)
    return np.einsum("lvc,lmbc->lmbv", ops["verts"], local)


def cube_table():
    return np.array([[[x, y, z] for x in (-.05, .05) for y in (-.05, .05)
                      for z in (-.05, .05)]], np.float32)


def tie_case(name):
    """(ops, the least number of maximisers the first support must tie)."""
    rng = np.random.default_rng(7)
    if name == "padded table, vertex 0 the maximiser":
        verts = hulls_for(robots.franka_panda())[8:10]   # 18 rows + 78 copies
        ops = kernel_operands(verts, 8)
        # the first link support, at -d0, looks along vertex 0 (outward)
        out = verts[:, 0] - verts[:, :18].mean(axis=1)              # (L, 3)
        world = np.einsum("lrcb,lc->lrb", ops["R"], out)            # R out
        ops["d0"] = np.ascontiguousarray(
            -np.repeat(world[:, None], 2, axis=1), np.float32)
        return ops, 79
    if name == "cube, axis-aligned faces":
        ops = kernel_operands(cube_table(), 9, unrotated=1)
        axes = np.eye(3)[rng.integers(0, 3, 128)] * rng.choice([-1, 1],
                                                                (128, 1))
        ops["d0"] = np.ascontiguousarray(
            np.broadcast_to(axes.T, (1, 2, 3, 128)), np.float32)
        return ops, 4
    V = int(name.split("=")[1])
    return kernel_operands(rng.normal(size=(2, V, 3)).astype(np.float32)
                           * 0.05, 10 + V), 1


@pytest.mark.parametrize("name", ["padded table, vertex 0 the maximiser",
                                  "cube, axis-aligned faces", "V=1", "V=5",
                                  "V=97"])
def test_plain_kernel_matches_jax_kernel_on_ties_and_sizes(name):
    """Plain K4 against JAX's K4 body (run eagerly) where the mask
    average meets ties (79 on the fingers' padded tables, 4 on a cube's
    faces) and on tables that fill no unroll or chain split."""
    ops, ties = tie_case(name)
    dots = link_dots(ops, -ops["d0"])
    count = (dots == dots.max(axis=-1, keepdims=True)).sum(axis=-1)
    assert (count >= ties).mean() > 0.5, "the case does not reach its ties"
    got, want = plain_and_jax(ops)
    check_kernel_outputs(got, want)


def test_plain_kernel_matches_jax_kernel_with_frozen_and_live_pairs():
    """One batch whose first half starts at each pair's converged Minkowski
    point x* = pa - pb (most freeze at iteration 1) and whose second half
    starts at random directions (they run all 10 iterations)."""
    ops = kernel_operands(hulls_for(robots.franka_panda())[:4], 11)
    pa, pb, _ = plain_kernel(ops, iters=64)
    d0 = ops["d0"].copy()
    d0[..., :64] = (pa - pb)[..., :64]
    ops["d0"] = d0
    frozen = [plain_kernel(ops, iters) for iters in (1, 2)]
    same = ((frozen[0][2] == frozen[1][2])
            & (frozen[0][0] == frozen[1][0]).all(axis=2))
    assert same[..., :64].mean() > 0.3 and same[..., 64:].mean() < 0.05
    got, want = plain_and_jax(ops)
    check_kernel_outputs(got, want)


def scan_replay(rows, u):
    """K4's support rule as csrc/gjk_hull.cu computes it, replayed in numpy:
    one pass over the table's distinct rows keeps the max m, the first
    maximiser and the runner-up r; without a tie (r < m, and row 0 not the
    max where padding repeats it) the support is the first maximiser,
    otherwise the tied rows summed in index order, the padding added as one
    multiple of row 0, over their count."""
    n = cuda_gjk.distinct_rows(torch.tensor(rows[None]))[0]
    pad = rows.shape[0] - n
    m, r, first = -np.inf, -np.inf, 0
    for i in range(n):
        s = np.float32(rows[i] @ u)
        r = max(r, min(m, s))
        if s > m:
            m, first = s, i
    if r < m and not (pad > 0 and first == 0):
        return rows[first]
    tied = [i for i in range(n) if np.float32(rows[i] @ u) == m]
    total = np.sum(rows[tied], axis=0, dtype=np.float32)
    if pad > 0 and 0 in tied:
        total = total + np.float32(pad) * rows[0]
    return total / np.float32(len(tied) + (pad if 0 in tied else 0))


def test_scan_replay_is_the_mask_average():
    """The two-pass support rule of the kernel gives the mask average of
    ops/gjk.support_hull_avg on the padded tables (vertex-0 ties), a cube's
    faces, edges and corners, and random directions."""
    rng = np.random.default_rng(12)
    fingers = hulls_for(robots.franka_panda())[8]
    cube = cube_table()[0]
    cases = [(fingers, fingers[0] - fingers[:18].mean(axis=0))]
    cases += [(fingers, d) for d in rng.normal(size=(32, 3))]
    cases += [(cube, np.array(d, np.float64))
              for d in ((1, 0, 0), (0, -1, 0), (1, 1, 0), (0, 1, -1),
                        (1, 1, 1), (-1, 0, 0))]
    cases += [(cube, d) for d in rng.normal(size=(16, 3))]
    for rows, u in cases:
        u = u.astype(np.float32)
        want = gjk.support_hull_avg(t(rows), t(u)).numpy()
        np.testing.assert_allclose(scan_replay(rows, u), want, atol=1e-7)


def test_distinct_rows_counts_the_padding():
    """distinct_rows: rows up to the last one whose bits differ from row 0,
    as the kernel counts them; the Panda's fingers hold 18."""
    assert cuda_gjk.distinct_rows(t(hulls_for(robots.franka_panda()))) == [
        96] * 8 + [18] * 2
    rows = np.arange(12, dtype=np.float32).reshape(4, 3)
    table = np.stack([rows, rows[[0, 1, 0, 0]], rows[[0, 0, 0, 0]],
                      rows[[0, 0, 2, 0]], rows[[0, 1, 0, 3]]])
    assert cuda_gjk.distinct_rows(t(table)) == [4, 2, 1, 3, 4]
    signed = np.zeros((1, 3, 3), np.float32)
    signed[0, 2, 1] = -0.0                       # equal as floats, not bits
    assert cuda_gjk.distinct_rows(t(signed)) == [3]
    assert cuda_gjk.distinct_rows(t(np.ones((1, 1, 3), np.float32))) == [1]


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
