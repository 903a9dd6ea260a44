"""The dual-arm Panda in the port against the JAX package: the multi-robot
spec and model, the hull alias, K1's plain version at n = 18, K3's plain
version at 26 frames and 18 motors, the hull-vs-hull GJK, the inter-arm
context, each piece of dual_panda/randomized_clutter fed the JAX package's
own inputs and draws, the state conversion and the handover golden.

K1 at n = 18 is held against JAX's K1 kernel body
(`pallas_resolve._kernel_structured`, `_lu_solve_lanes`) run eagerly under
`jax.disable_jit()` on the operands its `pallas_call` would get: XLA takes
34 minutes to compile the interpret-mode program of the unrolled n = 18 LU
on a CPU host. `test_jax_k1_body_matches_interpret_mode` holds that shim
against interpret mode at n = 9."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu import envs as jenvs
from rmp_tpu.envs import dual as jdual
from rmp_tpu.models import fk_derivatives as jfk
from rmp_tpu.models import hulls as jhulls
from rmp_tpu.models import kinematics as JK
from rmp_tpu.models import robots as jrobots
from rmp_tpu.models import specs as jspecs
from rmp_tpu.ops import pallas_resolve as jpr
from rmp_tpu.sim import collision as jcol
from rmp_tpu_torch import convert, envs
from rmp_tpu_torch.envs import base, dual
from rmp_tpu_torch.models import hulls, robots, specs
from rmp_tpu_torch.models.fk_derivatives import fk_derivatives
from rmp_tpu_torch.ops import cuda_resolve, gjk
from rmp_tpu_torch.sim import collision
from test_torch_randomized import jax_leaves
from test_torch_resolve import layout_blocks

torch.set_num_threads(1)

SCENE = "dual_panda/randomized_clutter"
B = 8
ATOL = 2e-6          # float32 points, distances and bound gains
K1_TOL = 2e-4        # x max(1, |q̈|), as the kernel against its plain version
K3_RTOL = 1e-4       # x max(1, |ref|)
GOLDEN_ATOL = 1e-4   # tests/test_envs.py's limit on the handover golden's q
WITNESS_TOL = 1e-3   # GJK witnesses: 10 iterations stop short on some pairs


# ------------------------------------------------------------ the model ---

def _same(a, b, what):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, (str, bool, type(None))):
        assert a == b, what
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)


def test_dual_spec_and_model_match_jax():
    """make_dual_spec of the Panda and the built dual model, field by field
    (links, joints, the collision capsules), the ready pose mapped by motor
    name, and one model per separation."""
    kw = dict(offset_a=(0.0, 0.45, 0.0), offset_b=(0.0, -0.45, 0.0),
              yaw_a=-np.pi / 2.0, yaw_b=np.pi / 2.0)
    _same(specs.make_dual_spec(specs.PANDA_SPEC, **kw),
          jspecs.make_dual_spec(jspecs.PANDA_SPEC, **kw), "spec")
    model, jmodel = robots.dual_panda(), jrobots.dual_panda()
    _same(model, jmodel, "model")
    assert (model.name, model.n_frames, model.n_q,
            len(model.collision_frames)) == ("panda_dual", 26, 18, 20)
    np.testing.assert_array_equal(robots.dual_panda_q_ready(model),
                                  jrobots.dual_panda_q_ready(jmodel))
    assert robots.dual_panda() is model
    assert robots.dual_panda(1.0) is not model
    # the motors interleave the arms: by position the single Panda's ready
    # pose would be wrong
    assert not np.array_equal(robots.dual_panda_q_ready(model),
                              np.tile(robots.PANDA_Q_READY, 2))


def test_make_multi_spec_names_and_rejects_like_jax():
    three = specs.make_multi_spec(specs.UR5_SPEC, [(0, 0, 0)] * 3,
                                  [0.0] * 3, ("a_", "b_", "c_"))
    _same(three, jspecs.make_multi_spec(jspecs.UR5_SPEC, [(0, 0, 0)] * 3,
                                        [0.0] * 3, ("a_", "b_", "c_")),
          "spec")
    assert three.name == "UR5_x3"
    with pytest.raises(ValueError, match="equal lengths"):
        specs.make_multi_spec(specs.UR5_SPEC, [(0, 0, 0)], [0.0, 0.0],
                              ("a_",))
    with pytest.raises(ValueError, match="duplicate prefixes"):
        specs.make_multi_spec(specs.UR5_SPEC, [(0, 0, 0)] * 2, [0.0] * 2,
                              ("a_", "a_"))


def test_dual_hull_table_matches_jax():
    """The panda_dual entry reads the Panda's hulls through the L_ / R_
    alias, in collision-frame order."""
    table = hulls.hulls_for(robots.dual_panda())
    np.testing.assert_array_equal(table,
                                  jhulls.hulls_for(jrobots.dual_panda()))
    assert table.shape == (20, 96, 3)
    assert torch.equal(hulls.hull_table(robots.dual_panda(), "cpu"),
                       torch.as_tensor(table))


# ---------------------------------------------------------- K1, n = 18 ---

def jax_k1_body(tags, blocks, ridge: float = 0.0) -> np.ndarray:
    """JAX's K1 (pallas_resolve.pullback_resolve_structured) with its kernel
    body run eagerly under jax.disable_jit(): the identity blocks pre-summed
    and every operand put in the (n, R, B) layout as the wrapper does, then
    `_kernel_structured` on jnp arrays standing in for its refs."""
    A0 = f0 = None
    kernel_tags, inputs = [], []
    for tag, blk in zip(tags, blocks):
        if tag == "identity":
            M, v = (jnp.asarray(x) for x in blk)
            A0 = M if A0 is None else A0 + M
            f0 = v if f0 is None else f0 + v
    if A0 is not None:
        kernel_tags.append("identity0")
        inputs += [jnp.transpose(A0, (1, 2, 0)), jnp.transpose(f0, (1, 0))]
    for tag, blk in zip(tags, blocks):
        if tag == "identity":
            continue
        J, X, v = (jnp.asarray(x) for x in blk)
        kernel_tags.append(tag)
        inputs += [jnp.transpose(J, (2, 1, 0)),
                   jnp.transpose(X, (1, 0)) if tag == "scalar"
                   else jnp.transpose(X, (2, 1, 0)), jnp.transpose(v, (1, 0))]
    n = blocks[0][0].shape[-1]
    rows = {}

    class Out:
        def __setitem__(self, idx, value):
            rows[idx[0]] = np.asarray(value)
    with jax.disable_jit():
        jpr._kernel_structured(*inputs, Out(), n=n, ridge=ridge,
                               tags=tuple(kernel_tags))
    return np.stack([rows[i] for i in range(n)], axis=-1)


_HEAD = (("dense", 3), ("dense", 3), ("identity", 0), ("identity", 0),
         ("identity", 0))
DUAL_LAYOUTS = {"handover": _HEAD + (("dense", 15),) * 5,
                "randomized": _HEAD + (("scalar", 80),) * 2
                + (("dense", 15),) * 5}


def _port_k1(tags, blocks):
    before = cuda_resolve.pullback_resolve_structured.launches
    out = cuda_resolve.pullback_resolve_structured(
        tags, [tuple(torch.tensor(x) for x in b) for b in blocks]).numpy()
    assert cuda_resolve.pullback_resolve_structured.launches == before
    return out


def _assert_k1(got, want):
    scale = np.maximum(1.0, np.abs(want).max(axis=1, keepdims=True))
    assert (np.abs(got - want) <= K1_TOL * scale).all(), \
        np.abs(got - want).max()


def test_jax_k1_body_matches_interpret_mode():
    """The shim: JAX's kernel body run eagerly equals its Pallas kernel in
    interpret mode at n = 9 (the flagship layout, 128 envs)."""
    from jax.experimental.pallas import tpu as pltpu
    layout = (("dense", 3), ("identity", 0), ("identity", 0),
              ("identity", 0), ("scalar", 70))
    tags, blocks = layout_blocks(5, 128, 9, layout)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpr.pullback_resolve_structured(
            tags, [tuple(jnp.asarray(x) for x in b) for b in blocks]))
    np.testing.assert_allclose(jax_k1_body(tags, blocks), want, atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("layout", list(DUAL_LAYOUTS))
def test_plain_k1_n18_matches_jax(layout):
    """K1's plain version at n = 18 on random blocks of each dual layout."""
    tags, blocks = layout_blocks(1, 16, 18, DUAL_LAYOUTS[layout])
    _assert_k1(_port_k1(tags, blocks), jax_k1_body(tags, blocks))


@pytest.fixture(scope="module")
def randomized():
    """(JAX env, port env, JAX reset states of B envs, JAX params, port
    params)."""
    jenv = jenvs.make(SCENE)
    env = envs.make(SCENE, device="cpu")
    states = jenvs.make_batched_reset(jenv, B)(jax.random.PRNGKey(0))
    params = jenv.gather_params()
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu")
    return jenv, env, states, params, tparams


def port_state(state):
    return convert.state_from_numpy(jax_leaves(state), "cpu")


def test_plain_k1_n18_on_a_real_tick_matches_jax(randomized):
    """K1 on the port's own blocks of a randomized dual tick, 3 ticks in
    (strided views as the tick makes them), against JAX's body."""
    _, env, states, _, tparams = randomized
    state, _ = envs.make_batched_rollout(env, 3, with_aux=False)(
        port_state(states), tparams)
    state = env.pre_tick(state)
    q, qd, prm, ctxs, fk = base._policy_inputs(env, state, tparams)
    from rmp_tpu_torch.core import policy_row_blocks_structured
    tags, tblocks = policy_row_blocks_structured(env.policies, q, qd, prm,
                                                 ctxs, fk=fk)
    layout = tuple((t, b[0].shape[1] if t != "identity" else 0)
                   for t, b in zip(tags, tblocks))
    assert layout == DUAL_LAYOUTS["randomized"]
    assert any(not x.is_contiguous() for b in tblocks for x in b)
    blocks = [tuple(x.numpy() for x in b) for b in tblocks]
    _assert_k1(cuda_resolve.pullback_resolve_structured(tags, tblocks)
               .numpy(), jax_k1_body(tags, blocks))


def _lu_plain_swap(A, f):
    """Partial pivoting that swaps the pivot row with row k (the first
    maximum), float32, the same clamps: what the sequential rule is not."""
    n = A.shape[0]
    rows = np.concatenate([A, f[:, None]], axis=1).astype(np.float32)

    def safe(d):
        return np.float32(max(d, 1e-12) if d >= 0 else min(d, -1e-12))
    for k in range(n):
        j = k + int(np.argmax(np.abs(rows[k:, k])))
        rows[[k, j]] = rows[[j, k]]
        inv = np.float32(1.0) / safe(rows[k, k])
        for i in range(k + 1, n):
            rows[i] = rows[i] - np.float32(rows[i, k] * inv) * rows[k]
    x = np.zeros(n, np.float32)
    for i in reversed(range(n)):
        s = rows[i, n]
        for j in range(i + 1, n):
            s = np.float32(s - rows[i, j] * x[j])
        x[i] = np.float32(s / safe(rows[i, i]))
    return x


def test_k1_n18_tie_case_follows_the_sequential_swap():
    """A singular integer system with exact magnitude ties in its pivot
    columns (one identity block): the reference's pivot rule moves the
    displaced candidate into each row that takes over, so the rows end in
    a cyclic order, and with the clamped zero pivot that order decides q̈.
    The port's plain version follows JAX's body; a plain swap lands
    elsewhere."""
    n = 18
    rng = np.random.default_rng(1)
    A = rng.choice([-2, -1, 0, 1, 2], size=(n, n)).astype(np.float32)
    A[5] = A[3]                                  # singular
    f = rng.choice([-1, 1, 2], size=n).astype(np.float32)
    blocks = [(np.broadcast_to(A, (4, n, n)).copy(),
               np.broadcast_to(f, (4, n)).copy())]
    want = jax_k1_body(("identity",), blocks)
    got = _port_k1(("identity",), blocks)
    scale = np.abs(want).max()
    assert scale > 1e9                           # the clamp decided
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    swapped = _lu_plain_swap(A, f)
    assert np.abs(swapped - want[0]).max() > 0.5 * scale


# ------------------------------------------------------ K3, F = 26, n = 18 ---

def test_plain_k3_dual_matches_jax():
    """K3's plain version on the dual model against JAX's closed-form FK
    derivatives, 1e-4 x max(1, |ref|)."""
    rng = np.random.default_rng(3)
    model, jmodel = robots.dual_panda(), jrobots.dual_panda()
    q = (robots.dual_panda_q_ready(model)
         + rng.uniform(-1.0, 1.0, (B, 18))).astype(np.float32)
    qd = rng.uniform(-1.0, 1.0, (B, 18)).astype(np.float32)
    got = fk_derivatives(model, torch.tensor(q), torch.tensor(qd))
    want = jax.vmap(lambda a, b: jfk.fk_derivatives(jmodel, a, b))(
        jnp.asarray(q), jnp.asarray(qd))
    for name, g, w in zip(("T", "Td", "J", "c"), got, want):
        w = np.asarray(w).reshape(g.shape)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=K3_RTOL * max(1.0, float(np.abs(w).max())), err_msg=name)


# ------------------------------------------------- the hull-vs-hull GJK ---

def test_support_hull_takes_the_first_maximiser():
    """Away from ties the support equals JAX's; on a tie (a repeated vertex,
    as the padded tables have, or two vertices level in d) the first
    vertex wins."""
    rng = np.random.default_rng(4)
    verts = rng.normal(size=(5, 12, 3)).astype(np.float32)
    d = rng.normal(size=(7, 5, 3)).astype(np.float32)
    from rmp_tpu.ops import gjk as jgjk
    np.testing.assert_array_equal(
        gjk.support_hull(torch.tensor(verts), torch.tensor(d)).numpy(),
        np.asarray(jgjk.support_hull(jnp.asarray(verts), jnp.asarray(d))))
    tie = torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 1.0], [0.0, 0.0, 1.0],
                        [-1.0, 0.0, 1.0]])
    np.testing.assert_array_equal(
        gjk.support_hull(tie, torch.tensor([0.0, 0.0, 1.0])).numpy(),
        [0.0, 0.0, 1.0])
    np.testing.assert_array_equal(
        gjk.support_hull(tie, torch.tensor([1e-3, 0.0, 1.0])).numpy(),
        [1.0, 0.0, 1.0])


def _inter_arm_pairs():
    _, left, pairs = jdual._inter_arm_policies(jrobots.dual_panda())
    return left, pairs


def _poses(seed, batch=B):
    rng = np.random.default_rng(seed)
    q = (robots.dual_panda_q_ready(robots.dual_panda())
         + rng.uniform(-0.6, 0.6, (batch, 18))).astype(np.float32)
    return np.asarray(jax.vmap(lambda x: JK.fk_all(jrobots.dual_panda(),
                                                   x))(jnp.asarray(q)))


def _near_contact(T_all, pairs, k, gap):
    """T_all with the R arm moved (every R frame translated) so that pair
    k's hull distance becomes `gap` in env 0 (negative: overlap)."""
    model = robots.dual_panda()
    _, _, n, d = collision.robot_self_distances_hull(
        model, torch.tensor(T_all[:1]), pairs)
    shift = (float(d[0, k]) - gap) * n[0, k].numpy()       # toward L
    out = T_all.copy()
    for f, name in enumerate(model.frame_names):
        if name.startswith("R_"):
            out[0, f, :3, 3] += shift
    return out


@pytest.mark.parametrize("case", ["cold", "near", "overlap"])
def test_self_distances_hull_matches_jax(case):
    """robot_self_distances_hull on the 25 inter-arm pairs against JAX's,
    env by env: random poses (cold), env 0 moved to 0.3 mm of contact on
    its hands (below the 0.5 mm handoff: the capsule result answers), and
    overlapping by 5 mm. Distances to float32 rounding; witnesses within
    WITNESS_TOL on all but 2% of the pairs (10 iterations stop short of
    convergence on a few), normals likewise."""
    left, pairs = _inter_arm_pairs()
    T_all = _poses(5)
    k = len(pairs) - 1                                   # L hand x R hand
    if case != "cold":
        T_all = _near_contact(T_all, pairs, k,
                              3e-4 if case == "near" else -5e-3)
    jmodel = jrobots.dual_panda()
    want = [np.asarray(w) for w in jax.vmap(
        lambda t: jcol.robot_self_distances_hull(jmodel, t, pairs))(
            jnp.asarray(T_all))]
    got = [g.numpy() for g in collision.robot_self_distances_hull(
        robots.dual_panda(), torch.tensor(T_all), pairs)]
    np.testing.assert_allclose(got[3], want[3], atol=1e-6)
    for g, w in zip(got[:3], want[:3]):
        err = np.abs(g - w).max(axis=-1)
        assert np.quantile(err, 0.98) <= WITNESS_TOL
    if case != "cold":
        cap = collision.robot_self_distances(robots.dual_panda(),
                                             torch.tensor(T_all), pairs)
        assert got[3][0, k] <= 5e-4
        np.testing.assert_array_equal(got[0][0, k], cap[0][0, k].numpy())
        np.testing.assert_array_equal(got[2][0, k], cap[2][0, k].numpy())


@pytest.mark.parametrize("hull", [False, True])
def test_inter_arm_context_matches_jax(hull):
    """_inter_arm_ctx (batched, device index tensors) against JAX's per-env
    context, entry by entry, capsule and hull."""
    left, pairs = _inter_arm_pairs()
    T_all = _poses(6)
    jmodel, model = jrobots.dual_panda(), robots.dual_panda()
    want = jax.vmap(lambda t: jdual._inter_arm_ctx(jmodel, t, left, pairs,
                                                   hull))(jnp.asarray(T_all))
    _, _, tpairs, rows = dual._inter_arm_policies(model, "cpu")
    assert tpairs == pairs
    got = dual._inter_arm_ctx(model, torch.tensor(T_all), pairs, rows, hull)
    assert set(got) == set(want)
    for key, entry in want.items():
        for field, w in entry.items():
            tol = ATOL if field in ("distance", "mask") else WITNESS_TOL
            err = np.abs(got[key][field].numpy() - np.asarray(w))
            assert np.quantile(err, 0.98) <= tol, (key, field)
            assert err.max() <= (ATOL if field in ("distance", "mask")
                                 else 5e-2), (key, field)


# ------------------------------------------ the randomized scene's pieces ---

class Draws:
    """A stand-in for torch.rand that hands out given unit uniforms in
    order, each checked against the shape asked for."""

    def __init__(self, *arrays):
        self.queue = [torch.tensor(np.asarray(a, np.float32)) for a in arrays]

    def __call__(self, *shape, **kw):
        out = self.queue.pop(0)
        assert tuple(out.shape) == tuple(shape), (out.shape, shape)
        return out.to(kw.get("dtype") or torch.float32)


def _unit(key, shape):
    return np.asarray(jax.random.uniform(key, shape))


def test_reset_matches_jax_fed_its_draws(randomized, monkeypatch):
    """The reset (robot jitter, the obstacles clear of the posed links,
    padding, both goals clear of the obstacles and of each other) fed the
    unit uniforms JAX draws from each env's key equals JAX's reset."""
    jenv, env, _, _, _ = randomized
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    want = jax.vmap(jenv.reset)(keys)
    uq, uqd, uc, urpy, urad, uL, uR = ([] for _ in range(7))
    for key in keys:
        k_obs, k_robot, k_goal, _ = jax.random.split(key, 4)
        kq, kqd = jax.random.split(k_robot)
        uq.append(_unit(kq, (18,)))
        uqd.append(_unit(kqd, (18,)))
        k1, k2, k3 = jax.random.split(k_obs, 3)
        uc.append(_unit(k1, (5, 8, 3)))
        urpy.append(_unit(k2, (5, 3)))
        urad.append(_unit(k3, (5,)))
        kL, kR = jax.random.split(k_goal)
        uL.append(_unit(kL, (8, 3)))
        uR.append(_unit(kR, (8, 3)))
    monkeypatch.setattr(torch, "rand", Draws(uq, uqd, uc, urpy, urad, uL,
                                             uR))
    got = env.reset(B)
    np.testing.assert_allclose(got.sim.q.numpy(), np.asarray(want.sim.q),
                               atol=ATOL)
    np.testing.assert_allclose(got.sim.qd.numpy(), np.asarray(want.sim.qd),
                               atol=ATOL)
    for field in ("p0", "p1", "radius"):
        np.testing.assert_allclose(
            getattr(got.sim.obstacles, field).numpy(),
            np.asarray(getattr(want.sim.obstacles, field)), atol=ATOL)
    assert got.sim.obstacles.kinds == want.sim.obstacles.kinds
    np.testing.assert_allclose(got.sim.goal.numpy(), np.asarray(want.sim.goal),
                               atol=ATOL)
    assert got.sim.goal.shape == (B, 2, 3)
    for k, w in want.scratch.items():
        if k != "cfg":
            np.testing.assert_array_equal(got.scratch[k].numpy(),
                                          np.asarray(w), err_msg=k)


def _mixed(jenv, states, rng):
    """JAX states with the per-arm bookkeeping mixed per env: arms stalled
    either side of the yield, detour and push triggers, maneuvers in flight
    (at and away from their waypoints), budgets used and not, late phases,
    EEs near and far from each other's goals, and the knobs' other
    branches (scored waypoints, global and metric-only relax, the hold
    assist)."""
    n = states.steps.shape[0]

    def pick(choices, dtype, shape=(n,)):
        return jnp.asarray(rng.choice(choices, shape).astype(dtype))
    ee = jax.vmap(lambda q: jnp.stack([
        JK.fk_frame(jenv.model, q, jenv.model.frame_index(e))[:3, 3]
        for e in (jdual.EE_L, jdual.EE_R)]))(states.sim.q)
    sc = dict(states.scratch)
    near = jnp.asarray(rng.random((n, 2)) < 0.5)[..., None]
    sc.update(man_ticks=pick([0, 0, 4], np.int32, (n, 2)),
              man_count=pick([0, 1, 2], np.int32, (n, 2)),
              noprog=pick([0, 19, 20, 24, 25, 39, 40, 49, 50, 80], np.int32,
                          (n, 2)),
              best=pick([0.02, 0.05, 0.3, np.inf], np.float32, (n, 2)),
              d=pick([0.01, 0.04, 0.3], np.float32, (n, 2)),
              wp=jnp.where(near, ee + 0.01, ee + jnp.asarray([0.0, 0.3,
                                                               0.0])))
    cfg = dict(sc["cfg"])
    cfg.update(man_scored=pick([0.0, 1.0], np.float32),
               push_relax_global=pick([0.0, 1.0], np.float32),
               push_relax_metric=pick([0.0, 1.0], np.float32),
               hold_boost=pick([1.0, 2.0], np.float32),
               push_first_only=pick([0.0, 1.0], np.float32),
               man_budget_late=pick([0.0, 1.0], np.float32))
    sc["cfg"] = cfg
    # goals: half the envs with the arms' goals pulled between the EEs
    # (contested; the two arms' distances kept apart, so that rounding in
    # FK cannot decide which is farther), and env 0's L goal on its EE
    goal = jnp.where(jnp.asarray(rng.random(n) < 0.5)[:, None, None],
                     0.5 * (ee[:, :1] + ee[:, 1:]) + jnp.asarray(
                         [[[0.0, 0.05, 0.0], [0.0, -0.08, 0.0]]]),
                     states.sim.goal)
    goal = goal.at[0, 0].set(ee[0, 0])
    return dataclasses.replace(
        states, sim=dataclasses.replace(states.sim, goal=goal),
        scratch=sc, no_progress=pick([0, 60, 119, 120], np.int32),
        goal_best=pick([0.05, 0.3, np.inf], np.float32),
        phase=pick([0, 0, 7], np.int32), steps=pick([3, 8, 16], np.int32))


def _jax_jitter(keys):
    return np.stack([_unit(jax.random.split(k)[1], (2, 3)) for k in keys])


def test_pre_tick_matches_jax(randomized, monkeypatch):
    """pre_tick on mixed states, fed JAX's jitter draws: triggers, timers,
    counts, the stall windows exactly; waypoints (station, or the best of
    the scored candidates) and distances to float32 rounding."""
    jenv, env, states, _, _ = randomized
    for seed in range(3):
        mixed = _mixed(jenv, states, np.random.default_rng(seed))
        want = jax.jit(jax.vmap(jenv.pre_tick))(mixed)
        with monkeypatch.context() as m:
            m.setattr(torch, "rand", Draws(_jax_jitter(mixed.key)))
            got = env.pre_tick(port_state(mixed))
        for k in ("man_ticks", "man_count", "noprog"):
            np.testing.assert_array_equal(got.scratch[k].numpy(),
                                          np.asarray(want.scratch[k]),
                                          err_msg=k)
        for k in ("wp", "best", "d"):
            np.testing.assert_allclose(got.scratch[k].numpy(),
                                       np.asarray(want.scratch[k]),
                                       atol=ATOL, rtol=1e-6, err_msg=k)
        np.testing.assert_array_equal(got.no_progress.numpy(),
                                      np.asarray(want.no_progress))
        np.testing.assert_array_equal(got.goal_best.numpy(),
                                      np.asarray(want.goal_best))
        fired = np.asarray(want.scratch["man_count"]
                           > mixed.scratch["man_count"])
        assert fired.any() and not fired.all()


def test_bind_matches_jax(randomized):
    """The state-aware bind on mixed states: per-arm goals (or waypoints),
    push and hold gains, and each arm's obstacle relax and margin equal
    JAX's per env."""
    jenv, env, states, params, tparams = randomized
    mixed = _mixed(jenv, states, np.random.default_rng(4))
    want = jax.vmap(lambda s: jenv.bind_params(params, s.sim, jenv.policies,
                                               s))(mixed)
    tstate = port_state(mixed)
    got = base.call_bind(env.bind_params, tparams, tstate.sim, env.policies,
                         tstate)
    checked = 0
    for p, g, w in zip(env.policies, got, want):
        for k, wv in w.items():
            gv = g[k]
            gv = (gv.numpy() if isinstance(gv, torch.Tensor)
                  else np.asarray(gv))
            np.testing.assert_allclose(
                np.broadcast_to(gv, np.asarray(wv).shape), np.asarray(wv),
                rtol=1e-6, atol=ATOL, err_msg=f"{p.name}.{k}")
            checked += 1
    assert checked >= 40
    names = [p.name for p in env.policies]
    for name in ("attractor_L", "collision_avoidance_R"):
        i = names.index(name)
        gains = np.asarray(want[i]["accel_p_gain" if "attr" in name
                                  else "repulsion_gain"])
        assert len(set(gains.tolist())) > 1          # per env


def test_on_solved_and_stuck_fn_match_jax(randomized, monkeypatch):
    """on_solved fed JAX's goal draws: only the timed-out arms' goals are
    new (both where neither timed out), each clear of the obstacles and the
    other arm's goal as JAX draws it; the arms' budgets and windows reset;
    phase = steps. stuck_fn: the per-arm windows and the backstop."""
    jenv, env, states, _, _ = randomized
    mixed = _mixed(jenv, states, np.random.default_rng(5))
    want = jax.vmap(jenv.on_solved)(mixed)
    uL, uR = [], []
    for key in mixed.key:
        kL, kR = jax.random.split(jax.random.split(key)[1])
        uL.append(_unit(kL, (8, 3)))
        uR.append(_unit(kR, (8, 3)))
    monkeypatch.setattr(torch, "rand", Draws(uL, uR))
    got = env.on_solved(port_state(mixed))
    np.testing.assert_allclose(got.sim.goal.numpy(), np.asarray(want.sim.goal),
                               atol=ATOL)
    kept = np.asarray(want.sim.goal) == np.asarray(mixed.sim.goal)
    assert kept.all(axis=-1).any() and not kept.all()
    for k in ("man_ticks", "man_count", "noprog", "best", "d", "wp"):
        np.testing.assert_array_equal(got.scratch[k].numpy(),
                                      np.asarray(want.scratch[k]), err_msg=k)
    np.testing.assert_array_equal(got.phase.numpy(), np.asarray(want.phase))
    stuck = env.stuck_fn(port_state(mixed)).numpy()
    np.testing.assert_array_equal(stuck,
                                  np.asarray(jax.vmap(jenv.stuck_fn)(mixed)))
    assert stuck.any() and not stuck.all()


def test_solved_and_progress_distance_match_jax(randomized):
    """is_solved_fn (both EEs within 3 cm) and goal_distance_fn (the worse
    arm) against JAX's, with env 0's goals put on its EEs."""
    jenv, env, states, _, _ = randomized
    ee = jax.vmap(lambda q: jnp.stack([
        JK.fk_frame(jenv.model, q, jenv.model.frame_index(e))[:3, 3]
        for e in (jdual.EE_L, jdual.EE_R)]))(states.sim.q)
    sim = dataclasses.replace(states.sim,
                              goal=states.sim.goal.at[0].set(ee[0] + 0.01))
    tsim = port_state(dataclasses.replace(states, sim=sim)).sim
    solved = env.is_solved_fn(env, tsim).numpy()
    np.testing.assert_array_equal(
        solved, np.asarray(jax.vmap(lambda s: jenv.is_solved_fn(jenv, s))(
            sim)))
    assert solved[0] and not solved[1:].any()
    np.testing.assert_allclose(
        env.goal_distance_fn(env, tsim).numpy(),
        np.asarray(jax.vmap(lambda s: jenv.goal_distance_fn(jenv, s))(sim)),
        atol=ATOL)


def test_context_fn_matches_jax(randomized):
    """The randomized scene's context: the obstacle pairs (capsule), each
    arm's rows of them and the inter-arm entries, against JAX's per env."""
    jenv, env, states, _, _ = randomized
    want = jax.vmap(lambda s: jenv.context_fn(jenv.model, s))(states.sim)
    got = env.context_fn(env.model, port_state(states).sim)
    for key in ("__pairs_L__", "__pairs_R__", "inter_arm:L_panda_hand_joint"):
        for field, w in want[key].items():
            np.testing.assert_allclose(got[key][field].numpy(), np.asarray(w),
                                       atol=1e-5, err_msg=f"{key}.{field}")
    assert got["__pairs_L__"]["distance"].shape == (B, 10, 8)


def test_hull_tier_takes_the_per_env_context():
    """A scene with a context_fn never takes the batched hull path: no warm
    carry at B = 128 and the JAX package's hull_warm_iters = 8 unread."""
    env = envs.make(SCENE, device="cpu")
    env.collision_geometry = "hull"
    assert env.hull_warm_iters == 8
    state = envs.make_batched_reset(env, 128)()
    assert state.gjk_warm is None
    assert not base._batched_hull(env, state)


def test_state_from_numpy_round_trips_a_jax_dual_state(randomized):
    """convert.state_from_numpy takes the (B, 2, 3) goals and the dual
    scratch (per-arm int counters, float waypoints and distances, the
    knobs) of a JAX state: every leaf back equal, in its dtype."""
    _, _, states, _, _ = randomized
    leaves = jax_leaves(states)
    state = convert.state_from_numpy(leaves, "cpu")
    assert state.sim.goal.shape == (B, 2, 3)
    np.testing.assert_array_equal(state.sim.goal.numpy(), leaves["goal"])
    for k, v in leaves["scratch"].items():
        if k == "cfg":
            for c, x in v.items():
                np.testing.assert_array_equal(
                    state.scratch["cfg"][c].numpy(), x)
            continue
        assert state.scratch[k].dtype == (torch.int32 if v.dtype.kind == "i"
                                          else torch.float32), k
        np.testing.assert_array_equal(state.scratch[k].numpy(), v)
    assert state.sim.obstacles.kinds == tuple(leaves["obstacles"]["kinds"])


def test_dual_handover_golden_on_cpu():
    """tests/golden/dual_handover_30t.npz: 30 ticks at B = 2 on the CPU, q
    within tests/test_envs.py's 1e-4 and solved_count exact."""
    import os
    data = np.load(os.path.join(os.path.dirname(__file__), "golden",
                                "dual_handover_30t.npz"))
    env = envs.make("dual_panda/handover", device="cpu")
    final, _ = envs.make_batched_rollout(env, 30, with_aux=False)(
        envs.make_batched_reset(env, 2)(), env.gather_params())
    np.testing.assert_allclose(final.sim.q.numpy(), data["q"],
                               atol=GOLDEN_ATOL)
    np.testing.assert_array_equal(final.solved_count.numpy(),
                                  data["solved_count"])


def test_handover_turn_swaps_through_take_row():
    """on_solved advances the phase and takes the next turn's goals from
    HANDOVER_PHASES (phase odd: R at the centre)."""
    env = envs.make("dual_panda/handover", device="cpu")
    state = envs.make_batched_reset(env, 3)()
    state = dataclasses.replace(state, phase=torch.tensor([0, 1, 4],
                                                          dtype=torch.int32))
    out = env.on_solved(state)
    np.testing.assert_array_equal(out.phase.numpy(), [1, 2, 5])
    want = dual.HANDOVER_PHASES[np.array([1, 0, 1])]
    np.testing.assert_array_equal(out.sim.goal.numpy(), want)
