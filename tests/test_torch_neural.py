"""The port's learned RMP leaves and reach scenes (policies/neural.py,
envs/neural_reach.py) against the JAX package: both leaves' (a, M) at
rtol 1e-6 on the same weights (JAX's initialised nets and the committed
assets, carried across by convert.net_from_numpy), the structural checks of
tests/test_neural.py (PSD metric, locality, mask, widths), 5-tick parity of
the two reach scenes from JAX's reset, and the trained-asset behaviour tests
at their sizes. The clutter scene: tests/test_torch_neural_clutter.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu import envs as jenvs
from rmp_tpu.policies import neural as jneural
from rmp_tpu_torch import convert, envs
from rmp_tpu_torch.envs import neural_reach
from rmp_tpu_torch.policies import neural
from test_torch_scenes import assert_tick_parity, port_inputs

torch.set_num_threads(1)

ASSETS = {"two_joint": neural_reach.ASSET,
          "franka": neural_reach.ASSET_FRANKA}
RTOL, ATOL = 1e-6, 1e-6


def t(x):
    return torch.tensor(np.asarray(x, np.float32))


def jax_and_port_net(source, sizes=None, seed=0):
    """(JAX net, port net) of the same weights: a committed asset's, or
    JAX's mlp_init(PRNGKey(seed), sizes) with random biases."""
    if source == "init":
        jnet = jneural.mlp_init(jax.random.PRNGKey(seed), sizes)
        rng = np.random.default_rng(seed)
        jnet = {k: (v if k.startswith("w") else
                    jnp.asarray(rng.normal(size=v.shape) * 0.3, jnp.float32))
                for k, v in jnet.items()}
    else:
        with np.load(source) as data:
            jnet = {k: jnp.asarray(data[k]) for k in data.files}
    net = convert.net_from_numpy(jax.tree.map(np.asarray, jnet), "cpu")
    return jnet, net


def assert_leaf_close(got, want, a_bound):
    """a within rtol 1e-6 plus 1e-6 of the leaf's accel bound a_bound
    (accel_scale, times 1 + repulsion_boost on the obstacle leaf): a is a
    tanh of a float32 MLP output times that bound, and both packages' tanh
    sits ~3e-6 from a float64 run on a bound of 20 (CPU run); M within
    rtol 1e-6, atol 1e-6."""
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL * a_bound)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("source", ["init", "two_joint", "franka"])
def test_attractor_leaf_matches_jax(source):
    """The attractor's (a, M) on 64 envs of 3-D task points and rates
    (per-env goals), against JAX's leaf under vmap, with its feature
    scale."""
    sizes = (6, 32, 32, neural.head_sizes(3))
    jnet, net = jax_and_port_net(ASSETS.get(source, "init"), sizes)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 1, 3)).astype(np.float32)
    xd = (rng.normal(size=(64, 1, 3)) * 2.0).astype(np.float32)
    goal = rng.normal(size=(64, 3)).astype(np.float32)
    scale = [2.0, 2.0, 2.0, 5.0, 5.0, 5.0]
    jpol = jneural.neural_attractor(goal=[0.0, 0.0, 0.0], taskmap=None,
                                    net=jnet, feat_scale=scale)
    pol = neural.neural_attractor(goal=[0.0, 0.0, 0.0], taskmap=None,
                                  net=net, feat_scale=scale)
    want = jax.vmap(lambda g, a, b: jpol.evaluate(
        a, b, params=dict(jpol.params, goal=g)))(goal, x, xd)
    got = pol.accel_metric(dict(pol.params, goal=t(goal)), t(x), t(xd), None)
    assert got[0].shape == (64, 1, 3) and got[1].shape == (64, 1, 3, 3)
    assert_leaf_close(got, want, pol.params["accel_scale"])


@pytest.mark.parametrize("barrier", [False, True])
def test_obstacle_leaf_matches_jax(barrier):
    """The obstacle leaf's (a, M) on the committed clutter asset over
    (B = 16) x (80 pairs) of distances from penetration to beyond the
    support radius, with a mask that zeroes some pairs, in both head
    variants."""
    from rmp_tpu_torch.envs.neural_clutter import ASSET
    jnet, net = jax_and_port_net(ASSET)
    kw = (dict(repulsion_boost=40.0, metric_exploder_std_dev=0.02)
          if barrier else {})
    jpol = jneural.neural_obstacle(taskmap=None, net=jnet, **kw)
    pol = neural.neural_obstacle(taskmap=None, net=net, **kw)
    rng = np.random.default_rng(4)
    x = rng.uniform(-0.05, 0.7, (16, 80, 1)).astype(np.float32)
    xd = rng.normal(size=(16, 80, 1)).astype(np.float32)
    mask = (rng.uniform(size=(16, 80)) > 0.2).astype(np.float32)
    want = jax.vmap(lambda a, b, m: jpol.evaluate(a, b, ctx={"mask": m}))(
        x, xd, mask)
    got = pol.accel_metric(pol.params, t(x), t(xd), {"mask": t(mask)})
    assert got[1].shape == (16, 80, 1, 1)
    assert_leaf_close(got, want, pol.params["accel_scale"]
                      * (1.0 + pol.params["repulsion_boost"]))


def test_chol_and_transparent_init_match_jax():
    rng = np.random.default_rng(5)
    raw = (rng.normal(size=(32, 6)) * 3.0).astype(np.float32)
    np.testing.assert_allclose(neural.chol_from_raw(t(raw), 3).numpy(),
                               np.asarray(jneural._chol_from_raw(raw, 3)),
                               rtol=RTOL, atol=ATOL)
    jnet, net = jax_and_port_net("init", (3, 8, 2))
    got = neural.transparent_obstacle_init(net)
    want = jneural.transparent_obstacle_init(jnet)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_mlp_init_is_glorot_uniform_from_the_generator():
    net = neural.mlp_init(torch.Generator().manual_seed(0), (6, 64, 9))
    again = neural.mlp_init(torch.Generator().manual_seed(0), (6, 64, 9))
    assert sorted(net) == ["b0", "b1", "w0", "w1"]
    for k in net:
        assert torch.equal(net[k], again[k])
    for w, (n_in, n_out) in ((net["w0"], (6, 64)), (net["w1"], (64, 9))):
        lim = np.sqrt(6.0 / (n_in + n_out))
        assert w.shape == (n_in, n_out) and float(w.abs().max()) <= lim
        assert float(w.abs().max()) > 0.8 * lim
    assert float(net["b0"].abs().max()) == 0.0


def test_metric_is_psd_and_symmetric():
    """Any net output gives a symmetric PD metric (the Cholesky head) and a
    tanh-bounded accel."""
    net = neural.mlp_init(torch.Generator().manual_seed(0),
                          (6, 16, neural.head_sizes(3)))
    pol = neural.neural_attractor(goal=[0.5, -0.5, 0.1], taskmap=None,
                                  net=net)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(7, 1, 3, generator=g) * 3.0
    xd = torch.randn(7, 1, 3, generator=g) * 5.0
    a, M = pol.accel_metric(pol.params, x, xd, None)
    assert a.shape == (7, 1, 3) and M.shape == (7, 1, 3, 3)
    torch.testing.assert_close(M, M.transpose(-1, -2), atol=1e-6, rtol=0)
    assert float(torch.linalg.eigvalsh(M.double()).min()) > 0.0
    assert float(a.abs().max()) <= pol.params["accel_scale"]


def test_head_width_validation():
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="head_sizes"):
        neural.neural_attractor(goal=[0.0, 0.0, 0.0], taskmap=None,
                                net=neural.mlp_init(g, (6, 16, 5)))
    with pytest.raises(ValueError, match="OBSTACLE_FEATURES"):
        neural.neural_obstacle(taskmap=None,
                               net=neural.mlp_init(g, (5, 8, 2)))
    with pytest.raises(ValueError, match="output width"):
        neural.neural_obstacle(
            taskmap=None,
            net=neural.mlp_init(g, (neural.OBSTACLE_FEATURES, 8, 3)))


def test_neural_obstacle_locality_and_mask():
    """Whatever the weights: the metric is exactly zero beyond the support
    radius and positive within, the accel within accel_scale x (1 +
    repulsion_boost) and within 1.01 accel_scale beyond 0.1 m, and a zero
    mask zeroes the metric."""
    net = neural.mlp_init(torch.Generator().manual_seed(0),
                          (neural.OBSTACLE_FEATURES, 16, 2))
    pol = neural.neural_obstacle(taskmap=None, net=net, support_radius=0.5,
                                 repulsion_boost=40.0)
    x = torch.linspace(-0.1, 1.2, 14)[None, :, None]
    xd = torch.randn(1, 14, 1, generator=torch.Generator().manual_seed(1))
    a, M = pol.accel_metric(pol.params, x, xd, None)
    m = M[0, :, 0, 0]
    far = x[0, :, 0] > 0.5
    assert bool((m[far] == 0.0).all()) and bool((m[~far] > 0.0).all())
    cap = pol.params["accel_scale"] * (1.0 + pol.params["repulsion_boost"])
    assert float(a.abs().max()) <= cap
    assert float(a[0, x[0, :, 0] > 0.1].abs().max()) \
        <= pol.params["accel_scale"] * 1.01
    _, M0 = pol.accel_metric(pol.params, x, xd, {"mask": torch.zeros(1, 14)})
    assert bool((M0 == 0.0).all())


@pytest.mark.parametrize("name", ["two_joint/neural_reach",
                                  "franka/neural_reach"])
def test_reach_scene_tick_parity_with_jax(name):
    """5 ticks at B = 8 from JAX's reset (its goals), the trained weights
    carried by params_from_numpy, against JAX's batched rollout
    ('cholesky', max_qdd 100); no env reaches its goal in these ticks."""
    jenv = jenvs.make(name)
    states = jenvs.make_batched_reset(jenv, 8)(jax.random.PRNGKey(5))
    params = jenv.gather_params()
    jfinal, jaux = jax.jit(jenvs.make_batched_rollout(jenv, 5))(states,
                                                                params)
    env, state, tparams = port_inputs(name, states, params)
    assert env.resolve_method == jenv.resolve_method == "cholesky"
    net = env.policies[0].params["net"]
    for k, v in tparams[0]["net"].items():
        assert torch.equal(v, net[k])        # the asset, carried both ways
    final, aux = envs.make_batched_rollout(env, 5)(state, tparams)
    assert not aux["solved"].any() and not np.asarray(jaux["solved"]).any()
    assert_tick_parity(aux, jaux, final, jfinal)


def test_reset_draws_goals_in_the_goal_space():
    """Each env draws its own goal at reset from the scene's space: the
    two-joint robot's box, the Panda's cylinder (radius 0.4-0.9 m, z in
    [0, 1]); a seed repeats its goals."""
    env = envs.make("two_joint/neural_reach", device="cpu")
    goal = env.reset(256, 3).sim.goal.numpy()
    lo, hi = np.asarray(neural_reach.GOAL_LOW), np.asarray(
        neural_reach.GOAL_HIGH)
    assert ((goal >= lo - 1e-6) & (goal <= hi + 1e-6)).all()
    assert np.unique(goal[:, 0]).size == 256
    np.testing.assert_array_equal(goal, env.reset(256, 3).sim.goal.numpy())
    goal = envs.make("franka/neural_reach", device="cpu").reset(
        256, 3).sim.goal.numpy()
    r = np.linalg.norm(goal[:, :2], axis=1)
    assert ((r >= 0.4 - 1e-6) & (r <= 0.9 + 1e-6)).all()
    assert ((goal[:, 2] >= 0.0) & (goal[:, 2] <= 1.0)).all()


def test_trained_asset_scenario_reaches():
    """tests/test_neural.py's criterion: the trained two-joint attractor
    ends within 5 cm (mean, in x and y) of 32 unseen goals after 80
    ticks."""
    env = envs.make("two_joint/neural_reach", device="cpu")
    states = envs.make_batched_reset(env, 32, seed=7)()
    final, aux = envs.make_batched_rollout(env, 80)(states,
                                                    env.gather_params())
    d = np.linalg.norm(aux["ee"][:, -1, :2].numpy()
                       - final.sim.goal[:, :2].numpy(), axis=-1)
    assert np.isfinite(d).all()
    assert d.mean() < 0.05, f"trained policy regressed: mean dist {d.mean()}"


def test_trained_franka_asset_scenario_reaches():
    """tests/test_neural.py's criterion: the trained Panda attractor ends
    within 0.1 m (mean) of 16 unseen goals after 60 ticks."""
    env = envs.make("franka/neural_reach", device="cpu")
    states = envs.make_batched_reset(env, 16, seed=11)()
    final, aux = envs.make_batched_rollout(env, 60)(states,
                                                    env.gather_params())
    d = np.linalg.norm(aux["ee"][:, -1].numpy() - final.sim.goal.numpy(),
                       axis=-1)
    assert np.isfinite(d).all()
    assert d.mean() < 0.1, f"trained franka policy regressed: {d.mean()}"


def test_untrained_net_rollout_finite():
    """A fresh net (make_neural_env without weights) runs in the batched
    rollout with finite outputs, as in tests/test_neural.py."""
    env = neural_reach.make_neural_env(
        "cpu", gen=torch.Generator().manual_seed(3))
    states = envs.make_batched_reset(env, 4)()
    final, aux = envs.make_batched_rollout(env, 3)(states,
                                                   env.gather_params())
    assert bool(torch.isfinite(final.sim.q).all())
    assert bool(torch.isfinite(aux["qdd"]).all())
