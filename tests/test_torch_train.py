"""The port's trainers (rmp_tpu_torch/experiments/) against the JAX
package's (experiments/train_neural_rmp.py, train_neural_clutter.py) on the
same nets and episodes: the reach trainer's loss and gradient at init, the
clutter trainer's aggregation of per-env gradients (its gradients against
JAX's vmap(grad): tests/test_torch_train_clutter.py), the optimizer (optax's schedule, clip and Adam) step by step, checkpoints and
resume, the .npz round trip, and tests/test_neural.py's descent test.

The trainers are not held to JAX's numbers over many steps: optax and
torch.optim round differently, and the rollouts' float32 chaos grows
their gaps."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from experiments import train_neural_rmp as jreach  # noqa: E402
from rmp_tpu.envs import neural_reach as jneural_reach  # noqa: E402
from rmp_tpu.policies import neural as jneural  # noqa: E402
from rmp_tpu_torch import convert, envs  # noqa: E402
from rmp_tpu_torch.envs.neural_reach import make_neural_env  # noqa: E402
from rmp_tpu_torch.experiments import common  # noqa: E402
from rmp_tpu_torch.experiments import train_neural_clutter as clutter  # noqa: E402
from rmp_tpu_torch.experiments import train_neural_rmp as reach  # noqa: E402
from rmp_tpu_torch.policies import neural  # noqa: E402
from rmp_tpu_torch.utils import checkpoint  # noqa: E402
from test_torch_scenes import jax_state_leaves  # noqa: E402

torch.set_num_threads(1)


def grads_close(got: dict, want: dict, rtol: float):
    """Every leaf within rtol x max(1e-3, max|JAX's leaf|)."""
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        scale = max(1e-3, float(np.abs(w).max()))
        err = float(np.abs(got[k].numpy() - w).max())
        assert err <= rtol * scale, (k, err, scale)


def test_reach_trainer_loss_and_gradient_at_init_match_jax():
    """Batch 4, 4 ticks, hidden 6, JAX's net and episodes: the loss within
    1e-6 and every weight's gradient within 1e-4 of JAX's (measured on the
    CPU host: the loss 1.2e-7 apart, the gradients 1.2e-7 relative)."""
    jenv = jreach.make_neural_env(jax.random.PRNGKey(0), hidden=(6,))
    jloss, _, jstates, jbase = jreach.make_loss(jenv, 4, 4)
    jnet = jbase[0]["net"]
    v_jax, g_jax = jax.jit(jax.value_and_grad(jloss))(jnet)
    net = convert.net_from_numpy(jax.tree.map(np.asarray, jnet), "cpu")
    env = make_neural_env("cpu", net=net, hidden=(6,))
    states = convert.state_from_numpy(
        jax.tree.map(np.asarray, jax_state_leaves(jstates)), "cpu")
    loss, _, _, base = reach.make_loss(env, 4, 4, states=states)
    v, g = common.value_and_grad(loss, common.leaves(base[0]["net"]))
    assert abs(float(v) - float(v_jax)) < 1e-6, (float(v), float(v_jax))
    grads_close(g, g_jax, 1e-4)


def test_clipped_mean_gradient_drops_and_clips():
    """A non-finite env is dropped, a large gradient clipped to env_clip,
    the mean over the kept envs (the JAX trainer's rule, by hand)."""
    g = {"w0": torch.tensor([[3.0, 4.0], [0.3, 0.4], [float("nan"), 1.0]]),
         "b0": torch.zeros(3, 1)}
    vals = torch.tensor([1.0, 2.0, 3.0])
    val, grad, gnorm, dropped = clutter.clipped_mean_gradient(vals, g, 2.5)
    torch.testing.assert_close(grad["w0"], torch.tensor([1.8, 2.4]) / 2)
    assert float(val) == 1.5 and abs(float(dropped) - 1 / 3) < 1e-7
    torch.testing.assert_close(gnorm, torch.tensor(1.5))


@pytest.mark.parametrize("steps", [10, 60, 300])
def test_schedule_is_optax(steps):
    """Hold for 60%, then cosine to alpha = 0.05, at every update count
    (and past the end), within float32 rounding of optax's."""
    hold = int(steps * 0.6)
    sched = optax.join_schedules(
        [optax.constant_schedule(3e-3),
         optax.cosine_decay_schedule(3e-3, max(steps - hold, 1),
                                     alpha=0.05)], [hold])
    mine = common.schedule(3e-3, steps)
    for count in range(steps + 5):
        np.testing.assert_allclose(mine(count), float(sched(count)),
                                   rtol=1e-6, err_msg=str(count))


def test_optimizer_steps_are_optax():
    """Four updates of chain(clip_by_global_norm(1), adam(schedule))
    against the port's Trainer on the same gradients (the first two
    clipped, the others not), at lr 0.1: parameters within 1e-5 of optax's
    after each (float32 Adam in both, rounded apart; measured on the CPU
    host 7.2e-7 after the first update, 2.6e-6 after the fourth)."""
    rng = np.random.default_rng(0)
    params = {"w0": rng.normal(size=(3, 4)).astype(np.float32),
              "b0": rng.normal(size=4).astype(np.float32)}
    steps = 10
    hold = int(steps * 0.6)
    sched = optax.join_schedules(
        [optax.constant_schedule(0.1),
         optax.cosine_decay_schedule(0.1, steps - hold, alpha=0.05)], [hold])
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(sched))
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    net = common.leaves({k: torch.tensor(v) for k, v in params.items()})
    trainer = common.Trainer(net, 0.1, steps, 1.0)
    for count, scale in enumerate((5.0, 2.0, 0.1, 0.2)):
        g = {k: (rng.normal(size=v.shape) * scale).astype(np.float32)
             for k, v in params.items()}
        updates, state = opt.update(jax.tree.map(jnp.asarray, g), state)
        jp = optax.apply_updates(jp, updates)
        trainer.update({k: torch.tensor(v) for k, v in g.items()}, count)
        for k in params:
            np.testing.assert_allclose(net[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-5,
                                       err_msg=f"{k} {count}")


def test_clip_is_optax_rule():
    """g as it is below the bound, (g / |g|) * c above it (no +1e-6)."""
    g = {"a": torch.tensor([3.0, 4.0])}
    torch.testing.assert_close(common.clip_by_global_norm(g, 10.0)["a"],
                               g["a"])
    torch.testing.assert_close(common.clip_by_global_norm(g, 1.0)["a"],
                               torch.tensor([0.6, 0.8]))


def test_trainer_checkpoint_resume_equivalence(tmp_path):
    """tests/test_neural.py's test on the port: a run stopped by
    --stop-after 2 and continued with --resume saves the same weights as
    the unbroken run (atol 1e-7, as JAX's)."""
    straight, resumed = tmp_path / "straight.npz", tmp_path / "resumed.npz"
    ckpt = tmp_path / "train.ckpt"
    common_args = ["--cpu", "--batch", "4", "--ticks", "4", "--steps", "4",
                   "--hidden", "6", "--seed", "0"]
    reach.main(common_args + ["--save", str(straight)])
    assert reach.main(common_args + ["--ckpt", str(ckpt),
                                     "--stop-after", "2"]) is None
    assert ckpt.exists()
    reach.main(common_args + ["--ckpt", str(ckpt), "--resume",
                              "--save", str(resumed)])
    a, b = np.load(straight), np.load(resumed)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-7,
                                   err_msg=k)


def test_state_checkpoint_round_trip(tmp_path):
    """save_checkpoint / restore_checkpoint of an EnvState: every tensor
    leaf equal, the scratch tree and the resampling generator's state
    restored (the restored generator draws what the saved one would)."""
    env = envs.make("franka/randomized_cluttered", device="cpu")
    states = envs.make_batched_reset(env, 3, seed=5)()
    states, _ = envs.make_batched_rollout(env, 2)(states,
                                                  env.gather_params())
    path = str(tmp_path / "state.ckpt")
    checkpoint.save_checkpoint(path, states)
    like = envs.make_batched_reset(env, 3, seed=9)()
    back = checkpoint.restore_checkpoint(path, like)
    for a, b in zip(checkpoint._leaves(states), checkpoint._leaves(back)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert back.sim.obstacles.kinds == like.sim.obstacles.kinds
    want = torch.rand(4, generator=states.rng)
    assert torch.equal(torch.rand(4, generator=back.rng), want)


def test_train_checkpoint_is_atomic_and_restores(tmp_path):
    path = str(tmp_path / "t.ckpt")
    net = common.leaves({"w0": torch.ones(2, 3), "b0": torch.zeros(3)})
    trainer = common.Trainer(net, 1e-2, 10, 1.0)
    trainer.update({"w0": torch.ones(2, 3), "b0": torch.ones(3)}, 0)
    checkpoint.save_train_checkpoint(path, 1, net, trainer.opt.state_dict(),
                                     0.5, {k: v * 2 for k, v in net.items()})
    assert not os.path.exists(path + ".tmp")
    step, saved, opt_state, best_val, best = \
        checkpoint.restore_train_checkpoint(path, net)
    assert step == 1 and best_val == 0.5
    for k in net:
        assert torch.equal(saved[k], net[k].detach())
        assert torch.equal(best[k], 2 * net[k].detach())
    assert opt_state["state"][0]["step"] == trainer.opt.state_dict()[
        "state"][0]["step"]


def test_net_to_numpy_round_trip_loads_in_jax(tmp_path):
    """net_to_numpy inverts net_from_numpy, and a port-saved .npz loads in
    the JAX package (`neural_reach.load_trained_net`) and gives the port's
    forward there (within 1e-6)."""
    gen = torch.Generator().manual_seed(4)
    net = neural.mlp_init(gen, (6, 8, 8, neural.head_sizes(3)))
    arrays = convert.net_to_numpy(net)
    back = convert.net_from_numpy(arrays, "cpu")
    assert all(torch.equal(back[k], net[k]) for k in net)
    path = str(tmp_path / "net.npz")
    np.savez(path, **arrays)
    jnet = jneural_reach.load_trained_net(path)
    x = np.random.default_rng(1).normal(size=(5, 7, 6)).astype(np.float32)
    want = np.asarray(jneural.mlp_apply(jnet, jnp.asarray(x)))
    got = neural.mlp_apply(net, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_mlp_apply_takes_per_env_replicas():
    """A net whose weights carry a leading batch axis applies env b's
    weights to env b's features, as mlp_apply per env does."""
    gen = torch.Generator().manual_seed(6)
    nets = [neural.mlp_init(gen, (3, 5, 2)) for _ in range(4)]
    batched = {k: torch.stack([n[k] for n in nets]) for k in nets[0]}
    h = torch.randn(4, 7, 3, generator=gen)
    got = neural.mlp_apply(batched, h)
    for b in range(4):
        torch.testing.assert_close(got[b], neural.mlp_apply(nets[b], h[b]),
                                   rtol=0, atol=1e-6)


DESCENT_CASE = os.path.join(os.path.dirname(reach.__file__),
                            "reach_descent_case.npz")


def jax_descent_case() -> dict:
    """tests/test_neural.py's descent test's inputs, as numpy: the net of
    JAX's make_neural_env(PRNGKey(0)) ('net_w0', ...) and the 32 episodes
    of make_loss(env, 32, 25) (EnvState leaves)."""
    jenv = jreach.make_neural_env(jax.random.PRNGKey(0))
    _, _, jstates, jbase = jreach.make_loss(jenv, 32, 25)
    case = {f"net_{k}": np.asarray(v) for k, v in jbase[0]["net"].items()}
    case.update((k, np.asarray(v)) for k, v in
                jax_state_leaves(jstates).items() if v is not None)
    return case


def test_descent_case_file_holds_jax_tests_inputs():
    """rmp_tpu_torch/experiments/reach_descent_case.npz (which the card's
    run of this test reads, having no JAX) equals JAX's inputs bit for
    bit; `python tests/test_torch_train.py` writes it."""
    with np.load(DESCENT_CASE) as saved:
        want = jax_descent_case()
        assert sorted(saved.files) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(saved[k], v, err_msg=k)


def test_training_descends_and_beats_init():
    """tests/test_neural.py's test on the port, from its net and episodes
    (reach_descent_case.npz, JAX's make_neural_env(PRNGKey(0)) and
    make_loss(env, 32, 25)): 25 Adam steps at 3e-3, after which the loss
    is below 0.8 of its first value and the mean final distance has
    improved. (From the port's own init, a torch generator seeded 0, the
    criterion is marginal: 0.8008 of the first value on the CPU host;
    seeds 1-3 give 0.46-0.62.)"""
    with np.load(DESCENT_CASE) as case:
        net = convert.net_from_numpy({k[4:]: case[k] for k in case.files
                                      if k.startswith("net_")}, "cpu")
        states = convert.state_from_numpy(
            {k: case[k] for k in case.files if not k.startswith("net_")},
            "cpu")
    env = make_neural_env("cpu", net=net)
    loss, metrics, _, base = reach.make_loss(env, 32, 25, states=states)
    net = common.leaves(base[0]["net"])
    with torch.no_grad():
        m0 = metrics(net)[1]
    opt = torch.optim.Adam(list(net.values()), lr=3e-3)
    v_first = None
    for _ in range(25):
        v, g = common.value_and_grad(loss, net)
        v_first = float(v) if v_first is None else v_first
        for k, p in net.items():
            p.grad = g[k]
        opt.step()
    with torch.no_grad():
        v_last = float(loss(net))
        m1 = metrics(net)[1]
    assert v_last < 0.8 * v_first, (v_first, v_last)
    assert float(m1["mean_final_dist"]) < float(m0["mean_final_dist"])


def test_yardstick_runs_the_v1_target_policy():
    """hand_designed_yardstick swaps the neural leaf for the v1 target on
    the same taskmap and episodes, without grad."""
    env = make_neural_env("cpu", gen=torch.Generator().manual_seed(0),
                          hidden=(6,))
    states = envs.make_batched_reset(env, 4, 0)()
    d, solved = reach.hand_designed_yardstick(env, states, 5)
    assert np.isfinite(d) and 0.0 <= solved <= 1.0
    assert env.policies[0].name == "neural_target"


if __name__ == "__main__":
    np.savez(DESCENT_CASE, **jax_descent_case())
    print(f"wrote {DESCENT_CASE}")
