"""The port's clutter trainer (rmp_tpu_torch/experiments/
train_neural_clutter.py) against the JAX package's
(experiments/train_neural_clutter.py): the per-env gradients of one
backward through per-env replicas of the net against JAX's vmap(grad) of
the per-env rematerialized rollout, env by env and after the per-env clip
and mean. Its own file: JAX compiles that vmap(grad) for ~45 s."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from rmp_tpu import envs as jenvs
from rmp_tpu.envs import neural_clutter as jclutter
from rmp_tpu.policies import neural as jneural
from rmp_tpu_torch import convert, envs
from rmp_tpu_torch.envs.neural_clutter import make_neural_clutter_env
from rmp_tpu_torch.experiments import train_neural_clutter as clutter
from test_torch_randomized import jax_leaves
from test_torch_train import grads_close

torch.set_num_threads(1)


CLUTTER_B, CLUTTER_T = 3, 3
WEIGHTS = dict(clear_margin=0.05, pen_margin=0.005, w_collision=10.0,
               w_pen=300.0, w_effort=1e-4)


def jax_clipped_gradient(jenv, jstates, jparams, jnet, env_clip=3.0):
    """JAX's trainer: vmap(value_and_grad(env_loss)) of the per-env
    rematerialized rollout and its aggregation (train_neural_clutter.py's
    `vg`), on the obstacle leaf's net."""
    single = jenvs.make_rollout(jenv, CLUTTER_T, remat=True)
    slot = len(jparams) - 1
    w = WEIGHTS

    def env_loss(net, state):
        p = jparams[:slot] + (dict(jparams[slot], net=net),)
        f, a = single(state, p)
        d_traj = jnp.linalg.norm(a["ee"] - f.sim.goal[None, :], axis=-1)
        reach_ = jnp.mean(d_traj[d_traj.shape[0] // 2:])
        hinge = jnp.maximum(w["clear_margin"] - a["obst_d"], 0.0)
        collision = jnp.mean(jnp.sum(hinge * hinge, axis=(-2, -1)))
        pen_h = jnp.maximum(w["pen_margin"] - a["obst_d"], 0.0)
        penetration = jnp.mean(jnp.sum(pen_h * pen_h, axis=(-2, -1)))
        effort = jnp.mean(a["qdd"] ** 2)
        return (reach_ + w["w_collision"] * collision
                + w["w_pen"] * penetration + w["w_effort"] * effort)

    @jax.jit
    def vg(net, states):
        vals, grads = jax.vmap(jax.value_and_grad(env_loss),
                               in_axes=(None, 0))(net, states)
        leaf_ok = [jnp.all(jnp.isfinite(g), axis=tuple(range(1, g.ndim)))
                   for g in jax.tree.leaves(grads)]
        ok = jnp.stack(leaf_ok, axis=0).all(axis=0) & jnp.isfinite(vals)
        norms = jnp.sqrt(sum(
            jnp.sum(jnp.where(jnp.isfinite(g), g, 0.0) ** 2,
                    axis=tuple(range(1, g.ndim)))
            for g in jax.tree.leaves(grads)))
        scale = jnp.where(ok, jnp.minimum(1.0, env_clip / (norms + 1e-12)),
                          0.0)
        n_ok = jnp.maximum(jnp.sum(ok.astype(jnp.float32)), 1.0)
        grad = jax.tree.map(
            lambda g: jnp.einsum(
                "b...,b->...", jnp.where(jnp.isfinite(g), g, 0.0), scale)
            / n_ok, grads)
        val = jnp.sum(jnp.where(ok, vals, 0.0)) / n_ok
        return val, grad, vals, grads
    return vg(jnet, jstates)


def test_clutter_trainer_per_env_gradient_matches_jax_vmap_grad():
    """Batch 3, 3 ticks, hidden 6, a random (not transparent) net so every
    leaf carries a gradient, JAX's episodes: the port's one backward
    through per-env replicas against JAX's vmap(grad), env by env (each
    env's loss and gradient) and after the per-env clip and mean. The
    losses within 1e-4 relative (measured on the CPU host: 4.8e-7), the
    gradients within 1e-3 x max(1e-3, max|JAX's leaf|) (measured: 3.7e-5
    per env, 1.3e-5 after the aggregation; float32 BPTT through the
    spawns' stiff first ticks amplifies rounding, as in
    tests/test_torch_neural_clutter.py)."""
    jnet = jneural.mlp_init(jax.random.PRNGKey(3),
                            (jneural.OBSTACLE_FEATURES, 6, 2))
    jenv = jclutter.make_neural_clutter_env(net=jnet, hidden=(6,),
                                            train=True)
    jstates = jenvs.make_batched_reset(jenv, CLUTTER_B)(
        jax.random.PRNGKey(0))
    jparams = jenv.gather_params()
    val_j, grad_j, vals_j, grads_j = jax_clipped_gradient(
        jenv, jstates, jparams, jnet)

    net = convert.net_from_numpy(jax.tree.map(np.asarray, jnet), "cpu")
    env = make_neural_clutter_env("cpu", net=net, hidden=(6,), train=True)
    states = convert.state_from_numpy(jax_leaves(jstates), "cpu")
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       "cpu")
    rollout = envs.make_rollout(env, CLUTTER_T, remat=True)
    slot = len(params) - 1
    # env by env, before the aggregation
    reps = {k: v[None].expand(CLUTTER_B, *v.shape).clone().requires_grad_()
            for k, v in net.items()}
    final, aux = rollout(states, params[:slot]
                         + (dict(params[slot], net=reps),))
    vals = clutter.env_losses(aux, final, **WEIGHTS)
    grads = torch.autograd.grad(vals.sum(), list(reps.values()))
    np.testing.assert_allclose(vals.detach().numpy(), np.asarray(vals_j),
                               rtol=1e-4)
    grads_close(dict(zip(reps, grads)), grads_j, 1e-3)
    val, grad, gnorm, dropped = clutter.per_env_value_and_grad(
        rollout, params, slot, net, states, WEIGHTS, 3.0)
    assert float(dropped) == 0.0 and torch.isfinite(gnorm)
    assert abs(float(val) - float(val_j)) < 1e-4 * max(1.0, abs(float(val_j)))
    grads_close(grad, grad_j, 1e-3)
