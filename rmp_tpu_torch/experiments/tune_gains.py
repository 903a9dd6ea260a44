"""Gradient-based policy-gain tuning through the differentiable rollout.

The port's `experiments/tune_gains.py`. FK (K3 and its recomputed plain
vjp), the taskmaps, the policies, the resolve (K1's closed-form backward
where it runs), the hull distances (K4's envelope rule) and the integrator
are all differentiable, so the gradient of a rollout loss with respect to
the policy gains is one backward pass.

Demo: tune the first policy's attractor gains (log-space) to minimise the
mean final EE-to-goal distance plus an effort penalty on franka/01.

Usage: python -m rmp_tpu_torch.experiments.tune_gains [--steps 30]
           [--batch 16] [--ticks 60] [--cpu] [--remat] [--geometry hull]
"""
from __future__ import annotations

import argparse

import torch

from rmp_tpu_torch import envs as envs_mod
from rmp_tpu_torch.experiments.common import device_of, leaves, value_and_grad


def make_loss(env, batch: int, n_ticks: int, seed: int = 0,
              remat: bool = False, fused_resolve: bool = False,
              states=None):
    """(loss(theta), theta, gain keys): theta = {'log_p', 'log_d'} are the
    log gains of the first policy's attractor, over the episodes `states`
    (default: the env's reset of `batch` envs with `seed`). The rollout is
    the JAX trainer's: make_rollout (its per-env semantics, the JAX
    package's make_batched_rollout with fused_resolve=False);
    fused_resolve=True takes make_batched_rollout, the whole batch resolved
    at once (K1 for 'solve'). remat: each tick recomputed in the
    backward."""
    if states is None:
        states = envs_mod.make_batched_reset(env, batch, seed)()
    make = (envs_mod.make_batched_rollout if fused_resolve
            else envs_mod.make_rollout)
    rollout = make(env, n_ticks, remat=remat)
    base = env.gather_params()
    # which policy holds the attractor gains (the first in these scenes)
    gain_keys = (("accel_p_gain", "accel_d_gain")
                 if "accel_p_gain" in base[0] else ("alpha", "beta"))

    def loss(theta):
        prm = dict(base[0])
        prm[gain_keys[0]] = torch.exp(theta["log_p"])
        prm[gain_keys[1]] = torch.exp(theta["log_d"])
        final, aux = rollout(states, (prm,) + tuple(base[1:]))
        d_final = torch.linalg.vector_norm(aux["ee"][:, -1] - final.sim.goal,
                                           dim=-1)
        effort = torch.mean(aux["qdd"] ** 2)
        return torch.mean(d_final) + 1e-3 * effort

    like = dict(dtype=states.sim.q.dtype, device=states.sim.q.device)
    init = {"log_p": torch.log(torch.tensor(float(base[0][gain_keys[0]]),
                                            **like)),
            "log_d": torch.log(torch.tensor(float(base[0][gain_keys[1]]),
                                            **like))}
    return loss, init, gain_keys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="franka/01_target_rmp_only")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ticks", type=int, default=60)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each tick in the backward (long-horizon "
                         "tuning)")
    ap.add_argument("--geometry", choices=("capsule", "hull"),
                    default="capsule",
                    help="link collision geometry (hull = exact mesh-hull "
                         "GJK through K4, differentiable by its envelope "
                         "rule)")
    args = ap.parse_args(argv)

    env = envs_mod.make(args.env, device=device_of(args.cpu))
    env.collision_geometry = args.geometry
    env.resolve_method = "cholesky"
    env.on_solved = None          # keep the goal fixed while tuning
    loss, theta, keys = make_loss(env, args.batch, args.ticks,
                                  remat=args.remat)
    theta = leaves(theta)
    opt = torch.optim.Adam(list(theta.values()), lr=args.lr)
    for step in range(args.steps):
        val, grad = value_and_grad(loss, theta)
        for k, p in theta.items():
            p.grad = grad[k]
        opt.step()
        gains = {k: float(torch.exp(theta[t].detach()))
                 for k, t in zip(keys, ("log_p", "log_d"))}
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:3d}  loss {float(val):.4f}  "
                  f"{keys[0]} {gains[keys[0]]:.4f}  "
                  f"{keys[1]} {gains[keys[1]]:.4f}")
    tuned = {k: float(torch.exp(theta[t].detach()))
             for k, t in zip(keys, ("log_p", "log_d"))}
    print("tuned gains:", tuned)
    return tuned


if __name__ == "__main__":
    main()
