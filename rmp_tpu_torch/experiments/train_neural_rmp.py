"""Train a learned (MLP) RMP attractor end to end through the physics.

The port's `experiments/train_neural_rmp.py`. The leaf is
policies/neural.neural_attractor, an MLP mapping (goal - x, ẋ) to a bounded
task-space acceleration and a Cholesky-factored PSD metric. The rollout is
differentiable end to end, so the net trains on the gradient of a rollout
loss over a batch of random goals; the hand-designed v1 target policy on
the same goals is the printed yardstick.

Usage: python -m rmp_tpu_torch.experiments.train_neural_rmp [--steps 60]
           [--batch 128] [--ticks 50] [--cpu] [--remat] [--save w.npz]
           [--ckpt train.ckpt [--resume] [--stop-after N]]

The optimizer is the JAX trainer's: a constant rate for 60% of --steps,
then a cosine decay to 5% of it, optax's global-norm clip (--clip), then
Adam. --ckpt writes an atomic training checkpoint (net, Adam's state, the
best-loss iterate, the loop position) every --ckpt-every steps; --resume
continues the run as if it had not stopped, and --stop-after N time-slices
a long schedule across invocations. --save writes the best iterate in the
committed assets' .npz layout, which either package loads.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from rmp_tpu_torch import envs as envs_mod
from rmp_tpu_torch.convert import net_to_numpy
from rmp_tpu_torch.envs.base import bind_goal
from rmp_tpu_torch.envs.neural_reach import make_neural_env
from rmp_tpu_torch.experiments.common import (Trainer, device_of, leaves,
                                              value_and_grad)
from rmp_tpu_torch.policies import v1
from rmp_tpu_torch.utils.checkpoint import (restore_train_checkpoint,
                                            save_train_checkpoint)


def make_loss(env, batch: int, n_ticks: int, seed: int = 0,
              remat: bool = False, states=None):
    """(loss(net), metrics(net), states, base params) over a fixed batch of
    random-goal episodes (`states`, default the env's reset of `batch`
    envs drawn from `seed`)."""
    if states is None:
        states = envs_mod.make_batched_reset(env, batch, seed)()
    rollout = envs_mod.make_rollout(env, n_ticks, remat=remat)
    base = env.gather_params()
    dims = 2 if env.solved_xy_only else 3

    def metrics(net):
        params = (dict(base[0], net=net),) + tuple(base[1:])
        final, aux = rollout(states, params)
        # dense loss: the distance over the second half of the trajectory,
        # plus terminal-velocity and effort shaping
        d_traj = torch.linalg.vector_norm(
            aux["ee"][..., :dims] - final.sim.goal[:, None, :dims], dim=-1)
        d_final = d_traj[:, -1]
        qd_final = torch.linalg.vector_norm(final.sim.qd, dim=-1)
        effort = torch.mean(aux["qdd"] ** 2)
        loss = (torch.mean(d_traj[:, d_traj.shape[1] // 2:])
                + 0.05 * torch.mean(qd_final ** 2) + 1e-4 * effort)
        return loss, dict(mean_final_dist=torch.mean(d_final),
                          solved=torch.mean((d_final < env.solved_tol)
                                            .to(torch.float32)))

    return (lambda net: metrics(net)[0]), metrics, states, base


@torch.no_grad()
def hand_designed_yardstick(env, states, n_ticks: int):
    """(mean final distance, solved share) of the same episodes under the
    reference-parity v1 target policy on the neural leaf's taskmap."""
    ref_pol = (v1.target_policy(goal=[0.0, 0.0, 0.0],
                                taskmap=env.policies[0].taskmap,
                                alpha=0.1, beta=0.5, c=0.1, name="target",
                                device=env.device),
               env.policies[1])
    ref_env = dataclasses.replace(env, policies=ref_pol,
                                  bind_params=bind_goal(("target",)))
    final, aux = envs_mod.make_rollout(ref_env, n_ticks)(
        states, ref_env.gather_params())
    dims = 2 if env.solved_xy_only else 3
    d = torch.linalg.vector_norm(aux["ee"][:, -1, :dims]
                                 - final.sim.goal[:, :dims], dim=-1)
    return float(torch.mean(d)), float(torch.mean(
        (d < env.solved_tol).to(torch.float32)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--ticks", type=int, default=50)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--clip", type=float, default=1.0,
                    help="global-norm gradient clip (0 disables)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--robot", choices=("two_joint", "franka"),
                    default="two_joint")
    ap.add_argument("--hidden", type=int, nargs="+", default=[32, 32],
                    help="MLP hidden layer widths")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each tick in the backward")
    ap.add_argument("--save", default=None, help="save trained net (.npz)")
    ap.add_argument("--ckpt", default=None,
                    help="training checkpoint file, written atomically "
                         "every --ckpt-every steps and at the end")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true",
                    help="continue from --ckpt if it exists")
    ap.add_argument("--stop-after", type=int, default=0,
                    help="stop this invocation after N optimizer steps "
                         "while keeping the full --steps schedule")
    args = ap.parse_args(argv)

    device = device_of(args.cpu)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    env = make_neural_env(device, gen=gen, robot=args.robot,
                          hidden=tuple(args.hidden))
    loss, metrics, states, base = make_loss(env, args.batch, args.ticks,
                                            seed=args.seed, remat=args.remat)
    net = leaves(base[0]["net"])

    ref_d, ref_solved = hand_designed_yardstick(env, states, args.ticks)
    print(f"hand-designed v1 target policy: mean_final_dist {ref_d:.4f} m, "
          f"solved {ref_solved:.1%}")

    def eval_metrics(n):
        with torch.no_grad():
            return metrics(n)[1]

    trainer = Trainer(net, args.lr, args.steps, args.clip)
    # keep the best-loss weights: late steps can jump basins
    best_val, best_net = float("inf"), {k: v.detach().clone()
                                        for k, v in net.items()}
    start = 0
    if args.ckpt and args.resume and os.path.exists(args.ckpt):
        start, saved, opt_state, best_val, best_net = \
            restore_train_checkpoint(args.ckpt, net)
        with torch.no_grad():
            for k, v in saved.items():
                net[k].copy_(v)
        trainer.opt.load_state_dict(opt_state)
        print(f"resumed {args.ckpt} at step {start}")
    for step in range(start, args.steps):
        val, grad = value_and_grad(loss, net)
        if float(val) < best_val:
            best_val = float(val)
            best_net = {k: v.detach().clone() for k, v in net.items()}
        trainer.update(grad, step)
        if step % 10 == 0 or step == args.steps - 1:
            m = eval_metrics(net)
            print(f"step {step:4d}  loss {float(val):.4f}  "
                  f"mean_final_dist {float(m['mean_final_dist']):.4f} m  "
                  f"solved {float(m['solved']):.1%}")
        done = step + 1
        if args.ckpt and (done % args.ckpt_every == 0 or done == args.steps
                          or done - start == args.stop_after):
            save_train_checkpoint(args.ckpt, done, net,
                                  trainer.opt.state_dict(), best_val,
                                  best_net)
        if args.stop_after and done - start >= args.stop_after:
            print(f"stopping after {args.stop_after} steps "
                  f"(at step {done}/{args.steps})")
            return None

    # the loop scores each net before its update: score the final iterate
    # too, so the last step's net can be the best
    with torch.no_grad():
        val = loss(net)
    if float(val) < best_val:
        best_val = float(val)
        best_net = {k: v.detach().clone() for k, v in net.items()}

    m = eval_metrics(best_net)
    print(f"best: loss {best_val:.4f}  "
          f"mean_final_dist {float(m['mean_final_dist']):.4f} m  "
          f"solved {float(m['solved']):.1%}  "
          f"(vs hand-designed {ref_d:.4f} m)")
    if args.save:
        np.savez(args.save, **net_to_numpy(best_net))
        print(f"saved best net -> {args.save}")
    return best_net


if __name__ == "__main__":
    main()
