"""Train the learned obstacle-avoidance leaf through the cluttered physics.

The port's `experiments/train_neural_clutter.py`. The leaf
(policies/neural.neural_obstacle) shares the production v2 attractor and
damping stack and the grouped per-pair distance taskmap of
franka/randomized_cluttered; only its MLP trains. The loss balances goal
reaching against a light proximity hinge and a heavy penetration hinge on
every (tick, link, obstacle) distance (Env.aux_fn), plus effort. The
hand-designed v2 obstacle leaf on the same episodes is the printed
yardstick.

Usage: python -m rmp_tpu_torch.experiments.train_neural_clutter
           [--steps 300] [--batch 1024] [--ticks 100] [--cpu]
           [--save w.npz] [--ckpt train.ckpt [--resume] [--stop-after N]]

Gradients are taken per env and clipped per env before the batch mean, as
the JAX trainer's vmap(grad) does: BPTT through the stiff closed loop
explodes on a heavy tail of envs, so non-finite env gradients are dropped
and finite ones clipped to --env-clip. The port takes them in one backward
through per-env replicas of the net (each weight a (B, ...) leaf; the envs
do not interact, so each replica's grad is its env's gradient). Every
rollout rematerializes its ticks in the backward. Checkpoints as in
train_neural_rmp; each also records the criterion that scored its best
iterate (--select, --resample-every), and a resume under another one starts
the best again from the restored net.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from rmp_tpu_torch import envs as envs_mod
from rmp_tpu_torch.convert import net_to_numpy
from rmp_tpu_torch.envs import franka
from rmp_tpu_torch.envs.neural_clutter import (clearance_aux,
                                               make_neural_clutter_env)
from rmp_tpu_torch.envs.neural_reach import load_trained_net
from rmp_tpu_torch.experiments.common import Trainer, device_of, leaves
from rmp_tpu_torch.policies import neural as neural_mod
from rmp_tpu_torch.utils.checkpoint import (restore_train_checkpoint,
                                            save_train_checkpoint,
                                            train_checkpoint_meta)


def episode_metrics(env, states, rollout, params, clear_margin: float,
                    pen_margin: float = 0.005):
    """(reach, collision, penetration, effort, metrics) of one batched
    rollout, the batch means of the JAX trainer's terms: the distance to the
    goal over the second half, the squared hinges below clear_margin and
    pen_margin summed over pairs, the mean squared q̈."""
    final, aux = rollout(states, params)
    d_traj = torch.linalg.vector_norm(aux["ee"] - final.sim.goal[:, None, :],
                                      dim=-1)
    reach = torch.mean(d_traj[:, d_traj.shape[1] // 2:])
    hinge = torch.clamp(clear_margin - aux["obst_d"], min=0.0)  # (B,T,L,K)
    collision = torch.mean(torch.sum(hinge * hinge, dim=(-2, -1)))
    pen_h = torch.clamp(pen_margin - aux["obst_d"], min=0.0)
    penetration = torch.mean(torch.sum(pen_h * pen_h, dim=(-2, -1)))
    effort = torch.mean(aux["qdd"] ** 2)
    min_clear = torch.amin(aux["obst_d"], dim=(-2, -1))         # (B, T)
    d_final = d_traj[:, -1]
    mets = dict(
        mean_final_dist=torch.mean(d_final),
        solved=torch.mean((d_final < env.solved_tol).to(torch.float32)),
        # an env penetrated if any tick dipped below -1 cm
        penetrated=torch.mean((torch.amin(min_clear, dim=-1) < -0.01)
                              .to(torch.float32)),
        mean_min_clear=torch.mean(min_clear))
    return reach, collision, penetration, effort, mets


def env_losses(aux, final, clear_margin: float, pen_margin: float,
               w_collision: float, w_pen: float, w_effort: float):
    """(B,) the JAX trainer's per-env loss `env_loss` of each env of a
    batched rollout."""
    d_traj = torch.linalg.vector_norm(aux["ee"] - final.sim.goal[:, None, :],
                                      dim=-1)                    # (B, T)
    reach = torch.mean(d_traj[:, d_traj.shape[1] // 2:], dim=1)
    hinge = torch.clamp(clear_margin - aux["obst_d"], min=0.0)
    collision = torch.mean(torch.sum(hinge * hinge, dim=(-2, -1)), dim=1)
    pen_h = torch.clamp(pen_margin - aux["obst_d"], min=0.0)
    penetration = torch.mean(torch.sum(pen_h * pen_h, dim=(-2, -1)), dim=1)
    effort = torch.mean(aux["qdd"] ** 2, dim=(1, 2))
    return (reach + w_collision * collision + w_pen * penetration
            + w_effort * effort)


def clipped_mean_gradient(vals: torch.Tensor, grads: dict, env_clip: float):
    """The JAX trainer's aggregation of per-env gradients (B, ...) and
    losses (B,): envs with a non-finite loss or gradient are dropped, the
    others' gradients clipped to norm env_clip, then averaged over the
    kept envs. Returns (value, grad, gnorm, dropped share)."""
    keys = sorted(grads)                  # jax.tree.leaves' order of a dict
    B = vals.shape[0]

    def per_env(g, fn):
        return fn(g.reshape(B, -1), dim=1)

    ok = torch.isfinite(vals)
    for k in keys:
        ok = ok & per_env(torch.isfinite(grads[k]), torch.all)
    clean = {k: torch.where(torch.isfinite(g), g, 0.0)
             for k, g in grads.items()}
    norms = torch.sqrt(sum(per_env(clean[k] ** 2, torch.sum) for k in keys))
    scale = torch.where(ok, torch.clamp(env_clip / (norms + 1e-12), max=1.0),
                        0.0)
    n_ok = torch.clamp(torch.sum(ok.to(torch.float32)), min=1.0)
    grad = {k: torch.einsum("b...,b->...", clean[k], scale) / n_ok
            for k in keys}
    gnorm = torch.sqrt(sum(torch.sum(grad[k] * grad[k]) for k in keys))
    val = torch.sum(torch.where(ok, vals, 0.0)) / n_ok
    return val, grad, gnorm, 1.0 - n_ok / B


def per_env_value_and_grad(single_rollout, base, slot: int, net: dict,
                           states, weights: dict, env_clip: float):
    """The clipped mean of per-env gradients of the per-env losses, in one
    backward through per-env replicas of `net`. weights: clear_margin,
    pen_margin, w_collision, w_pen, w_effort."""
    B = states.sim.q.shape[0]
    reps = {k: v.detach()[None].expand(B, *v.shape).clone()
            .requires_grad_() for k, v in net.items()}
    params = base[:slot] + (dict(base[slot], net=reps),)
    final, aux = single_rollout(states, params)
    vals = env_losses(aux, final, **weights)
    grads = torch.autograd.grad(vals.sum(), list(reps.values()))
    return clipped_mean_gradient(vals.detach(), dict(zip(reps, grads)),
                                 env_clip)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--env-clip", type=float, default=3.0,
                    help="per-env gradient norm clip, applied before the "
                         "batch mean (non-finite env grads are dropped)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hidden", type=int, nargs="+", default=[32, 32])
    ap.add_argument("--w-collision", type=float, default=10.0,
                    help="proximity hinge weight (squared hinge below "
                         "--clear-margin, summed over pairs)")
    ap.add_argument("--clear-margin", type=float, default=0.05)
    ap.add_argument("--w-pen", type=float, default=300.0,
                    help="penetration hinge weight (squared hinge below "
                         "--pen-margin)")
    ap.add_argument("--pen-margin", type=float, default=0.005)
    ap.add_argument("--w-effort", type=float, default=1e-4)
    ap.add_argument("--barrier", action="store_true",
                    help="near-contact authority variant (repulsion boost "
                         "+ 1/x metric exploder)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--save", default=None)
    ap.add_argument("--ckpt", default=None,
                    help="training checkpoint file, written atomically "
                         "every --ckpt-every steps and at the end")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true",
                    help="continue from --ckpt if it exists")
    ap.add_argument("--stop-after", type=int, default=0,
                    help="stop this invocation after N optimizer steps "
                         "while keeping the full --steps schedule")
    ap.add_argument("--init-from", default=None,
                    help="warm-start the net from an .npz asset (e.g. the "
                         "committed neural_clutter_franka.npz) instead of "
                         "the transparent init")
    ap.add_argument("--select", choices=("loss", "task"), default="loss",
                    help="best-iterate criterion: 'loss' = lowest training "
                         "(or fixed-eval, with --resample-every) loss; "
                         "'task' = highest solved - penetrated on the fixed "
                         "eval batch")
    ap.add_argument("--resample-every", type=int, default=0,
                    help="redraw the training episode batch every N steps "
                         "(the printed eval metrics stay on the fixed seed "
                         "set); 0 = one fixed batch")
    args = ap.parse_args(argv)

    device = device_of(args.cpu)
    if args.init_from:
        net_init = load_trained_net(args.init_from, device)
        print(f"warm-started net from {args.init_from} "
              f"(--hidden ignored; shapes come from the asset)")
        if not args.barrier:
            print("WARNING: fine-tuning without --barrier: if the asset "
                  "was trained with the barrier head its weights will be "
                  "re-interpreted under the unconstrained head")
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        net_init = neural_mod.transparent_obstacle_init(neural_mod.mlp_init(
            gen, (neural_mod.OBSTACLE_FEATURES, *args.hidden, 2)))
    env = make_neural_clutter_env(device, net=net_init,
                                  hidden=tuple(args.hidden), train=True,
                                  barrier=args.barrier)

    def reset(seed: int):
        return envs_mod.make_batched_reset(env, args.batch, seed)()

    states = reset(args.seed)
    # every rollout rematerializes its ticks in the backward
    rollout = envs_mod.make_rollout(env, args.ticks, remat=True)
    base = env.gather_params()
    slot = len(base) - 1
    weights = dict(clear_margin=args.clear_margin, pen_margin=args.pen_margin,
                   w_collision=args.w_collision, w_pen=args.w_pen,
                   w_effort=args.w_effort)

    @torch.no_grad()
    def eval_loss_metrics(net):
        params = base[:slot] + (dict(base[slot], net=net),)
        reach, collision, penetration, effort, mets = episode_metrics(
            env, states, rollout, params, args.clear_margin, args.pen_margin)
        loss = (reach + args.w_collision * collision
                + args.w_pen * penetration + args.w_effort * effort)
        return loss, dict(mets, reach=reach, collision=collision,
                          pen_loss=penetration)

    # yardstick: the production hand-designed obstacle leaf on the same
    # episodes (identical attractor stack and scoring)
    hand_env = dataclasses.replace(
        franka.env_randomized_cluttered(device), on_solved=None,
        stuck_fn=None, aux_fn=clearance_aux)
    with torch.no_grad():
        hand = episode_metrics(hand_env, states,
                               envs_mod.make_rollout(hand_env, args.ticks),
                               hand_env.gather_params(), args.clear_margin,
                               args.pen_margin)[4]
    print("hand-designed yardstick: "
          + "  ".join(f"{k} {float(v):.4f}" for k, v in hand.items()))

    def vg(net, train_states):
        return per_env_value_and_grad(rollout, base, slot, net, train_states,
                                      weights, args.env_clip)

    net = leaves(base[slot]["net"])
    trainer = Trainer(net, args.lr, args.steps, args.clip)
    best_val, best_net = float("inf"), {k: v.detach().clone()
                                        for k, v in net.items()}
    # what scores the best iterate: a best kept under another criterion
    # is not comparable with this run's scores
    criterion = dict(select=args.select,
                     resample_every=int(args.resample_every))
    start = 0
    if args.ckpt and args.resume and os.path.exists(args.ckpt):
        start, saved, opt_state, best_val, best_net = \
            restore_train_checkpoint(args.ckpt, net)
        with torch.no_grad():
            for k, v in saved.items():
                net[k].copy_(v)
        trainer.opt.load_state_dict(opt_state)
        print(f"resumed {args.ckpt} at step {start}")
        scored = train_checkpoint_meta(args.ckpt).get("criterion")
        if scored != criterion:
            best_val = float("inf")
            best_net = {k: v.detach().clone() for k, v in net.items()}
            print(f"the checkpoint's best was scored by {scored}, this run "
                  f"scores by {criterion}: the best starts again from the "
                  f"restored net")
    train_states = states
    if args.resample_every and start:
        # a resumed run trains on the batch the unbroken run would have:
        # the one drawn at the last resample boundary
        last = (start // args.resample_every) * args.resample_every
        if last:
            train_states = reset((args.seed + 1) * 100003 + last)

    def consider_best(best_val, best_net):
        """With --resample-every, per-step training losses are not
        comparable across batches: select on the fixed eval batch. --select
        task scores penetrated - solved (lower is better)."""
        ev, m = eval_loss_metrics(net)
        score = (float(m["penetrated"]) - float(m["solved"])
                 if args.select == "task" else float(ev))
        if score < best_val:
            return score, {k: v.detach().clone() for k, v in net.items()}, m
        return best_val, best_net, m

    for step in range(start, args.steps):
        if args.resample_every and step and step % args.resample_every == 0:
            train_states = reset((args.seed + 1) * 100003 + step)
        val, grad, gnorm, dropped = vg(net, train_states)
        if (args.select == "loss" and not args.resample_every
                and float(val) < best_val):
            best_val = float(val)
            best_net = {k: v.detach().clone() for k, v in net.items()}
        trainer.update(grad, step)
        if step % 10 == 0 or step == args.steps - 1:
            if args.resample_every or args.select == "task":
                best_val, best_net, m = consider_best(best_val, best_net)
            else:
                m = eval_loss_metrics(net)[1]
            print(f"step {step:4d}  loss {float(val):.4f}  "
                  f"gnorm {float(gnorm):.2e}  dropped {float(dropped):.3f}  "
                  + "  ".join(f"{k} {float(v):.4f}" for k, v in m.items()))
        done = step + 1
        if args.ckpt and (done % args.ckpt_every == 0 or done == args.steps
                          or done - start == args.stop_after):
            save_train_checkpoint(args.ckpt, done, net,
                                  trainer.opt.state_dict(), best_val,
                                  best_net, meta=dict(criterion=criterion))
        if args.stop_after and done - start >= args.stop_after:
            print(f"stopping after {args.stop_after} steps "
                  f"(at step {done}/{args.steps})")
            return None

    if args.resample_every or args.select == "task":
        best_val, best_net, _ = consider_best(best_val, best_net)
    else:
        val = vg(net, train_states)[0]
        if float(val) < best_val:
            best_val = float(val)
            best_net = {k: v.detach().clone() for k, v in net.items()}

    m = eval_loss_metrics(best_net)[1]
    print("best: loss %.4f  " % best_val
          + "  ".join(f"{k} {float(v):.4f}" for k, v in m.items()))
    if args.save:
        np.savez(args.save, **net_to_numpy(best_net))
        print(f"saved best net -> {args.save}")
    return best_net


if __name__ == "__main__":
    main()
