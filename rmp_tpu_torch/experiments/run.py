"""Run any registered scene from the command line, one environment.

The port's `experiments/run.py`:

    python -m rmp_tpu_torch.experiments.run franka/06_cluttered_environment \
        [--ticks 300] [--seed 0] [--cpu] [--geometry capsule|hull]
        [--save TRAJ.NPZ] [--gif OUT.GIF]
    python -m rmp_tpu_torch.experiments.run --list

One env (a batch of one) through make_control_step, the per-env
semantics; every 50 ticks the EE's distance to its goal, then the final
state. --save writes the trajectory (t, q, qd, goal, ee, solved_count per
tick) as the JAX tool does; --gif renders every second tick (the native
ray tracer where a C++ compiler is there, else matplotlib:
utils/render.render_frame) into an animated GIF.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from rmp_tpu_torch import envs
from rmp_tpu_torch.envs.base import ee_position, make_control_step
from rmp_tpu_torch.experiments.common import device_of
from rmp_tpu_torch.utils.render import render_frame, save_gif


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("env", nargs="?",
                    help="registry name, e.g. franka/06_cluttered_environment")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--ticks", type=int, default=300,
                    help="control ticks (10 Hz)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gif", type=str, default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--geometry", choices=("capsule", "hull"),
                    default="capsule", help="link collision geometry")
    ap.add_argument("--save", type=str, default=None, metavar="TRAJ.NPZ",
                    help="dump the trajectory (t, q, qd, goal, ee, "
                         "solved_count per tick) to an .npz")
    args = ap.parse_args(argv)

    if args.list or not args.env:
        for name in sorted(envs.REGISTRY):
            print(name)
        return
    if args.env not in envs.REGISTRY:
        known = "\n  ".join(sorted(envs.REGISTRY))
        raise SystemExit(f"unknown env '{args.env}'; available:\n  {known}")
    env = envs.make(args.env, device=device_of(args.cpu))
    env.collision_geometry = args.geometry
    state = env.reset(1, args.seed)
    step = make_control_step(env)
    params = env.gather_params()

    traj: dict[str, list] = {k: [] for k in ("q", "qd", "goal", "ee",
                                             "solved_count")}
    frames, renderer = [], None
    t0 = time.perf_counter()
    for tick in range(args.ticks):
        state, _ = step(state, params)
        if args.save:
            traj["q"].append(state.sim.q[0].cpu().numpy())
            traj["qd"].append(state.sim.qd[0].cpu().numpy())
            if state.sim.goal is not None:
                traj["goal"].append(state.sim.goal[0].cpu().numpy())
                traj["ee"].append(
                    ee_position(env, state.sim)[0].cpu().numpy())
            traj["solved_count"].append(int(state.solved_count[0]))
        if args.gif and tick % 2 == 0:   # ~5 fps of control ticks
            frame, renderer = render_frame(env.model, state.sim)
            frames.append(frame)
        if tick % 50 == 0 and state.sim.goal is not None:
            ee = ee_position(env, state.sim)[0].cpu().numpy()
            goal = state.sim.goal[0].cpu().numpy()
            print(f"tick {tick:5d}  |ee-goal| = "
                  f"{np.linalg.norm(ee - goal):.4f}  goals reached = "
                  f"{int(state.solved_count[0])}")
    dt = time.perf_counter() - t0
    print(f"{args.ticks} control ticks in {dt:.2f}s "
          f"({args.ticks / dt:.1f} ticks/s incl. host loop)")
    print(f"final q  = {state.sim.q[0].cpu().numpy()}")
    print(f"final qd = {state.sim.qd[0].cpu().numpy()}")
    print(f"goals reached = {int(state.solved_count[0])}")

    if args.gif and frames:
        save_gif(frames, args.gif)
        print(f"wrote {args.gif} ({len(frames)} frames, {renderer} "
              f"renderer)")

    if args.save:
        tick_dt = env.dt * env.control_every
        np.savez_compressed(
            args.save,
            t=np.arange(1, args.ticks + 1, dtype=np.float32) * tick_dt,
            **{k: np.stack(v) for k, v in traj.items() if v})
        print(f"wrote {args.save} ({args.ticks} ticks)")


if __name__ == "__main__":
    main()
