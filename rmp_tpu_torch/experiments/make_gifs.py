"""Demo GIFs of the scenes, rendered by the native ray tracer.

The port's `experiments/make_gifs.py`, the counterpart of the reference's
result GIFs (simulation.py:289-300): each env runs its per-env control step
(a batch of one, its own resolve method) and every `--every`th tick is
rendered (utils/render.render_frame: native where a C++ compiler is there,
else matplotlib), the camera orbiting slowly around the scene's framing
(envs/cameras.py). The GIFs go to chiprun_out/gifs/ of the checkout (or
--out), never into experiments/results/ or reports/.

    python -m rmp_tpu_torch.experiments.make_gifs [env ...] [--ticks 400]
        [--every 4] [--geometry capsule|hull|visual] [--out DIR] [--cpu]
"""
from __future__ import annotations

import argparse
import os

from rmp_tpu_torch.experiments.common import REPORT_DIR, report_path


def make_gif(name: str, ticks: int, every: int, geometry: str, out_dir: str,
             device) -> dict:
    """Roll env `name` out for `ticks` ticks and write its GIF; returns
    {path, frames, renderer, goals_reached}."""
    import torch

    from rmp_tpu_torch import envs
    from rmp_tpu_torch.envs.cameras import camera_for, eye_target
    from rmp_tpu_torch.utils.render import render_frame, save_gif

    env = envs.make(name, device=device)
    state = env.reset(1, 0)
    step = envs.make_control_step(env)
    params = env.gather_params()
    cam_cfg = camera_for(name)
    frames, renderer = [], None
    with torch.no_grad():
        for tick in range(ticks):
            state, _ = step(state, params)
            if tick % every == 0:
                camera = eye_target(cam_cfg,
                                    yaw_offset_deg=90.0 * tick / ticks)
                frame, renderer = render_frame(env.model, state.sim,
                                               camera=camera,
                                               geometry=geometry)
                frames.append(frame)
    suffix = "" if geometry == "capsule" else f"_{geometry}"
    path = report_path(name.replace("/", "_") + suffix + ".gif",
                       os.path.join(out_dir, name.replace("/", "_") + suffix
                                    + ".gif"))
    save_gif(frames, path, fps=8)
    return dict(path=path, frames=len(frames), renderer=renderer,
                goals_reached=int(state.solved_count[0]))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("envs", nargs="*",
                    default=["franka/06_cluttered_environment"])
    ap.add_argument("--ticks", type=int, default=400)
    ap.add_argument("--every", type=int, default=4,
                    help="render every Nth control tick")
    ap.add_argument("--geometry", choices=["capsule", "hull", "visual"],
                    default="capsule",
                    help="hull: the links' convex hulls; visual: the "
                         "reference's visual meshes (native renderer)")
    ap.add_argument("--out", default=os.path.join(REPORT_DIR, "gifs"))
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from rmp_tpu_torch.experiments.common import device_of

    device = device_of(args.cpu)
    for name in args.envs:
        rec = make_gif(name, args.ticks, args.every, args.geometry, args.out,
                       device)
        print(f"{name}: goals reached = {rec['goals_reached']}, wrote "
              f"{rec['path']} ({rec['frames']} frames, {rec['renderer']} "
              f"renderer)")


if __name__ == "__main__":
    main()
