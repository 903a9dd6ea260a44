"""Launch the live viewer of a scene (utils/viewer.SimViewer).

The port's `experiments/viewer.py`, the counterpart of the reference's
PyBullet debug GUI (simulation.py:325-330): a browser page with a live
stream of the running simulation, orbit and zoom, pause, resume, reset.

    python -m rmp_tpu_torch.experiments.viewer [env] [--port 8777]
        [--host 127.0.0.1] [--cpu] [--no-realtime]
        [--geometry capsule|hull|visual]
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("env", nargs="?", default="franka/06_cluttered_environment")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8777)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--no-realtime", action="store_true",
                    help="step as fast as possible, not at wall-clock rate")
    ap.add_argument("--geometry", choices=["capsule", "hull", "visual"],
                    default="capsule",
                    help="hull: the links' convex hulls; visual: the "
                         "reference's visual meshes")
    args = ap.parse_args(argv)

    from rmp_tpu_torch import envs
    from rmp_tpu_torch.experiments.common import device_of
    from rmp_tpu_torch.utils.viewer import SimViewer

    if args.env not in envs.REGISTRY:
        known = "\n  ".join(sorted(envs.REGISTRY))
        raise SystemExit(f"unknown env '{args.env}'; available:\n  {known}")
    SimViewer(envs.make(args.env, device=device_of(args.cpu)),
              host=args.host, port=args.port, width=args.width,
              height=args.height, realtime=not args.no_realtime,
              geometry=args.geometry).serve()


if __name__ == "__main__":
    main()
