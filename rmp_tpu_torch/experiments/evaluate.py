"""Large-scale evaluation sweep: success metrics over randomized env batches.

The port's `experiments/evaluate.py`: rolls out a batch of a scene
(default the domain-randomized cluttered scene) through the batched
rollout and prints the JAX tool's report (success rates, goal
feasibility, goals reached, penetration, NaN rate, throughput) from
`rmp_tpu_torch.evaluate.task_statistics`, plus the device it ran on.

    python -m rmp_tpu_torch.experiments.evaluate [--env NAME] [--batch 4096]
        [--ticks 300] [--seed 0] [--cpu] [--geometry capsule|hull]
        [--out FILE]

On the card unless --cpu. The timed window is the rollout alone, ending in
torch.cuda.synchronize(); the kernels are built before it. With --out the
report is also written there (never into the repository's reports/).
"""
from __future__ import annotations

import argparse
import json
import time

from rmp_tpu_torch import _build, envs
from rmp_tpu_torch.evaluate import task_statistics
from rmp_tpu_torch.experiments.common import (card_name, device_of,
                                              report_path, synchronize)


def evaluate(env_name: str, batch: int, ticks: int, seed: int,
             geometry: str, device) -> dict:
    """The report of one sweep: `batch` envs of `env_name` from the reset
    of `seed`, `ticks` batched ticks, the scene's own resolve method."""
    env = envs.make(env_name, device=device)
    env.collision_geometry = geometry
    if env.device.type == "cuda":
        _build.load()
    initial = envs.make_batched_reset(env, batch, seed)()
    rollout = envs.make_batched_rollout(env, ticks)
    params = env.gather_params()
    synchronize(env.device)
    t0 = time.perf_counter()
    final, aux = rollout(initial, params)
    synchronize(env.device)
    wall = time.perf_counter() - t0
    return dict(env=env_name, geometry=geometry, batch=batch, ticks=ticks,
                **task_statistics(env, initial, final, aux),
                control_steps_per_sec=round(batch * ticks / wall, 1),
                wall_seconds=round(wall, 2), device=card_name(env.device))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="franka/randomized_cluttered")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--geometry", choices=("capsule", "hull"),
                    default="capsule",
                    help="link collision geometry (hull = exact mesh-hull "
                         "GJK; requires a hull asset for the robot)")
    ap.add_argument("--out", default=None,
                    help="also write the report to this file")
    args = ap.parse_args(argv)
    out = (None if args.out is None
           else report_path("evaluate.json", args.out))
    report = evaluate(args.env, args.batch, args.ticks, args.seed,
                      args.geometry, device_of(args.cpu))
    text = json.dumps(report, indent=2)
    if out is not None:
        with open(out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
