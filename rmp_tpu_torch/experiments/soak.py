"""Long-horizon stability soak: many envs x many ticks, invariant checks.

The port's `experiments/soak.py`: rolls a scene (default the flagship) for
thousands of control ticks in chunks and checks after every chunk the
invariants that should hold forever: every q and q̇ finite, q within the
joint limits (± 1e-4), the largest |q̇|, and the goals still being reached
(solve events per chunk).

    python -m rmp_tpu_torch.experiments.soak [--env NAME] [--batch 4096]
        [--ticks 5000] [--chunk 500] [--cpu] [--geometry capsule|hull]
        [--out FILE]

On the card unless --cpu; the report goes to chiprun_out/soak_<env>.json
(with _hull in the hull tier) or --out, never into reports/.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from rmp_tpu_torch import default_device, envs
from rmp_tpu_torch.experiments.common import (card_name, device_of,
                                              report_path, synchronize)

LIMIT_SLACK = 1e-4    # rad: q may pass its joint limit by this much


def soak(env_name: str, batch: int, ticks: int, chunk: int, geometry: str,
         device=None) -> dict:
    """The soak report: whole chunks of `chunk` ticks (ticks rounded down
    to them) of `batch` envs from the reset of seed 0, the batched rollout
    ('solve' for arms of up to 9 joints, as the JAX tool), each chunk's
    checks read back after it."""
    chunk = min(chunk, ticks)
    ticks = (ticks // chunk) * chunk
    env = envs.make(env_name, device=default_device(device))
    env.collision_geometry = geometry
    if env.model.n_q <= 9:
        env.resolve_method = "solve"
    states = envs.make_batched_reset(env, batch)()
    roll = envs.make_batched_rollout(env, chunk, with_aux=False)
    params = env.gather_params()
    f32 = dict(dtype=torch.float32, device=env.device)
    lo = torch.as_tensor(env.model.q_lower, **f32) - LIMIT_SLACK
    hi = torch.as_tensor(env.model.q_upper, **f32) + LIMIT_SLACK

    t0 = time.perf_counter()
    checks, goals_at = [], []
    s = states
    for k in range(ticks // chunk):
        s, _ = roll(s, params)
        q, qd = s.sim.q, s.sim.qd
        checks.append(dict(
            tick=(k + 1) * chunk,
            finite=bool(torch.isfinite(q).all() & torch.isfinite(qd).all()),
            in_limits=bool(((q >= lo) & (q <= hi)).all()),
            max_abs_qd=float(qd.abs().max()),
        ))
        goals_at.append(float(s.solved_count.float().mean()))
    synchronize(env.device)
    wall = time.perf_counter() - t0
    # solve events per chunk: sustained progress for a resampling scene;
    # a finite goal sequence saturates once its envs park at the last goal
    # (the check then fires every tick), where what matters is a quiet
    # terminal equilibrium inside the limits
    rates = [goals_at[0]] + [b - a for a, b in zip(goals_at, goals_at[1:])]
    return dict(
        env=env_name, geometry=geometry, batch=batch, ticks=ticks,
        all_finite=all(c["finite"] for c in checks),
        always_in_limits=all(c["in_limits"] for c in checks),
        max_abs_qd_overall=max(c["max_abs_qd"] for c in checks),
        final_max_abs_qd=checks[-1]["max_abs_qd"],
        terminal_equilibrium=bool(checks[-1]["max_abs_qd"] < 1e-2),
        solve_events_per_chunk_first=round(rates[0], 2),
        solve_events_per_chunk_last=round(rates[-1], 2),
        solve_events_per_chunk=[round(r, 2) for r in rates],
        wall_seconds=round(wall, 2),
        checkpoints=checks[-3:],
        device=card_name(env.device),
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="franka/06_cluttered_environment")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=5000)
    ap.add_argument("--chunk", type=int, default=500)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--geometry", choices=("capsule", "hull"),
                    default="capsule")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    tag = args.env.replace("/", "_")
    if args.geometry != "capsule":
        tag += f"_{args.geometry}"
    out = report_path(f"soak_{tag}.json", args.out)
    report = soak(args.env, args.batch, args.ticks, args.chunk,
                  args.geometry, device_of(args.cpu))
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
