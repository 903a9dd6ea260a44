"""Closed-loop control latency: the serving-side complement of the
batched throughput runs.

The port's `experiments/latency.py`. A deployed RMP controller is a
reactive loop that must read the joint command back every tick (sense ->
policies -> resolve -> substeps -> command out), so each timed tick ends
with a host read of q (`.cpu()`, which waits for the device): no queued
work hides the launch and copy latency. Per batch size: p50 / p90 / p99
wall latency over --ticks ticks after one untimed tick (which builds the
kernels and the model's device tables: `compile_s`), and the real-time
factor against the scene's control period (control_every x dt).

    python -m rmp_tpu_torch.experiments.latency [--env NAME]
        [--batches 1,8,64,512,4096] [--ticks 200] [--cpu]
        [--geometry capsule|hull] [--seed 0] [--out FILE]

On the card unless --cpu; the report goes to chiprun_out/latency.json
(latency_cpu.json with --cpu) or --out, never into reports/.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from rmp_tpu_torch import default_device, envs
from rmp_tpu_torch.experiments.common import (card_name, device_of,
                                              report_path)


def measure(env_name: str, batches: list[int], ticks: int, geometry: str,
            seed: int = 0, device=None) -> dict:
    """The latency report of `env_name` (resolve 'solve') at each batch
    size, on `device` (default: the card)."""
    env = envs.make(env_name, device=default_device(device))
    env.collision_geometry = geometry
    env.resolve_method = "solve"
    params = env.gather_params()
    on_card = env.device.type == "cuda"
    tick = envs.make_batched_rollout(env, 1, with_aux=False)
    control_period = env.dt * env.control_every
    rows = []
    for batch in batches:
        states = envs.make_batched_reset(env, batch, seed)()
        t0 = time.perf_counter()
        s, _ = tick(states, params)
        s.sim.q.cpu()
        compile_s = time.perf_counter() - t0
        lat = np.empty(ticks)
        for i in range(ticks):
            t0 = time.perf_counter()
            s, _ = tick(s, params)
            s.sim.q.cpu()                # the command the robot consumes
            lat[i] = time.perf_counter() - t0
        p50, p90, p99 = (float(np.percentile(lat, p)) for p in (50, 90, 99))
        rows.append({
            "batch": batch,
            # the batched 'solve' tick runs K1 on the card
            "fused_resolve": on_card,
            "p50_ms": round(p50 * 1e3, 3),
            "p90_ms": round(p90 * 1e3, 3),
            "p99_ms": round(p99 * 1e3, 3),
            "control_rate_hz_p50": round(1.0 / p50, 1),
            # how many x faster than the scene's control period the loop
            # closes (>= 1.0: real-time capable at the design rate)
            "realtime_factor_p50": round(control_period / p50, 2),
            "batched_steps_per_sec_p50": round(batch / p50, 1),
            "compile_s": round(compile_s, 1),
        })
        print(f"  batch {batch:5d}: p50 {p50 * 1e3:7.2f} ms  "
              f"p99 {p99 * 1e3:7.2f} ms  "
              f"rt-factor {control_period / p50:6.1f}x"
              + ("  (K1)" if on_card else ""), file=sys.stderr)
    card = card_name(env.device)
    return {
        "env": env_name,
        "geometry": geometry,
        "platform": "gpu" if on_card else "cpu",
        "ticks_per_point": ticks,
        "control_period_s": control_period,
        "note": (f"{card}: each tick's time includes the host's launches "
                 f"and the copy of q back to the host" if on_card else
                 "host-local CPU backend: no device in the loop"),
        "points": rows,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="franka/06_cluttered_environment")
    ap.add_argument("--batches", default="1,8,64,512,4096",
                    help="comma-separated batch sizes")
    ap.add_argument("--ticks", type=int, default=200)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--geometry", choices=("capsule", "hull"),
                    default="capsule")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = report_path("latency_cpu.json" if args.cpu else "latency.json",
                      args.out)
    batches = [int(b) for b in args.batches.split(",")]
    report = measure(args.env, batches, args.ticks, args.geometry,
                     seed=args.seed, device=device_of(args.cpu))
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
