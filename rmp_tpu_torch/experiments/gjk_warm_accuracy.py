"""Accuracy of the hull tier's warm-started GJK (K4) along a rollout.

The port's `experiments/gjk_warm_accuracy.py`. The warm carry (the last
tick's witness directions) compounds over ticks, so a static test cannot
certify a warm iteration count. This tool rolls out a scene in the hull
tier and at every tick re-solves the same states cold (10 iterations from
the capsule witness, the query K4 was held against) beside the warm query
the batched step makes, and reports |d_warm - d_cold| by band of the cold
distance (the obstacle policy's metric is exactly zero beyond 0.5 m), and
|q̈_warm - q̈_cold| of the control step run both ways on identical states.

    python -m rmp_tpu_torch.experiments.gjk_warm_accuracy [--iters 4,3]
        [--batch 1024] [--ticks 150] [--env franka/06_cluttered_environment]
        [--seed 0] [--cpu]

The batch must be a multiple of 128 (the batched hull tier's warm carry).
One JSON report per warm iteration count.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math

import numpy as np
import torch

# error bands by the cold distance
BANDS = ((0.0, 0.1), (0.1, 0.5), (0.5, math.inf))


def tick_stats(d_warm: torch.Tensor, d_cold: torch.Tensor) -> dict:
    """max, mean, p99 of |d_warm - d_cold| and the share of pairs, per
    band of d_cold (NaN p99 for an empty band)."""
    diff = (d_warm - d_cold).abs()
    stats = {}
    for lo, hi in BANDS:
        sel = (d_cold >= lo) & (d_cold < hi)
        key = f"{lo:g}-{hi:g}"
        picked = diff[sel]
        stats[f"max@{key}"] = float(picked.max()) if picked.numel() else 0.0
        stats[f"mean@{key}"] = (float(picked.sum()) / max(1, picked.numel()))
        stats[f"p99@{key}"] = (float(torch.quantile(picked.double(), 0.99))
                               if picked.numel() else float("nan"))
        stats[f"frac@{key}"] = float(sel.float().mean())
    return stats


def run_one(env_name: str, iters: int, batch: int, ticks: int, seed: int,
            device) -> dict:
    from rmp_tpu_torch import envs
    from rmp_tpu_torch.envs.base import make_batched_control_step
    from rmp_tpu_torch.models import kinematics as K
    from rmp_tpu_torch.sim.collision import \
        robot_obstacle_distances_hull_batched
    from rmp_tpu_torch.sim.data import (COLD_ITERS, PAIRS_KEY,
                                        distance_context_batched)

    if batch % 128:
        raise ValueError(f"batch {batch}: the warm carry needs a multiple "
                         f"of 128 envs")
    env = envs.make(env_name, device=device)
    env.collision_geometry = "hull"
    env.resolve_method = "solve"
    env.hull_warm_iters = iters
    params = env.gather_params()
    model = env.model
    step = make_batched_control_step(env)
    step_cold = make_batched_control_step(
        dataclasses.replace(env, hull_warm_iters=COLD_ITERS))
    state = envs.make_batched_reset(env, batch, seed)()

    per_tick, qdd_p99 = [], []
    qdd_max = qdd_rms = 0.0
    with torch.no_grad():
        for _ in range(ticks):
            T_all = K.fk_all(model, state.sim.q)
            ctx, _ = distance_context_batched(
                model, T_all, state.sim.obstacles, "hull",
                warm=state.gjk_warm, iters=iters)
            d_cold = robot_obstacle_distances_hull_batched(
                model, T_all, state.sim.obstacles, iters=COLD_ITERS,
                warm=None)[3]
            per_tick.append(tick_stats(ctx[PAIRS_KEY]["distance"], d_cold))
            _, aux_c = step_cold(state, params)
            state, aux = step(state, params)
            e = (aux["qdd"] - aux_c["qdd"]).abs()
            qdd_max = max(qdd_max, float(e.max()))
            qdd_p99.append(float(torch.quantile(e.double().flatten(), 0.99)))
            qdd_rms += float(aux_c["qdd"].pow(2).mean().sqrt()) / ticks

    rep = dict(env=env_name, iters_warm=iters, batch=batch, ticks=ticks,
               device=str(device))
    for lo, hi in BANDS:
        key = f"{lo:g}-{hi:g}"
        rep[f"abs_err_max_m@{key}"] = max(t[f"max@{key}"] for t in per_tick)
        p99 = [t[f"p99@{key}"] for t in per_tick]
        rep[f"abs_err_p99_m@{key}"] = float(np.nanmax(p99))
        rep[f"abs_err_p99_med_tick_m@{key}"] = float(np.nanmedian(p99))
        rep[f"abs_err_mean_m@{key}"] = float(np.mean(
            [t[f"mean@{key}"] for t in per_tick]))
        rep[f"pair_frac@{key}"] = float(np.mean(
            [t[f"frac@{key}"] for t in per_tick]))
    late = qdd_p99[min(20, len(qdd_p99) - 1):]
    rep.update(qdd_abs_err_max=qdd_max,
               qdd_abs_err_p99_worst_tick=max(qdd_p99),
               qdd_abs_err_p99_median_tick=float(np.median(qdd_p99)),
               qdd_abs_err_p99_median_late_tick=float(np.median(late)),
               qdd_rms_cold=qdd_rms)
    return rep


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", default="4",
                    help="comma-separated warm GJK iteration counts")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--ticks", type=int, default=150)
    ap.add_argument("--env", default="franka/06_cluttered_environment")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from rmp_tpu_torch.experiments.common import card_name, device_of

    device = device_of(args.cpu)
    for it in (int(v) for v in args.iters.split(",")):
        rep = run_one(args.env, it, args.batch, args.ticks, args.seed,
                      device)
        rep["card"] = card_name(device)
        print(json.dumps(rep, indent=2))


if __name__ == "__main__":
    main()
