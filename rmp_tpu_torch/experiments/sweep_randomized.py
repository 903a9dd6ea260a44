"""Gain sweep of a randomized scene: G gain configs x B envs in one batch.

The port's `experiments/sweep_randomized.py`. JAX vmaps G stacked
parameter sets over one batch of states; the port folds them into one
batch of G x B envs (envs.base.fold_batch: config-major copies of the
reset, every copy drawing the same rows of the resampling stream) and
gives each env its config's gain as a (G B,) tensor, so one batched
rollout evaluates the whole grid and every config sees the same scenes and
the same resampled goals.

    python -m rmp_tpu_torch.experiments.sweep_randomized
        [--env franka/randomized_cluttered] [--envs-per-config 256]
        [--ticks 300] [--seed 0] [--cpu]
        [--set accel_p_gain=0.3,0.6,1.0]
        [--set "attractor_*:accel_d_gain=0.6,1.2"]

Keys are policy-params keys; a key that matches no params is a hard error
(its stderr names the key and the keys there are). An optional
policy-name glob routes the key to every matching policy; without one the
randomized scene's routing applies: attractor keys to policy 0, obstacle
keys to the last policy, any other key to every policy that has it.
Prints one JSON report, configs by success.
"""
from __future__ import annotations

import argparse
import fnmatch
import itertools
import json
import sys
import time

import torch

# which policy dict holds each sweepable gain (the attractor is policy 0 of
# env_randomized_cluttered's stack; the obstacle policy is the last)
ATTRACTOR_KEYS = {"accel_p_gain", "accel_d_gain", "metric_alpha_length_scale"}
OBSTACLE_KEYS = {"damping_gain", "repulsion_gain", "metric_modulation_radius",
                 "metric_scalar", "damping_std_dev"}
DEFAULT_AXIS = "accel_p_gain=0.3,0.6,1.0"


def parse_axes(specs) -> list:
    """[(policy glob or None, key, [values])] of '[glob:]key=v1,v2,...'."""
    axes = []
    for spec in specs or [DEFAULT_AXIS]:
        sel, _, rest = spec.rpartition(":")
        key, _, vals = rest.partition("=")
        axes.append((sel or None, key.strip(),
                     [float(v) for v in vals.split(",")]))
    return axes


def _routes(sel, key, i: int, name: str, prm: dict, n_policies: int) -> bool:
    if key not in prm:
        return False
    if sel is not None:
        return fnmatch.fnmatch(name, sel)
    return ((key in ATTRACTOR_KEYS and i == 0)
            or (key in OBSTACLE_KEYS and i == n_policies - 1)
            or key not in ATTRACTOR_KEYS | OBSTACLE_KEYS)


def folded_params(env, axes, grid, B: int, device) -> tuple[tuple, list]:
    """The env's params with each swept gain a (G B,) tensor, config g's
    value on envs g B .. (g + 1) B - 1; and the axes that matched no
    params."""
    base = env.gather_params()
    names = [p.name for p in env.policies]
    out, applied = [], {(sel, key): 0 for sel, key, _ in axes}
    for i, prm in enumerate(base):
        prm = dict(prm)
        for a, (sel, key, _) in enumerate(axes):
            if _routes(sel, key, i, names[i], prm, len(base)):
                vals = torch.tensor([combo[a] for combo in grid],
                                    dtype=torch.float32, device=device)
                prm[key] = vals.repeat_interleave(B)
                applied[(sel, key)] += 1
        out.append(prm)
    return tuple(out), [k for k, n in applied.items() if n == 0]


def config_metrics(env, final, aux, G: int) -> dict:
    """Per config (G,): success (a goal at any tick), first_goal (the
    first goal event a reached goal), goals (final solved_count),
    penetration (final clearance below -1 cm) and nan (non-finite q)."""
    from rmp_tpu_torch.evaluate import min_clearance

    solved, ev = aux["solved"], aux["resample"]
    has_ev = ev.any(dim=1)
    first = ev.to(torch.int8).argmax(dim=1)
    sol = solved.gather(1, first[:, None])[:, 0]
    pen = (min_clearance(env, final.sim) < -0.01
           if final.sim.obstacles is not None
           else torch.zeros_like(has_ev))
    per_env = dict(success=solved.any(dim=1), first_goal=has_ev & sol,
                   goals=final.solved_count,
                   penetration=pen,
                   nan=torch.isnan(final.sim.q).any(dim=-1))
    return {k: v.float().reshape(G, -1).mean(dim=1).tolist()
            for k, v in per_env.items()}


def sweep(env_name: str, axes: list, envs_per_config: int, ticks: int,
          seed: int, device) -> dict:
    """The report of the whole grid of `axes` on `envs_per_config` reset
    envs (seed `seed`), rolled out together for `ticks` batched ticks.
    Raises SystemExit naming the keys that match no params."""
    from rmp_tpu_torch import envs
    from rmp_tpu_torch.envs.base import fold_batch

    env = envs.make(env_name, device=device)
    grid = list(itertools.product(*[vals for _, _, vals in axes]))
    G, B = len(grid), envs_per_config
    params, dead = folded_params(env, axes, grid, B, device)
    if dead:
        avail = sorted({k for prm in env.gather_params() for k in prm})
        sys.stderr.write(f"policy names: {[p.name for p in env.policies]}\n")
        sys.exit(f"--set key(s) {dead} match no policy params; a sweep over "
                 f"them would silently be a no-op. Available keys: {avail}")
    states = fold_batch(envs.make_batched_reset(env, B, seed)(), G)
    rollout = envs.make_batched_rollout(env, ticks)
    t0 = time.perf_counter()
    with torch.no_grad():
        final, aux = rollout(states, params)
        metrics = config_metrics(env, final, aux, G)
    wall = time.perf_counter() - t0
    rows = []
    for g, combo in enumerate(grid):
        row = {(f"{sel}:{key}" if sel else key): val
               for (sel, key, _), val in zip(axes, combo)}
        row.update({k: round(v[g], 4) for k, v in metrics.items()})
        rows.append(row)
    rows.sort(key=lambda r: -r["success"])
    return dict(env=env_name, envs_per_config=B, configs=G, ticks=ticks,
                seed=seed, device=str(device), wall_s=round(wall, 3),
                results=rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="franka/randomized_cluttered")
    ap.add_argument("--envs-per-config", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=V1,V2,...",
                    help="sweep axis: [policy glob:]gain key and values")
    args = ap.parse_args(argv)

    from rmp_tpu_torch.experiments.common import card_name, device_of

    device = device_of(args.cpu)
    rep = sweep(args.env, parse_axes(args.set), args.envs_per_config,
                args.ticks, args.seed, device)
    rep["card"] = card_name(device)
    print(json.dumps(rep, indent=2))


if __name__ == "__main__":
    main()
