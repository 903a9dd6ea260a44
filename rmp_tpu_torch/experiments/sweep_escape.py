"""Paired sweep of the escape / yield / final-push knobs.

The port's `experiments/sweep_escape.py`. franka/randomized_cluttered and
dual_panda/randomized_clutter keep their behaviour knobs in
EnvState.scratch["cfg"] as per-env tensors; each config below overrides
some of them after one reset and rolls the batch out. The evaluation is
PAIRED: every config starts from the same reset and the same state of the
resampling stream (a copy of the reset's generator each), so config deltas
are measured on identical scenes and draws.

    python -m rmp_tpu_torch.experiments.sweep_escape [--env NAME]
        [--batch 4096] [--ticks 300] [--seed 0] [--cpu]
        [--configs shipped,first_b1]

Prints each config's first-goal, overall success and final penetration
rates as it ends, then one JSON report.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

# env -> {config name -> cfg overrides (unlisted keys keep the env's
# defaults)}: the JAX tool's last paired rounds (its comments record the
# earlier ones)
CONFIGS = {
    "franka/randomized_cluttered": {
        "cand_arrive": dict(esc_trigger=35.0, esc_relax=1.0,
                            obs_margin=0.0),
        "shipped": dict(),
        "first_b1": dict(man_budget=1.0),
        "late1": dict(man_budget_late=1.0),
    },
    "dual_panda/randomized_clutter": {
        "perarm_r4": dict(man_relax=1.0),
        "shipped": dict(),
        "shipped_b1": dict(man_budget=1.0),
        "shipped_spent35": dict(timeout_spent=35.0),
    },
}


def configured(states0, overrides: dict):
    """states0 with its cfg leaves overridden and its own copy of the
    reset's generator (the same state: paired draws)."""
    cfg = dict(states0.scratch["cfg"])
    for key, val in overrides.items():
        if key not in cfg:
            raise KeyError(f"cfg has no knob {key!r}; it has {sorted(cfg)}")
        cfg[key] = torch.full_like(cfg[key], val)
    rng = torch.Generator(device=states0.rng.device)
    rng.set_state(states0.rng.get_state())
    return dataclasses.replace(states0, rng=rng,
                               scratch=dict(states0.scratch, cfg=cfg))


def group_metrics(env, final, aux) -> dict:
    """first_goal, overall and penetration rates of one config's run."""
    from rmp_tpu_torch.evaluate import min_clearance

    sol, ev = aux["solved"], aux["resample"]
    has_ev = ev.any(dim=1)
    first = ev.to(torch.int8).argmax(dim=1)
    first_goal = has_ev & sol.gather(1, first[:, None])[:, 0]
    pen = min_clearance(env, final.sim) < -0.01
    return dict(first_goal=round(float(first_goal.float().mean()), 4),
                overall=round(float(sol.any(dim=1).float().mean()), 4),
                penetration=round(float(pen.float().mean()), 4))


def sweep(env_name: str, batch: int, ticks: int, seed: int, device,
          names=None, log=print) -> dict:
    """The paired report of CONFIGS[env_name] (or the named ones)."""
    from rmp_tpu_torch import envs

    env = envs.make(env_name, device=device)
    configs = CONFIGS[env_name]
    names = list(configs) if names is None else list(names)
    states0 = envs.make_batched_reset(env, batch, seed)()
    rollout = envs.make_batched_rollout(env, ticks)
    params = env.gather_params()
    report = dict(env=env_name, batch=batch, ticks=ticks, seed=seed,
                  device=str(device), paired=True, groups={})
    for name in names:
        states = configured(states0, configs[name])
        t0 = time.perf_counter()
        with torch.no_grad():
            final, aux = rollout(states, params)
            group = group_metrics(env, final, aux)
        group["wall_s"] = round(time.perf_counter() - t0, 3)
        report["groups"][name] = group
        log(f"{name}: {group}")
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="franka/randomized_cluttered",
                    choices=sorted(CONFIGS))
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--configs", default=None,
                    help="comma-separated config names (default: all)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from rmp_tpu_torch.experiments.common import card_name, device_of

    device = device_of(args.cpu)
    names = args.configs.split(",") if args.configs else None
    report = sweep(args.env, args.batch, args.ticks, args.seed, device,
                   names, log=lambda m: print(m, flush=True))
    report["card"] = card_name(device)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
