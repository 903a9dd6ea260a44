"""Stage-by-stage timings of the flagship control tick.

The port's `experiments/profile_tick.py`: the franka/06 tick at B envs
split into sense, the RMP evaluation (analytic and jacfwd taskmap
derivatives, K3 alone, the taskmap derivatives alone), the resolve
('cholesky' on random positive definite systems), ten physics substeps,
and the whole per-env control step ('cholesky', as the JAX tool times it).

UPPER BOUNDS, not a partition: each stage runs standalone, so it makes
outputs the rollout never keeps, and shared producers (FK, sense) run
again in several rows; the stages do not add up to the tick. For the
device time of a real rollout by kernel or by line use
    python -m rmp_tpu_torch.experiments.trace_report [--by-source]

    python -m rmp_tpu_torch.experiments.profile_tick [--batch 4096]
        [--iters 20] [--cpu] [--json]

Each row: the first call (the kernels' build and load at a process's first
use) and the steady per-call time (utils/profiling.time_first_and_steady:
CUDA events on the card).
"""
from __future__ import annotations

import argparse
import json

import torch

SCENE = "franka/06_cluttered_environment"


def stages(batch: int, device) -> list:
    """[(name, fn, args)] of the tick's stages on `batch` reset envs."""
    from rmp_tpu_torch import envs
    from rmp_tpu_torch.core import (_taskmap_derivatives_analytic,
                                    evaluate_policies, fk_bundle, resolve)
    from rmp_tpu_torch.envs.base import make_control_step
    from rmp_tpu_torch.ops.cuda_fk import fk_derivatives_batched
    from rmp_tpu_torch.sim.world import physics_step, sense

    env = envs.make(SCENE, device=device)
    env.resolve_method = "cholesky"
    model, policies = env.model, env.policies
    params = env.gather_params()
    states = envs.make_batched_reset(env, batch)()
    sim = states.sim
    params_b = env.bind_params(params, sim, policies)

    def ctxs_of(ctx):
        return tuple(ctx.get(p.ctx_key) if p.ctx_key else None
                     for p in policies)

    def do_sense(s):
        return sense(model, s)[2]

    def do_eval(s, derivatives):
        q, qd, ctx = sense(model, s)
        return evaluate_policies(policies, q, qd, params_b, ctxs_of(ctx),
                                 method="cholesky", derivatives=derivatives)

    def do_taskmaps(s):
        q, qd, ctx = sense(model, s)
        return _taskmap_derivatives_analytic(
            policies, q, qd, ctxs_of(ctx), fk=fk_bundle(policies, q, qd))[2]

    gen = torch.Generator(device=device).manual_seed(1)
    Jr = torch.randn(batch, 30, model.n_q, generator=gen, device=device)
    A = (torch.einsum("bri,brj->bij", Jr, Jr)
         + 0.1 * torch.eye(model.n_q, device=device))
    f = torch.randn(batch, model.n_q, generator=gen, device=device)
    qdd0 = torch.zeros(batch, model.n_q, device=device)

    def do_physics(s, qdd):
        for _ in range(env.control_every):
            s = physics_step(model, s, qdd, env.dt)
        return s.q

    step = make_control_step(env)
    return [
        ("sense", do_sense, (sim,)),
        ("sense + RMP evaluate (chol/ana)", lambda s: do_eval(s, "analytic"),
         (sim,)),
        ("sense + RMP evaluate (jacfwd)", lambda s: do_eval(s, "jacfwd"),
         (sim,)),
        ("fk_derivatives (K3)",
         lambda s: fk_derivatives_batched(model, s.q, s.qd), (sim,)),
        ("sense + taskmap deriv (analytic)", do_taskmaps, (sim,)),
        ("resolve: cholesky", lambda a, b: resolve(a, b, "cholesky"),
         (A, f)),
        (f"physics substeps x{env.control_every}", do_physics,
         (sim, qdd0)),
        ("FULL control tick", lambda s: step(s, params)[0].sim.q,
         (states,)),
    ]


def profile(batch: int, device, iters: int = 20) -> dict:
    """{stage: {first_s, ms, ns_per_env}} and the full tick's steps/s."""
    from rmp_tpu_torch.utils.profiling import time_first_and_steady

    rows = {}
    with torch.no_grad():
        for name, fn, args in stages(batch, device):
            first_s, run_s = time_first_and_steady(fn, *args, iters=iters)
            rows[name] = dict(first_s=first_s, ms=run_s * 1e3,
                              ns_per_env=run_s * 1e9 / batch)
    full = rows["FULL control tick"]["ms"] / 1e3
    return dict(scene=SCENE, batch=batch, device=str(device), stages=rows,
                control_steps_per_s=batch / full)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--json", action="store_true",
                    help="print the report as one JSON object")
    args = ap.parse_args(argv)

    from rmp_tpu_torch.experiments.common import card_name, device_of

    device = device_of(args.cpu)
    rep = profile(args.batch, device, args.iters)
    rep["card"] = card_name(device)
    if args.json:
        print(json.dumps(rep))
        return
    print(f"standalone stage timings at B = {args.batch} (UPPER BOUNDS -- "
          f"see the module docstring; trace_report attributes a rollout) "
          f"[{rep['card']}]\n")
    for name, r in rep["stages"].items():
        print(f"{name:34s} first {r['first_s']:7.2f} s   run "
              f"{r['ms']:8.3f} ms ({r['ns_per_env']:8.1f} ns/env)")
    print(f"\nfull tick {rep['stages']['FULL control tick']['ms']:.2f} ms -> "
          f"{rep['control_steps_per_s']:,.0f} control steps/s")


if __name__ == "__main__":
    main()
