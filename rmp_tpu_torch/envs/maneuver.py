"""Shared stall/budget/maneuver substrate of the randomized scenes, batched.

The port's `rmp_tpu/envs/maneuver.py`: stall counters, maneuver timers
with budgets and end-on-arrival, clearance-scored detour waypoints, the
final-push gain boost and the spent-budget fast timeout, which act before
the goal-timeout resample so that first-goal credit is kept.

Every function takes a leading env axis B. The knobs are per-env float32
tensors (B,) in EnvState.scratch['cfg'] (cfg_scratch), so envs of one batch
may run different configurations. Timers, counts and points may carry an
arm axis after the env axis (timer (B, A), ee (B, A, 3)), as the JAX
module's do after its vmap: a (B,) knob or phase broadcasts over it.

Knobs (the JAX module's vocabulary):
  man_budget      maneuvers per goal (0 disables)
  man_ticks       maneuver duration in control ticks
  man_arrive      1: end a maneuver on waypoint arrival
  man_first_only  1: maneuvers only before the first goal event
  esc_trigger     stalled ticks before a detour
  timeout         stalled ticks before the goal resamples
  timeout_spent   faster resample once the maneuver budget is spent
  push_trigger / push_near / push_boost / push_relax
                  final-push boost on near-miss stalls
"""
from __future__ import annotations

import torch


def cfg_scratch(cfg: dict, batch: int, device) -> dict:
    """CFG dict of floats -> per-env float32 tensors (batch,)."""
    return {k: torch.full((batch,), float(v), dtype=torch.float32,
                          device=device) for k, v in cfg.items()}


def _env(x, like: torch.Tensor):
    """A per-env (B,) tensor shaped (B, 1, ...) to broadcast against
    `like` (B, ...); a Python number as it is."""
    if not isinstance(x, torch.Tensor):
        return x
    return x.reshape(x.shape[0], *(1,) * (like.dim() - 1))


def point_clearance(obstacles, p: torch.Tensor,
                    seed: torch.Tensor | None = None) -> torch.Tensor:
    """Min signed distance from points p (B, ..., 3) to every obstacle axis
    segment of their env (obstacles (B, K, ...)), by the capsule metric:
    (B, ...). seed (B, ...): an initial value of the running minimum (e.g.
    the distance to the other arm's EE)."""
    extra = (1,) * (p.dim() - 2)
    B, K = obstacles.p0.shape[0], obstacles.count
    p0 = obstacles.p0.reshape(B, *extra, K, 3)
    seg = obstacles.p1.reshape(B, *extra, K, 3) - p0
    seg_len2 = torch.sum(seg * seg, dim=-1)
    t = torch.clamp(torch.sum((p[..., None, :] - p0) * seg, dim=-1)
                    / (seg_len2 + 1e-12), 0.0, 1.0)
    foot = p0 + t[..., None] * seg
    d = (torch.linalg.vector_norm(p[..., None, :] - foot, dim=-1)
         - obstacles.radius.reshape(B, *extra, K))
    out = d.amin(dim=-1)
    return out if seed is None else torch.minimum(seed, out)


def score_candidates(cands, goal: torch.Tensor, clearance_fn,
                     clearance_cap: float = 0.12,
                     detour_weight: float = 0.35):
    """The best detour waypoint of a static candidate list, per env.

    Score = min(clearance_fn(c), cap) - detour_weight |c - goal|: beyond
    `cap` more clearance stops mattering, and a candidate into another
    obstacle or straight away from the goal never wins. cands: a list of
    (B, ..., 3) points; clearance_fn maps the stacked candidates
    (B, ..., C, 3) to (B, ..., C). Returns (best_candidate (B, ..., 3),
    best_score (B, ...)); on a tie the earliest candidate wins."""
    c = torch.stack(list(cands), dim=-2)                  # (B, ..., C, 3)
    s = (torch.clamp(clearance_fn(c), max=clearance_cap)
         - detour_weight * torch.linalg.vector_norm(c - goal[..., None, :],
                                                    dim=-1))
    best = s.argmax(dim=-1, keepdim=True)                 # the first maximum
    best_c = c.gather(-2, best[..., None].expand(*best.shape, 3))[..., 0, :]
    return best_c, s.gather(-1, best)[..., 0]


def _allowed(cfg: dict, phase: torch.Tensor, like: torch.Tensor):
    """The maneuver budget of the current goal phase: man_budget before the
    first goal event (phase == 0); after it man_budget_late where
    man_first_only is set (0 = no late maneuvers), else man_budget."""
    budget = _env(cfg["man_budget"], like)
    late = torch.where(_env(cfg["man_first_only"], like) > 0.5,
                       _env(cfg.get("man_budget_late", 0.0), like), budget)
    return torch.where(_env(phase, like) == 0, budget, late)


def budget_free(cfg: dict, timer: torch.Tensor, count: torch.Tensor,
                phase: torch.Tensor) -> torch.Tensor:
    """True where a new maneuver may fire: none in flight and budget left
    in the current goal phase (the count resets on goal events)."""
    return (timer == 0) & (count < _allowed(cfg, phase, timer))


def maneuver_timers(cfg: dict, timer: torch.Tensor, count: torch.Tensor,
                    trigger: torch.Tensor, ee: torch.Tensor,
                    wp_old: torch.Tensor, wp_new: torch.Tensor,
                    arrive_tol: float):
    """One tick of the timer/budget/arrival bookkeeping: a maneuver that
    reached its waypoint (|ee - wp| < arrive_tol, with man_arrive set)
    ends, the timer otherwise counts down; a trigger starts a new one of
    man_ticks ticks toward wp_new and spends one of the budget. Returns
    (timer_next, count_next, wp_next)."""
    arrived = ((timer > 0) & (_env(cfg["man_arrive"], timer) > 0.5)
               & (torch.linalg.vector_norm(ee - wp_old, dim=-1) < arrive_tol))
    dec = torch.where(arrived, 0, torch.clamp(timer - 1, min=0))
    ticks = _env(cfg["man_ticks"], timer).to(torch.int32)
    timer_next = torch.where(trigger, ticks, dec)
    count_next = count + trigger.to(torch.int32)
    wp_next = torch.where(trigger[..., None], wp_new, wp_old)
    return timer_next, count_next, wp_next


def spent_timeout(cfg: dict, count: torch.Tensor,
                  phase: torch.Tensor | None = None) -> torch.Tensor:
    """The stall window of the current goal: `timeout` while maneuvers
    remain, `timeout_spent` once the phase's budget is used up. A phase
    with maneuvers disabled (allowed == 0) keeps the rule count >=
    man_budget. `phase` None: the first goal's budget throughout."""
    budget = _env(cfg["man_budget"], count)
    allowed = budget if phase is None else _allowed(cfg, phase, count)
    thresh = torch.where(allowed > 0, allowed, budget)
    spent = (budget > 0) & (count >= thresh)
    return torch.where(spent, _env(cfg["timeout_spent"], count),
                       _env(cfg["timeout"], count))


def push_engaged(cfg: dict, no_progress: torch.Tensor,
                 best: torch.Tensor) -> torch.Tensor:
    """Final-push predicate: stalled push_trigger ticks and once within
    push_near of the goal (a near-miss force equilibrium, not a deep local
    minimum)."""
    return ((no_progress >= _env(cfg["push_trigger"], no_progress))
            & (best < _env(cfg["push_near"], best)))


def scaled_attractor(prm: dict, goal: torch.Tensor | None = None,
                     gain_boost=1.0, metric_scale=1.0) -> dict:
    """Attractor params with the boost: the p-gain scaled by gain_boost,
    the d-gain by its square root (the damping ratio kept), both metric
    scalars by metric_scale. Tensors (B,) give per-env params."""
    prm = dict(prm)
    if goal is not None:
        prm["goal"] = goal
    root = (torch.sqrt(gain_boost) if isinstance(gain_boost, torch.Tensor)
            else gain_boost ** 0.5)
    prm["accel_p_gain"] = prm["accel_p_gain"] * gain_boost
    prm["accel_d_gain"] = prm["accel_d_gain"] * root
    prm["max_metric_scalar"] = prm["max_metric_scalar"] * metric_scale
    prm["min_metric_scalar"] = prm["min_metric_scalar"] * metric_scale
    return prm


def relaxed_obstacle(prm: dict, relax_repulsion, relax_metric) -> dict:
    """Obstacle-avoidance params with repulsion_gain and metric_scalar
    divided by the given factors (1.0 is identity)."""
    return dict(prm,
                repulsion_gain=prm["repulsion_gain"] / relax_repulsion,
                metric_scalar=prm["metric_scalar"] / relax_metric)


def freeze_progress(state, trigger_any: torch.Tensor,
                    timer_any: torch.Tensor):
    """(no_progress, goal_best) with the progress window reset while a
    maneuver fires or runs: its outbound leg cannot improve the true goal
    distance, and counting it would spend the budget on transit."""
    no_progress = torch.where(trigger_any | timer_any, 0, state.no_progress)
    goal_best = torch.where(trigger_any, float("inf"), state.goal_best)
    return no_progress, goal_best
