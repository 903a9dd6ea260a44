"""Environment machinery: batched scenes and their control tick.

The port's `rmp_tpu/envs/base.py`. One batched control tick
(make_batched_control_step) senses (closed-form FK through K3, then the
capsule or exact-hull distance context, or the scene's own context_fn),
builds the structured per-policy pullback blocks, resolves the whole batch
at once (K1 for resolve_method 'solve'; einsum accumulation + core.resolve
for 'pinv' and 'cholesky'), applies the scene's update_scene, then runs
`control_every` integrator substeps with the latched q̈ (realised exactly,
or through the torque path with Env.torque_mode or Env.contact, the latter
adding penalty contact forces) and the in-graph goal bookkeeping. A rollout
is a Python loop over ticks. In the hull tier a batch of a multiple of 128
envs carries the GJK warm start
(EnvState.gjk_warm) from tick to tick, seeded by one cold query at reset.
make_control_step / make_rollout take the same batched state with the JAX
package's per-env semantics: evaluate_policies and core.resolve (never
K1), and every hull pair cold. Rollouts are differentiable end to end (the
kernel wrappers are autograd Functions); remat=True recomputes each tick
in the backward (torch.utils.checkpoint) instead of keeping its graph.

Scenes that resample at random draw from EnvState.stream: EnvState.rng, a
torch.Generator on the env's device seeded at reset, over the rows of the
batch it was seeded for (sim.randomizer.RowStream): a rank's slice of a
sharded batch and the copies of a sweep's fold draw, row by row, what the
whole batch draws. A resampling scene draws for every env at every tick
and keeps the draws only where a goal was reached, as the JAX package's
`where` does, so the tick never waits on the host. The numbers are not
JAX's: jax.random streams are not reproduced.

A scene may also carry per-env private state (EnvState.scratch), a pre_tick
hook run at the start of every tick (escape maneuvers), a state-aware
bind_params and a stuck predicate (Env.stuck_fn): a stuck env resamples as
a solved one does, without counting a goal, and _advance keeps the
progress window (EnvState.goal_best, no_progress) that predicates read.
"""
from __future__ import annotations

import dataclasses
import inspect
import weakref
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from rmp_tpu_torch.core import (evaluate_policies, fk_bundle,
                                policy_row_blocks_structured, resolve)
from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.models.urdf import KinematicModel
from rmp_tpu_torch.ops.cuda_resolve import (assemble_structured,
                                            pullback_resolve_structured)
from rmp_tpu_torch.policies.base import Policy
from rmp_tpu_torch.sim.data import (COLD_ITERS, distance_context_batched,
                                    hull_batched)
from rmp_tpu_torch.sim.randomizer import RowStream, uniform
from rmp_tpu_torch.sim.world import SimState, physics_step, sense
from rmp_tpu_torch.utils.checkpoint import _leaves, _rebuild


@dataclasses.dataclass
class EnvState:
    """Carried rollout state of B environments."""

    sim: SimState
    steps: torch.Tensor          # (B,) int32 control ticks taken
    solved_count: torch.Tensor   # (B,) int32 goals reached
    phase: torch.Tensor          # (B,) int32 env-specific goal index
    # progress window of the stuck detection (kept by _advance when the
    # scene sets Env.stuck_fn): the best EE-goal distance since the last
    # goal event, and the ticks since it last improved by more than
    # Env.progress_eps
    goal_best: torch.Tensor      # (B,) float32, +inf after each goal event
    no_progress: torch.Tensor    # (B,) int32
    # hull tier, B % 128 == 0: the previous tick's GJK witness directions
    # (B, L, K, 3), the next tick's start; None elsewhere
    gjk_warm: torch.Tensor | None = None
    # the random stream of the scene's resampling, on the envs' device
    rng: torch.Generator | None = None
    # the scene's private per-env state: nested dicts of (B, ...) tensors
    # (escape timers, waypoints, per-env knobs), kept by its pre_tick and
    # read by its bind_params, stuck_fn and on_solved; None if unused
    scratch: object = None
    # the rows of rng's stream (RowStream): env i draws row
    # (rng_offset + i) mod rng_size; None: one row per env of this batch
    rng_size: int | None = None
    rng_offset: int = 0

    @property
    def stream(self):
        """What the scene's draws take (sim.randomizer.uniform / normal):
        the generator itself where each env is its own row, else a
        RowStream over the stream's rows."""
        if self.rng_size is None or self.rng is None:
            return self.rng
        return RowStream(self.rng, self.rng_size, self.rng_offset)


def generator(device, seed: int) -> torch.Generator:
    """A torch.Generator on `device`, seeded."""
    return torch.Generator(device=device).manual_seed(seed)


def env_state(sim: SimState, seed: int = 0, scratch=None,
              rng: torch.Generator | None = None) -> EnvState:
    """Fresh bookkeeping for the states `sim`, with the resampling stream
    `rng` (default: a new one seeded by `seed`)."""
    B = sim.q.shape[0]
    zero = torch.zeros(B, dtype=torch.int32, device=sim.q.device)
    return EnvState(sim=sim, steps=zero, solved_count=zero.clone(),
                    phase=zero.clone(),
                    goal_best=torch.full((B,), float("inf"),
                                         device=sim.q.device),
                    no_progress=zero.clone(),
                    rng=rng if rng is not None
                    else generator(sim.q.device, seed),
                    scratch=scratch)


@dataclasses.dataclass
class Env:
    """One scene on one device.

    reset(batch, seed=0) -> EnvState of `batch` environments;
    on_solved(state) -> state is the scene's in-graph resampling (applied
    where a goal was reached, or where stuck_fn says the env is stuck);
    bind_params(params, sim, policies) injects state-carried quantities
    (the current goal) into the policy params each tick, and a
    bind_params(params, sim, policies, state) of four arguments also reads
    the EnvState (a detour goal from EnvState.scratch)."""

    name: str
    model: KinematicModel
    policies: tuple[Policy, ...]
    reset: Callable[..., EnvState]
    ee_frame: int
    device: torch.device
    dt: float = 0.01
    control_every: int = 10
    solved_tol: float = 0.02
    # the solved check reads the EE's x and y only (planar scenes)
    solved_xy_only: bool = False
    # the solved check also asks |q̇| < check_velocity
    check_velocity: float | None = None
    resolve_method: str = "pinv"
    # taskmap derivatives: 'analytic' (closed-form FK through K3) or
    # 'jacfwd' (forward-mode autodiff of each whole taskmap, no kernel)
    derivatives: str = "analytic"
    # physics through τ = clip(ID(q̈), ±effort), q̈ = FD(τ) each substep
    torque_mode: bool = False
    # clamp q̇ to the URDF velocity limits each substep (off: PyBullet does
    # not enforce them under torque control)
    enforce_velocity_limits: bool = False
    on_solved: Callable[[EnvState], EnvState] | None = None
    bind_params: Callable | None = None
    # divergence guard: zero non-finite commands and clamp |q̈|
    max_qdd: float | None = None
    # link collision geometry of the distance context: 'capsule' (fitted
    # multi-capsule links) or 'hull' (exact mesh hulls through K4)
    collision_geometry: str = "capsule"
    # hull tier: GJK iterations of the batched query (None: 10 without a
    # warm carry, 4 with one)
    hull_warm_iters: int | None = None
    # context_fn(model, sim, T_all) -> per-policy ctx dict in place of the
    # obstacle distance context, called on the whole batch; T_all is the
    # tick's world transforms (B, F, 4, 4) from K3, or None
    context_fn: Callable | None = None
    # update_scene(sim) -> sim, once per tick after the resolve and before
    # the substeps (moving goals and obstacles): the policies of tick k see
    # the scene as tick k-1 left it
    update_scene: Callable | None = None
    # stuck_fn(state) -> (B,) bool: where true, on_solved fires without a
    # goal counted (goal-timeout resampling); needs on_solved
    stuck_fn: Callable | None = None
    # pre_tick(state) -> state at the start of every tick, before the
    # policies (escape timers and waypoints). It must not touch sim.q or
    # sim.qd (the batched hull context is built after it from the same q)
    # nor move sim.goal to a temporary target (the solved check reads it):
    # a detour is bound through a state-aware bind_params
    pre_tick: Callable | None = None
    # is_solved_fn(env, sim) -> (B,) bool in place of the EE-goal check
    # (the dual arm: both EEs at their goals)
    is_solved_fn: Callable | None = None
    # EE-goal improvement (m) that resets EnvState.no_progress
    progress_eps: float = 0.01
    # goal_distance_fn(env, sim) -> (B,) distance of the progress window;
    # None: |EE - goal|
    goal_distance_fn: Callable | None = None
    # contact dynamics each substep (sim/contact.py): penalty forces at
    # the penetrating closest points, through the torque-level step
    contact: bool = False
    # aux_fn(model, sim) -> dict merged into the tick's aux after the
    # substeps (the per-pair clearances a training loss reads)
    aux_fn: Callable | None = None
    # 'bf16': the batched step's K1 call reads its row blocks in bfloat16
    # (the identity seed summed in float32 first), half of K1's input
    # bytes for ~1% in q̈; every sum and the LU stay float32. Only the
    # batched 'solve' path reads it, as JAX's fused path; None keeps
    # float32
    fused_blocks_dtype: str | None = None

    def gather_params(self) -> tuple:
        return tuple(p.params for p in self.policies)


def take_row(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] (B, ...) for a small table (K, ...) by a where-chain.

    An out-of-range idx falls through to row 0 (every comparison misses),
    unlike table[idx]; callers pre-clamp."""
    out = table[0].expand(idx.shape[0], *table.shape[1:])
    for k in range(1, table.shape[0]):
        hit = (idx == k).reshape(-1, *(1,) * (table.dim() - 1))
        out = torch.where(hit, table[k], out)
    return out


def bind_goal(policy_names: tuple[str, ...]):
    """bind_params helper: params['goal'] = sim.goal (B, 3) for the named
    policies."""
    def bind(params, sim, policies):
        out = []
        for p, prm in zip(policies, params):
            if p.name in policy_names and sim.goal is not None:
                prm = dict(prm)
                prm["goal"] = sim.goal
            out.append(prm)
        return tuple(out)
    return bind


def resample_goal(low, high, device):
    """on_solved: a new goal drawn uniformly from the box spanned by the
    corners low and high (3,), for every env; the tick keeps it where a
    goal was reached."""
    lo = torch.as_tensor(np.minimum(low, high), dtype=torch.float32,
                         device=device)
    span = torch.as_tensor(np.maximum(low, high), dtype=torch.float32,
                           device=device) - lo

    def on_solved(state: EnvState) -> EnvState:
        u = uniform(state.stream, state.sim.q.shape[0], 3)
        return dataclasses.replace(
            state, sim=dataclasses.replace(state.sim, goal=lo + span * u))
    return on_solved


_BIND_ARITY: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def call_bind(bind, params, sim, policies, state):
    """bind_params in either form: (params, sim, policies), or the
    state-aware (params, sim, policies, state). The arity is read once per
    function object (held weakly, so a new env never meets a stale entry of
    a collected one)."""
    arity = _BIND_ARITY.get(bind)
    if arity is None:
        arity = _BIND_ARITY[bind] = len(inspect.signature(bind).parameters)
    if arity >= 4:
        return bind(params, sim, policies, state)
    return bind(params, sim, policies)


def ee_position(env: Env, sim: SimState) -> torch.Tensor:
    return K.fk_frame(env.model, sim.q, env.ee_frame)[..., :3, 3]


def is_solved(env: Env, sim: SimState, ee: torch.Tensor) -> torch.Tensor:
    """(B,) bool: the scene's is_solved_fn where it has one; else the EE at
    ee (B, 3) within solved_tol of the goal (in x and y only with
    solved_xy_only), and |q̇| below check_velocity when that is set."""
    if env.is_solved_fn is not None:
        return env.is_solved_fn(env, sim)
    x, goal = ee, sim.goal
    if env.solved_xy_only:
        x, goal = x[:, :2], goal[:, :2]
    ok = torch.linalg.vector_norm(x - goal, dim=-1) < env.solved_tol
    if env.check_velocity is not None:
        ok = ok & (torch.linalg.vector_norm(sim.qd, dim=-1)
                   < env.check_velocity)
    return ok


def _bundle_transforms(env: Env, fk: dict | None):
    """The tick's world transforms (B, F, 4, 4) from the K3 bundle of the
    env's model, or None when the tick has none (no policy FK-rooted on
    it, or derivatives 'jacfwd')."""
    bundle = (fk or {}).get(id(env.model))
    if bundle is None:
        return None
    return bundle.T16.reshape(*bundle.T16.shape[:2], 4, 4)


def _world_transforms(env: Env, fk: dict | None,
                      q: torch.Tensor) -> torch.Tensor:
    """The tick's world transforms (B, F, 4, 4): from the K3 bundle, or by
    FK when there is none."""
    T_all = _bundle_transforms(env, fk)
    return K.fk_all(env.model, q) if T_all is None else T_all


def _policy_inputs(env: Env, state: EnvState, params: tuple,
                   frame_ctx: dict | None = None, fk: dict | None = None):
    """(q, q̇, bound params, per-policy ctxs, fk bundle) for one tick. The
    K3 transforms feed the distance context (or the scene's context_fn), so
    the tick runs one FK. frame_ctx: a distance context the caller already
    built (the batched hull tier), from the bundle `fk` it passes along.
    With derivatives 'jacfwd' there is no bundle (fk None)."""
    sim = state.sim
    policies = env.policies
    if env.bind_params is not None:
        params = call_bind(env.bind_params, params, sim, policies, state)
    if fk is None and env.derivatives == "analytic":
        fk = fk_bundle(policies, sim.q, sim.qd)
    if frame_ctx is None:
        T_all = _bundle_transforms(env, fk)
        if env.context_fn is not None:
            frame_ctx = env.context_fn(env.model, sim, T_all)
        else:
            _, _, frame_ctx = sense(env.model, sim, T_all,
                                    env.collision_geometry)
    ctxs = tuple(frame_ctx.get(p.ctx_key) if p.ctx_key else None
                 for p in policies)
    return sim.q, sim.qd, params, ctxs, fk


def _select(event: torch.Tensor, new, old):
    """Leafwise where(event, new, old) over (nested) state dataclasses,
    dicts and tuples of (B, ...) tensors; leaves the update did not touch
    (`new is old`) are kept as they are, and so is any leaf that is not a
    tensor (kinds, the generator)."""
    if new is old:
        return old
    if dataclasses.is_dataclass(old):
        return dataclasses.replace(old, **{
            f.name: _select(event, getattr(new, f.name), getattr(old, f.name))
            for f in dataclasses.fields(old)})
    if isinstance(old, dict):
        return {k: _select(event, new[k], v) for k, v in old.items()}
    if isinstance(old, tuple):
        return tuple(_select(event, a, b) for a, b in zip(new, old))
    if isinstance(old, torch.Tensor):
        e = event.reshape(event.shape + (1,) * (old.dim() - 1))
        return torch.where(e, new, old)
    return old


def _advance(env: Env, state: EnvState, qdd: torch.Tensor):
    """Physics substeps and goal bookkeeping for one tick."""
    model = env.model
    sim = state.sim
    if env.update_scene is not None:
        sim = env.update_scene(sim)
    if env.max_qdd is not None:
        qdd = torch.clamp(torch.nan_to_num(qdd, nan=0.0, posinf=0.0,
                                           neginf=0.0),
                          -env.max_qdd, env.max_qdd)
    for _ in range(env.control_every):
        sim = physics_step(model, sim, qdd, env.dt,
                           torque_mode=env.torque_mode,
                           enforce_velocity_limits=env.enforce_velocity_limits,
                           contact=env.contact)

    state = dataclasses.replace(state, sim=sim, steps=state.steps + 1)
    ee = None
    if sim.goal is not None:
        ee = ee_position(env, sim)
        solved = is_solved(env, sim, ee)
    else:
        solved = torch.zeros_like(state.steps, dtype=torch.bool)
    event = solved
    if env.stuck_fn is not None:
        if env.on_solved is None:
            raise ValueError(
                "Env.stuck_fn requires on_solved: the stuck signal fires "
                "the resampling hook and is dead without one")
        if sim.goal is not None:
            d = (env.goal_distance_fn(env, sim)
                 if env.goal_distance_fn is not None
                 else torch.linalg.vector_norm(ee - sim.goal, dim=-1))
            improved = d < state.goal_best - env.progress_eps
            state = dataclasses.replace(
                state, goal_best=torch.minimum(state.goal_best, d),
                no_progress=torch.where(improved, 0, state.no_progress + 1))
        event = solved | env.stuck_fn(state)
    solved_i = solved.to(torch.int32)
    if env.on_solved is not None:
        resampled = env.on_solved(dataclasses.replace(
            state, solved_count=state.solved_count + solved_i))
        state = _select(event, resampled, state)
        if env.stuck_fn is not None:
            # a fresh goal opens a fresh progress window
            state = dataclasses.replace(
                state,
                goal_best=torch.where(event, float("inf"), state.goal_best),
                no_progress=torch.where(event, 0, state.no_progress))
    else:
        # no resampling: solved_count saturates at 1 (the goal was reached)
        state = dataclasses.replace(
            state, solved_count=torch.maximum(state.solved_count, solved_i))
    aux = dict(solved=solved, qdd=qdd, ee=ee)
    if env.aux_fn is not None:
        aux.update(env.aux_fn(model, sim))
    if env.on_solved is not None:
        # the ticks where on_solved fired (a goal reached or a stuck env)
        aux["resample"] = event
    return state, aux


def _batched_hull(env: Env, states: EnvState) -> bool:
    """True when the tick builds the hull context for the whole batch with
    the broad phase and the warm carry (sim.data.hull_batched); other
    batches take the per-env semantics through sense. A scene with its own
    context_fn builds its context itself, as in the JAX package."""
    return (env.context_fn is None and states.sim.obstacles is not None
            and hull_batched(env.collision_geometry, states.sim.q.shape[0]))


def make_batched_control_step(env: Env):
    """fn(states, params) -> (states, aux) for one tick of B environments,
    with the whole batch resolved at once and env.resolve_method honoured:
    'solve' -> the K1 pullback + pivoted-LU wrapper (ridge 0; its blocks
    in bfloat16 where env.fused_blocks_dtype is 'bf16'), others -> einsum
    accumulation and core.resolve."""
    if env.fused_blocks_dtype not in (None, "bf16"):
        raise ValueError(f"fused_blocks_dtype must be None or 'bf16', got "
                         f"{env.fused_blocks_dtype!r}")
    block_dtype = torch.bfloat16 if env.fused_blocks_dtype == "bf16" else None
    policies = env.policies

    def step(states: EnvState, params: tuple):
        if env.pre_tick is not None:
            # before the hull context, as in the JAX package: pre_tick
            # leaves q alone, and its scratch must reach bind_params
            states = env.pre_tick(states)
        fk = frame_ctx = warm_next = None
        if _batched_hull(env, states):
            if env.derivatives == "analytic":
                fk = fk_bundle(policies, states.sim.q, states.sim.qd)
            frame_ctx, warm_next = distance_context_batched(
                env.model, _world_transforms(env, fk, states.sim.q),
                states.sim.obstacles, "hull",
                warm=states.gjk_warm, iters=env.hull_warm_iters)
        q, qd, params_b, ctxs, fk = _policy_inputs(env, states, params,
                                                   frame_ctx, fk)
        tags, blocks = policy_row_blocks_structured(
            policies, q, qd, params_b, ctxs, derivatives=env.derivatives,
            fk=fk)
        if env.resolve_method == "solve":
            qdd = pullback_resolve_structured(tags, blocks, ridge=0.0,
                                              block_dtype=block_dtype)
        else:
            A, f = assemble_structured(tags, blocks)
            qdd = resolve(A, f, env.resolve_method)
        states, aux = _advance(env, states, qdd)
        if warm_next is not None:
            # kept through resamples: on_solved moves only the goal, so the
            # converged witness directions still hold
            states = dataclasses.replace(states, gjk_warm=warm_next)
        return states, aux
    return step


def _wants_gjk_warm(env: Env, states: EnvState) -> bool:
    """True when the batched hull tier will run and no carry exists yet."""
    return states.gjk_warm is None and _batched_hull(env, states)


def _seed_gjk_warm(env: Env, states: EnvState) -> EnvState:
    """states with gjk_warm seeded by one cold 10-iteration hull query: the
    warm iteration count then always starts from a converged witness."""
    T_all = K.fk_all(env.model, states.sim.q)
    _, warm = distance_context_batched(env.model, T_all, states.sim.obstacles,
                                       "hull", iters=COLD_ITERS)
    return dataclasses.replace(states, gjk_warm=warm)


def fold_batch(states: EnvState, copies: int) -> EnvState:
    """`copies` copies of a whole batch of B envs end to end (copy-major,
    copies x B envs), each copy drawing the batch's own rows of the one
    stream (rng_size B): every copy sees the same scenes and the same
    resampling draws, as JAX's vmap over configs of one batch does. The
    generator is shared, not copied."""
    B = states.sim.q.shape[0]
    if states.rng_offset or states.rng_size not in (None, B):
        raise ValueError("fold_batch takes a whole batch, not a rank's slice")

    def rep(x):
        return torch.cat([x] * copies) if isinstance(x, torch.Tensor) else x
    folded = _rebuild(states, iter([rep(x) for x in _leaves(states)]))
    return dataclasses.replace(folded, rng_size=B, rng_offset=0)


def make_batched_reset(env: Env, batch: int, seed: int = 0):
    """fn() -> EnvState of `batch` environments, with the hull tier's warm
    carry seeded. The reset draws nothing; `seed` seeds the stream the
    scene's resampling draws from (EnvState.rng)."""
    def reset():
        states = env.reset(batch, seed)
        if _wants_gjk_warm(env, states):
            states = _seed_gjk_warm(env, states)
        return states
    return reset


def _run_ticks(step, states: EnvState, params: tuple, n_ticks: int,
               with_aux: bool):
    """n_ticks of `step`; aux stacks each per-tick entry along axis 1
    (B, T, ...), or is None with with_aux=False."""
    auxes = []
    for _ in range(n_ticks):
        states, aux = step(states, params)
        if with_aux:
            auxes.append(aux)
    if not with_aux:
        return states, None
    return states, {k: torch.stack([a[k] for a in auxes], dim=1)
                    for k, v in auxes[0].items() if v is not None}


def rematerialized(step):
    """step(states, params) with its graph dropped in the forward and
    recomputed in the backward (torch.utils.checkpoint, non-reentrant): the
    activation memory of a rollout's gradient falls from ticks x tick graph
    to ticks x state, for one more forward per tick.

    checkpoint restores only the global random streams, and a tick may draw
    from EnvState.rng (a resampled goal, a randomized pre_tick). So the
    generator's state is taken at the tick's start, and the recomputation
    draws from a private generator set to it: it redraws the forward's
    numbers, builds the same graph, and leaves the env's stream where the
    forward left it."""
    def run(states: EnvState, params: tuple):
        rng = states.rng
        start = None if rng is None else rng.get_state()
        calls = 0

        def tick(states, params):
            nonlocal calls
            calls += 1
            if calls > 1 and rng is not None:
                private = torch.Generator(device=rng.device)
                private.set_state(start)
                states = dataclasses.replace(states, rng=private)
            return step(states, params)
        return checkpoint(tick, states, params, use_reentrant=False)
    return run


def make_batched_rollout(env: Env, n_ticks: int, with_aux: bool = True,
                         remat: bool = False):
    """fn(states, params) -> (final states, aux) over n_ticks batched ticks;
    aux stacks each per-tick entry along axis 1 (B, T, ...), or is None
    with with_aux=False. remat: each tick rematerialized in the backward
    (`rematerialized`)."""
    step = make_batched_control_step(env)
    if remat:
        step = rematerialized(step)

    def rollout(states: EnvState, params: tuple):
        if _wants_gjk_warm(env, states):
            states = _seed_gjk_warm(env, states)
        return _run_ticks(step, states, params, n_ticks, with_aux)
    return rollout


def make_control_step(env: Env):
    """fn(states, params) -> (states, aux) for one tick with the JAX
    package's per-env semantics on a batched state: evaluate_policies and
    core.resolve(env.resolve_method) (never K1), and the distance context
    through sense (in the hull tier every pair cold, no warm carry)."""
    def step(states: EnvState, params: tuple):
        if env.pre_tick is not None:
            states = env.pre_tick(states)
        q, qd, params_b, ctxs, fk = _policy_inputs(env, states, params)
        qdd = evaluate_policies(env.policies, q, qd, params_b, ctxs,
                                method=env.resolve_method,
                                derivatives=env.derivatives, fk=fk)
        return _advance(env, states, qdd)
    return step


def make_rollout(env: Env, n_ticks: int, with_aux: bool = True,
                 remat: bool = False):
    """fn(states, params) -> (final states, aux): n_ticks of
    make_control_step, aux and remat as in make_batched_rollout."""
    step = make_control_step(env)
    if remat:
        step = rematerialized(step)

    def rollout(states: EnvState, params: tuple):
        return _run_ticks(step, states, params, n_ticks, with_aux)
    return rollout
