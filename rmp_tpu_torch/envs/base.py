"""Environment machinery: batched scenes and their control tick.

The port's `rmp_tpu/envs/base.py` for the batched, fused path. One control
tick senses (closed-form FK through K3, capsule distance context), builds the
structured per-policy pullback blocks, resolves the whole batch at once
(K1 for resolve_method 'solve'; einsum accumulation + core.resolve for
'pinv' and 'cholesky'), then runs `control_every` integrator substeps with
the latched q̈ and the in-graph goal bookkeeping. A rollout is a Python loop
over ticks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from rmp_tpu_torch.core import fk_bundle, policy_row_blocks_structured, resolve
from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.models.urdf import KinematicModel
from rmp_tpu_torch.ops.cuda_resolve import (assemble_structured,
                                            pullback_resolve_structured)
from rmp_tpu_torch.policies.base import Policy
from rmp_tpu_torch.sim.world import SimState, physics_step, sense


@dataclasses.dataclass
class EnvState:
    """Carried rollout state of B environments."""

    sim: SimState
    steps: torch.Tensor          # (B,) int32 control ticks taken
    solved_count: torch.Tensor   # (B,) int32 goals reached
    phase: torch.Tensor          # (B,) int32 env-specific goal index
    # progress bookkeeping of the JAX package's stuck detection; carried
    # for state parity (no ported scene sets a stuck predicate)
    goal_best: torch.Tensor      # (B,) float32, +inf after each goal event
    no_progress: torch.Tensor    # (B,) int32


def env_state(sim: SimState) -> EnvState:
    B = sim.q.shape[0]
    zero = torch.zeros(B, dtype=torch.int32, device=sim.q.device)
    return EnvState(sim=sim, steps=zero, solved_count=zero.clone(),
                    phase=zero.clone(),
                    goal_best=torch.full((B,), float("inf"),
                                         device=sim.q.device),
                    no_progress=zero.clone())


@dataclasses.dataclass
class Env:
    """One scene on one device.

    reset(batch) -> EnvState of `batch` environments; on_solved(state) ->
    state is the scene's in-graph resampling (applied where a goal was
    reached); bind_params(params, sim, policies) injects state-carried
    quantities (the current goal) into the policy params each tick."""

    name: str
    model: KinematicModel
    policies: tuple[Policy, ...]
    reset: Callable[[int], EnvState]
    ee_frame: int
    device: torch.device
    dt: float = 0.01
    control_every: int = 10
    solved_tol: float = 0.02
    resolve_method: str = "pinv"
    on_solved: Callable[[EnvState], EnvState] | None = None
    bind_params: Callable | None = None
    # divergence guard: zero non-finite commands and clamp |q̈|
    max_qdd: float | None = None

    def gather_params(self) -> tuple:
        return tuple(p.params for p in self.policies)


def take_row(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] (B, d) for a small table (K, d) by a where-chain.

    An out-of-range idx falls through to row 0 (every comparison misses),
    unlike table[idx]; callers pre-clamp."""
    out = table[0].expand(idx.shape[0], *table.shape[1:])
    for k in range(1, table.shape[0]):
        out = torch.where((idx == k)[:, None], table[k], out)
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


def ee_position(env: Env, sim: SimState) -> torch.Tensor:
    return K.fk_frame(env.model, sim.q, env.ee_frame)[..., :3, 3]


def _policy_inputs(env: Env, state: EnvState, params: tuple):
    """(q, q̇, bound params, per-policy ctxs, fk bundle) for one tick. The
    K3 transforms feed the distance context, so the tick runs one FK."""
    sim = state.sim
    policies = env.policies
    if env.bind_params is not None:
        params = env.bind_params(params, sim, policies)
    fk = fk_bundle(policies, sim.q, sim.qd)
    bundle = fk.get(id(env.model))
    T_all = None
    if bundle is not None:
        T_all = bundle.T16.reshape(*bundle.T16.shape[:2], 4, 4)
    q, qd, frame_ctx = sense(env.model, sim, T_all)
    ctxs = tuple(frame_ctx.get(p.ctx_key) if p.ctx_key else None
                 for p in policies)
    return q, qd, params, ctxs, fk


def _select(event: torch.Tensor, new, old):
    """Leafwise where(event, new, old) over (nested) state dataclasses;
    leaves the update did not touch (`new is old`) are kept as they are."""
    if new is old:
        return old
    if dataclasses.is_dataclass(old):
        return dataclasses.replace(old, **{
            f.name: _select(event, getattr(new, f.name), getattr(old, f.name))
            for f in dataclasses.fields(old)})
    if isinstance(old, torch.Tensor):
        e = event.reshape(event.shape + (1,) * (old.dim() - 1))
        return torch.where(e, new, old)
    return old


def _advance(env: Env, state: EnvState, qdd: torch.Tensor):
    """Physics substeps and goal bookkeeping for one tick."""
    model = env.model
    sim = state.sim
    if env.max_qdd is not None:
        qdd = torch.clamp(torch.nan_to_num(qdd, nan=0.0, posinf=0.0,
                                           neginf=0.0),
                          -env.max_qdd, env.max_qdd)
    for _ in range(env.control_every):
        sim = physics_step(model, sim, qdd, env.dt)

    state = dataclasses.replace(state, sim=sim, steps=state.steps + 1)
    ee = None
    if sim.goal is not None:
        ee = ee_position(env, sim)
        solved = torch.linalg.vector_norm(ee - sim.goal, dim=-1) \
            < env.solved_tol
    else:
        solved = torch.zeros_like(state.steps, dtype=torch.bool)
    solved_i = solved.to(torch.int32)
    if env.on_solved is not None:
        resampled = env.on_solved(dataclasses.replace(
            state, solved_count=state.solved_count + solved_i))
        state = _select(solved, resampled, state)
    else:
        # no resampling: solved_count saturates at 1 (the goal was reached)
        state = dataclasses.replace(
            state, solved_count=torch.maximum(state.solved_count, solved_i))
    aux = dict(solved=solved, qdd=qdd, ee=ee)
    if env.on_solved is not None:
        aux["resample"] = solved
    return state, aux


def make_batched_control_step(env: Env):
    """fn(states, params) -> (states, aux) for one tick of B environments,
    with the whole batch resolved at once and env.resolve_method honoured:
    'solve' -> the K1 pullback + pivoted-LU wrapper (ridge 0), others ->
    einsum accumulation and core.resolve."""
    policies = env.policies

    def step(states: EnvState, params: tuple):
        q, qd, params_b, ctxs, fk = _policy_inputs(env, states, params)
        tags, blocks = policy_row_blocks_structured(policies, q, qd, params_b,
                                                    ctxs, fk=fk)
        if env.resolve_method == "solve":
            qdd = pullback_resolve_structured(tags, blocks, ridge=0.0)
        else:
            A, f = assemble_structured(tags, blocks)
            qdd = resolve(A, f, env.resolve_method)
        return _advance(env, states, qdd)
    return step


def make_batched_reset(env: Env, batch: int):
    """fn() -> EnvState of `batch` environments (the reset is
    deterministic: no random draw)."""
    return lambda: env.reset(batch)


def make_batched_rollout(env: Env, n_ticks: int, with_aux: bool = True):
    """fn(states, params) -> (final states, aux) over n_ticks ticks; aux
    stacks each per-tick entry along axis 1 (B, T, ...), or is None with
    with_aux=False."""
    step = make_batched_control_step(env)

    def rollout(states: EnvState, params: tuple):
        auxes = []
        for _ in range(n_ticks):
            states, aux = step(states, params)
            if with_aux:
                auxes.append(aux)
        if not with_aux:
            return states, None
        return states, {k: torch.stack([a[k] for a in auxes], dim=1)
                        for k, v in auxes[0].items() if v is not None}
    return rollout
