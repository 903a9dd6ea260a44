"""Where the port's flagship rollout may part from the JAX package's, and why.

From states moved by q ± 0.3, q̇ ± 0.5 around the ready pose, some envs
reach the JointVelocityCap clip (|q̇| >= max_velocity - 1e-6). There
1 - ratio² is ~1.3e-5, one rounding of ratio moves the metric by up to 1%,
and the reference itself moves by up to ~5e-2 in q over 5 ticks when its
inputs move by one ulp. Three runs hold the port to that:

- the JAX rollout twice, the second time with q and q̇ moved by one ulp:
  the per-env spread is the reference's own sensitivity s;
- the port in float32 (CPU, plain versions of the kernels);
- the port in float64 (CPU, plain versions), the witness that is free of
  float32 rounding.

    PYTHONPATH=. python tests/test_torch_conditioning.py

prints the per-env table.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu import envs as jenvs
from rmp_tpu.policies import v2 as jv2
from rmp_tpu_torch import convert, envs
from rmp_tpu_torch.models.fk_derivatives import fk_derivatives
from rmp_tpu_torch.ops.cuda_resolve import pullback_resolve_structured_plain
from rmp_tpu_torch.policies import v2
from test_torch_envs import jax_state_leaves

torch.set_num_threads(1)

SCENE = "franka/06_cluttered_environment"
B, T = 128, 5
STABLE = 1e-5        # s <= STABLE: the reference is insensitive here
ATOL = 5e-4          # the tick-parity tolerance of test_torch_envs.py
SPREAD = 5.0         # an fp32 run may part from fp64 by SPREAD * s


def _to(x, dtype):
    """Every floating tensor of a (nested) state or param tree as dtype."""
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _to(getattr(x, f.name), dtype)
                                         for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _to(v, dtype) for k, v in x.items()}
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(dtype)
    return x


def runs() -> dict:
    """Per-env max |Δq| after T ticks between the runs of the module doc."""
    rng = np.random.default_rng(31)
    jenv = jenvs.make(SCENE)
    jenv.resolve_method = "solve"
    states = jenvs.make_batched_reset(jenv, B)(jax.random.PRNGKey(0))
    q = (np.asarray(states.sim.q)
         + rng.uniform(-0.3, 0.3, (B, 9))).astype(np.float32)
    qd = rng.uniform(-0.5, 0.5, (B, 9)).astype(np.float32)
    params = jenv.gather_params()
    rollout = jax.jit(jenvs.make_batched_rollout(jenv, T))

    def jax_q(q, qd):
        s = dataclasses.replace(states, sim=dataclasses.replace(
            states.sim, q=jnp.asarray(q), qd=jnp.asarray(qd)))
        return s, np.asarray(rollout(s, params)[0].sim.q, np.float64)

    start, q_ref = jax_q(q, qd)
    up = np.float32(np.inf)
    _, q_ulp = jax_q(np.nextafter(q, up), np.nextafter(qd, up))

    env = envs.make(SCENE, device="cpu")
    env.resolve_method = "solve"
    leaves = jax.tree.map(np.asarray, jax_state_leaves(start))
    nparams = jax.tree.map(np.asarray, params)
    port = {}
    with pytest.MonkeyPatch.context() as mp:
        for dtype in (torch.float32, torch.float64):
            if dtype == torch.float64:
                # the kernel wrappers take float32 only: call the plain
                # versions the CPU path runs anyway
                mp.setattr("rmp_tpu_torch.envs.base.pullback_resolve_structured",
                           pullback_resolve_structured_plain)
                mp.setattr("rmp_tpu_torch.core.fk_derivatives_batched",
                           fk_derivatives)
            state = _to(convert.state_from_numpy(leaves, "cpu"), dtype)
            tparams = tuple(_to(p, dtype) for p in
                            convert.params_from_numpy(nparams, "cpu"))
            step = envs.make_batched_control_step(env)
            vmax = state.sim.qd.abs().amax(dim=1)
            for _ in range(T):
                state, _ = step(state, tparams)
                vmax = torch.maximum(vmax, state.sim.qd.abs().amax(dim=1))
            assert state.sim.q.dtype == dtype
            port[dtype] = state.sim.q.double().numpy()
            port["vmax", dtype] = vmax.double().numpy()

    def gap(a, b):
        return np.abs(a - b).max(axis=1)

    return dict(s=gap(q_ulp, q_ref),
                port32_ref=gap(port[torch.float32], q_ref),
                ref_fp64=gap(q_ref, port[torch.float64]),
                port32_fp64=gap(port[torch.float32], port[torch.float64]),
                # the largest |q̇| an env reached (port, float32)
                vmax=port["vmax", torch.float32])


@pytest.fixture(scope="module")
def gaps():
    return runs()


def test_port_parts_from_reference_only_where_reference_is_unstable(gaps):
    stable = gaps["s"] <= STABLE
    assert stable.sum() >= B // 2, f"only {stable.sum()} stable envs"
    worst = gaps["port32_ref"][stable].max()
    assert worst < ATOL, f"port vs reference on stable envs: {worst}"


@pytest.mark.parametrize("run", ["port32_fp64", "ref_fp64"])
def test_fp32_runs_stay_within_their_sensitivity_of_fp64(gaps, run):
    """Both float32 runs, the port's and the reference's, stay near the
    float64 witness, by at most SPREAD times the reference's one-ulp
    spread (at least ATOL)."""
    limit = np.maximum(ATOL, SPREAD * gaps["s"])
    bad = np.flatnonzero(gaps[run] > limit)
    assert bad.size == 0, [(int(i), gaps[run][i], gaps["s"][i]) for i in bad]


def test_velocity_cap_metric_rounds_like_the_reference():
    """At the clip, the port's float32 metric equals the JAX leaf's when
    its params are traced as float32 arrays, as the rollout traces them."""
    params = dict(max_velocity=0.5, velocity_damping_region=0.15,
                  damping_gain=5.0, metric_weight=0.05)
    rng = np.random.default_rng(5)
    xd = rng.uniform(-1.5, 1.5, (16, 1, 9)).astype(np.float32)
    xd[:, :, :4] = np.float32(0.5)               # exactly at the clip
    want_a, want_M = jax.jit(jv2._velocity_cap_accel_metric)(
        jax.tree.map(jnp.float32, params), jnp.zeros_like(xd),
        jnp.asarray(xd), None)
    a, M = v2._velocity_cap_accel_metric(params, torch.zeros(16, 1, 9),
                                         torch.tensor(xd), None)
    np.testing.assert_allclose(M.numpy(), np.asarray(want_M), rtol=1e-6)
    np.testing.assert_allclose(a.numpy(), np.asarray(want_a), rtol=1e-6,
                               atol=1e-6)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    g = runs()
    vmax = g.pop("vmax")
    clip = vmax >= 0.5 - 1e-6               # the flagship's max_velocity
    print("env  s (ref vs ref+1ulp)  port32-ref  ref-fp64  port32-fp64  "
          "at the clip")
    for i in np.flatnonzero(np.maximum.reduce(list(g.values())) > STABLE):
        print(f"{i:3d}  {g['s'][i]:.3e}  {g['port32_ref'][i]:.3e}  "
              f"{g['ref_fp64'][i]:.3e}  {g['port32_fp64'][i]:.3e}  {clip[i]}")
    for k, v in g.items():
        print(f"max {k}: {v.max():.3e}")
    stable = g["s"] <= STABLE
    print(f"stable envs {stable.sum()} of {B}; port32-ref there "
          f"{g['port32_ref'][stable].max():.3e}; unstable envs at the clip "
          f"{(clip & ~stable).sum()} of {(~stable).sum()}; envs at the clip "
          f"{clip.sum()}")
