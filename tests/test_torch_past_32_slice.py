"""Past 32 motors on the CPU, the rest of the slice: K3's plain version on
four Pandas in one tree (make_multi_spec over PANDA_SPEC: 52 frames, 36
motors), the 33-link arm (34, 33) and a branched tree past 32 motors (40
links with a branch of 8 off link 20: 50 frames, 48 motors) against the
JAX package's fk_derivatives under vmap; and one batched tick of
envs/planar.planar_arm_env(33) (K3's and K1's plain versions on the CPU)
against the same env built from the JAX package's public pieces
(test_torch_generality.jax_planar_env), from the same perturbed states,
behind that file's float64 screen. JAX's rollout runs eagerly (~40 s at
33 links on a CPU host): XLA takes ~200 s to compile it."""
import jax
import numpy as np
import pytest
import torch

from rmp_tpu.envs import base as jbase
from rmp_tpu.models import specs as jspecs
from rmp_tpu_torch import convert, core, envs
from rmp_tpu_torch.envs import planar
from rmp_tpu_torch.models import specs
from rmp_tpu_torch.models.fk_derivatives import fk_derivatives
from rmp_tpu_torch.ops import cuda_fk, cuda_resolve
from test_torch_envs import jax_state_leaves
from test_torch_fk_wide import branched
from test_torch_generality import (B, Q_TOL, STABLE, as_dtype,
                                   jax_planar_env, perturbed)
from test_torch_past_32 import assert_k3_matches_jax

torch.set_num_threads(1)

T = 1                # ticks of the slice's parity


def four_pandas(sp):
    """Four Pandas of specs module `sp` in one tree (chip_smoke's
    four_pandas)."""
    return sp.build_model(sp.make_multi_spec(
        sp.PANDA_SPEC, ((0.0, 0.45, 0.0), (0.0, -0.45, 0.0),
                        (1.2, 0.45, 0.0), (1.2, -0.45, 0.0)),
        (0.0, 0.0, np.pi, np.pi), ("A_", "B_", "C_", "D_"),
        name="panda_x4"))


@pytest.mark.parametrize("which", ["four_pandas", "planar_33", "branched"])
def test_plain_k3_matches_jax_past_32_motors(which):
    """K3's plain version against JAX on the models of the (72, 64) tile
    other than the 64-link arms (test_torch_past_32.py)."""
    make = {"four_pandas": four_pandas,
            "planar_33": lambda sp: sp.build_model(
                sp.make_planar_arm_spec(33)),
            "branched": lambda sp: branched(sp, 40, 8, 20)}[which]
    model = make(specs)
    want = {"four_pandas": (52, 36), "planar_33": (34, 33),
            "branched": (50, 48)}[which]
    assert (model.n_frames, model.n_q) == want
    assert cuda_fk.tile_of(model) == (72, 64, 2)
    assert_k3_matches_jax(model, make(jspecs))


def test_planar_33_tick_parity_with_jax(monkeypatch):
    """T ticks of the port's batched 'solve' step at 33 links (K3's and
    K1's plain versions: on the card the (72, 64) tile and the CTA kernel)
    against JAX's batched rollout from 8 perturbed reset states: q within
    Q_TOL on every env that a float64 run of the port keeps within STABLE
    of the float32 one, at least half of them."""
    jenv = jax_planar_env(33)
    states = perturbed(jenv, 36)
    params = jenv.gather_params()
    with jax.disable_jit():
        jfinal, _ = jbase.make_batched_rollout(jenv, T)(states, params)

    env = planar.planar_arm_env(33, device="cpu")
    assert [p.name for p in env.policies] == [p.name for p in jenv.policies]
    leaves = jax.tree.map(np.asarray, jax_state_leaves(states))
    state = convert.state_from_numpy(leaves, "cpu")
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        "cpu")
    q, qd, prm, ctxs, fk = envs.base._policy_inputs(env, state, tparams)
    tags, blocks = core.policy_row_blocks_structured(env.policies, q, qd,
                                                     prm, ctxs, fk=fk)
    assert tags == ("dense", "identity", "identity", "scalar")
    assert blocks[1][0].shape == (B, 33, 33)

    final, _ = envs.make_batched_rollout(env, T)(state, tparams)
    # the float64 witness: the kernels' plain versions on the same problem
    monkeypatch.setattr(envs.base, "pullback_resolve_structured",
                        cuda_resolve.pullback_resolve_structured_plain)
    monkeypatch.setattr(core, "fk_derivatives_batched", fk_derivatives)
    f64, _ = envs.make_batched_rollout(env, T)(
        as_dtype(state, torch.float64), as_dtype(tparams, torch.float64))
    assert f64.sim.q.dtype == torch.float64
    held = (f64.sim.q - final.sim.q.double()).abs().amax(dim=1) <= STABLE
    assert int(held.sum()) >= B // 2
    err = np.abs(final.sim.q.numpy() - np.asarray(jfinal.sim.q)).max(axis=1)
    print(f"planar_33 after {T} tick: max|Δq| {err.max():.3e} over all, "
          f"{err[held.numpy()].max():.3e} on the {int(held.sum())} held")
    assert np.isfinite(final.sim.q.numpy()).all()
    assert err[held.numpy()].max() < Q_TOL, f"q after {T} ticks: {err}"
