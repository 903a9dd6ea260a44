"""The PyTorch port's robot model and small-matrix ops against the JAX
package, on the same numpy inputs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu.models import robots as jrobots
from rmp_tpu.ops import geom as jgeom
from rmp_tpu.ops import linalg as jlinalg
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.ops import geom, linalg

torch.set_num_threads(1)

GEOM_ATOL = 1e-6


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def test_panda_model_equals_jax_field_by_field():
    got, want = robots.franka_panda(), jrobots.franka_panda()
    for field in dataclasses.fields(want):
        g, w = getattr(got, field.name), getattr(want, field.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, field.name
            assert np.array_equal(g, w), field.name
        elif field.name == "collision":
            assert [[dataclasses.astuple(p) for p in frame] for frame in g] \
                == [[dataclasses.astuple(p) for p in frame] for frame in w]
        else:
            assert g == w, field.name
    assert got.collision_frames == want.collision_frames
    assert sum(len(c) for c in got.collision) == 25
    for k in range(want.n_frames):
        assert got.chain(k) == want.chain(k)


def test_panda_constants_equal_jax():
    for name in ("PANDA_Q_READY", "PANDA_Q_LIM_LOW", "PANDA_Q_LIM_HIGH"):
        g, w = getattr(robots, name), getattr(jrobots, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert robots.PANDA_EE_FRAME == jrobots.PANDA_EE_FRAME


def _rigid(rng, B):
    R = jgeom.rotation_matrix_from_rpy(
        jnp.asarray(rng.uniform(-3, 3, (B, 3)), jnp.float32))
    t = jnp.asarray(rng.normal(size=(B, 3)), jnp.float32)
    return np.asarray(jgeom.hom(R, t))


def _case_hom(rng):
    R = np.asarray(jgeom.rotation_matrix_from_rpy(
        jnp.asarray(rng.uniform(-3, 3, (16, 3)), jnp.float32)))
    t = rng.normal(size=(16, 3)).astype(np.float32)
    return geom.hom(_t(R), _t(t)), jgeom.hom(jnp.asarray(R), jnp.asarray(t))


def _case_hom_inverse(rng):
    T = _rigid(rng, 16)
    return geom.hom_inverse(_t(T)), jgeom.hom_inverse(jnp.asarray(T))


def _case_transform_point(rng):
    T = _rigid(rng, 16)
    p = rng.normal(size=(16, 3)).astype(np.float32)
    return (geom.transform_point(_t(T), _t(p)),
            jgeom.transform_point(jnp.asarray(T), jnp.asarray(p)))


def _case_axis_angle(rng):
    axis = rng.normal(size=(16, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    axis[:3] = 0.0                       # zero axis -> identity (fixed joint)
    axis = axis.astype(np.float32)
    angle = rng.uniform(-3, 3, 16).astype(np.float32)
    return (geom.rotation_matrix_from_axis_angle(_t(axis), _t(angle)),
            jgeom.rotation_matrix_from_axis_angle(jnp.asarray(axis),
                                                  jnp.asarray(angle)))


def _case_rpy(rng):
    rpy = rng.uniform(-3, 3, (16, 3)).astype(np.float32)
    return (geom.rotation_matrix_from_rpy(_t(rpy)),
            jgeom.rotation_matrix_from_rpy(jnp.asarray(rpy)))


@pytest.mark.parametrize("case", [_case_hom, _case_hom_inverse,
                                  _case_transform_point, _case_axis_angle,
                                  _case_rpy])
def test_geom_matches_jnp(case):
    got, want = case(np.random.default_rng(5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GEOM_ATOL)


def test_safe_denom_matches_jnp():
    d = np.array([0.0, -0.0, 1e-13, -1e-13, 1e-12, -1e-12, 0.5, -2.0],
                 np.float32)
    got = linalg.safe_denom(_t(d)).numpy()
    want = np.asarray(jlinalg.safe_denom(jnp.asarray(d)))
    np.testing.assert_array_equal(got, want)
    assert np.all(np.abs(got) >= np.float32(1e-12))


def _lu_cases():
    r = np.random.default_rng(17)
    well = r.normal(size=(32, 9, 9)) + 9.0 * np.eye(9)
    # the indefinite systems of test_policies_core.py::
    # test_lu_solve_unrolled_indefinite
    indef = r.normal(size=(10, 9, 9))
    indef = indef + indef.transpose(0, 2, 1)
    return {"well_conditioned": (well, r.normal(size=(32, 9))),
            "indefinite": (indef, r.normal(size=(10, 9)))}


@pytest.mark.parametrize("name", ["well_conditioned", "indefinite"])
def test_lu_solve_unrolled_matches_jnp(name):
    A, b = (x.astype(np.float32) for x in _lu_cases()[name])
    got = linalg.lu_solve_unrolled(_t(A), _t(b)).numpy()
    want = np.asarray(jlinalg.lu_solve_unrolled(jnp.asarray(A),
                                                jnp.asarray(b)))
    # same elimination order in both; the indefinite systems' solutions
    # reach |x| ~ 10, so the absolute tolerance scales with |x|
    np.testing.assert_allclose(got, want,
                               atol=GEOM_ATOL * max(1.0, np.abs(want).max()))


def test_lu_solve_unrolled_singular_stays_finite():
    r = np.random.default_rng(3)
    u = r.normal(size=9).astype(np.float32)
    A = np.stack([np.outer(u, u), np.zeros((9, 9), np.float32)])
    b = r.normal(size=(2, 9)).astype(np.float32)
    assert np.isfinite(linalg.lu_solve_unrolled(_t(A), _t(b)).numpy()).all()


def test_cholesky_solve_unrolled_matches_jnp():
    r = np.random.default_rng(4)
    L = r.normal(size=(16, 9, 9))
    A = (L @ L.transpose(0, 2, 1) + np.eye(9)).astype(np.float32)
    b = r.normal(size=(16, 9)).astype(np.float32)
    got = linalg.cholesky_solve_unrolled(_t(A), _t(b)).numpy()
    want = np.asarray(jlinalg.cholesky_solve_unrolled(jnp.asarray(A),
                                                      jnp.asarray(b)))
    np.testing.assert_allclose(got, want,
                               atol=GEOM_ATOL * max(1.0, np.abs(want).max()))
