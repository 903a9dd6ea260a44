"""The port's FK and the plain version of its FK-derivative kernel (K3)
against the JAX package, on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu.models import fk_derivatives as jfkd
from rmp_tpu.models import kinematics as jK
from rmp_tpu.models import robots as jrobots
from rmp_tpu_torch.models import fk_derivatives as fkd
from rmp_tpu_torch.models import kinematics as K
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.models.urdf import FIXED
from rmp_tpu_torch.ops import cuda_fk

torch.set_num_threads(1)

B = 64
ATOL = 2e-4          # the tolerance of tests/test_pallas_fk.py


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(12)
    q = rng.uniform(-1.2, 1.2, (B, 9)).astype(np.float32)
    qd = rng.uniform(-1.0, 1.0, (B, 9)).astype(np.float32)
    return q, qd


@pytest.fixture(scope="module")
def jax_fkd(inputs):
    q, qd = inputs
    model = jrobots.franka_panda()
    out = jax.jit(jax.vmap(lambda a, b: jfkd.fk_derivatives(model, a, b)))(
        jnp.asarray(q), jnp.asarray(qd))
    return tuple(np.asarray(x) for x in out)


def test_joint_transforms_match_jax(inputs):
    q, _ = inputs
    want = jax.vmap(lambda a: jK.joint_transforms(jrobots.franka_panda(), a))(
        jnp.asarray(q))
    got = K.joint_transforms(robots.franka_panda(), torch.tensor(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_fk_all_matches_jax(inputs):
    q, _ = inputs
    want = jax.vmap(lambda a: jK.fk_all(jrobots.franka_panda(), a))(
        jnp.asarray(q))
    got = K.fk_all(robots.franka_panda(), torch.tensor(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_fk_frame_matches_fk_all(inputs):
    q, _ = inputs
    model = robots.franka_panda()
    T_all = K.fk_all(model, torch.tensor(q))
    ee = model.frame_index(robots.PANDA_EE_FRAME)
    np.testing.assert_allclose(K.fk_frame(model, torch.tensor(q), ee).numpy(),
                               T_all[:, ee].numpy(), atol=1e-6)


@pytest.mark.parametrize("index,name", enumerate(("T16", "Td16", "J16", "c16")))
def test_plain_fk_derivatives_match_jax(inputs, jax_fkd, index, name):
    q, qd = inputs
    got = fkd.fk_derivatives(robots.franka_panda(), torch.tensor(q),
                             torch.tensor(qd))
    assert got[index].shape == jax_fkd[index].shape, name
    np.testing.assert_allclose(got[index].numpy(), jax_fkd[index], atol=ATOL,
                               err_msg=name)


def test_cpu_wrapper_takes_plain_version_without_launch(inputs, jax_fkd):
    q, qd = inputs
    before = cuda_fk.fk_derivatives_batched.launches
    got = cuda_fk.fk_derivatives_batched(robots.franka_panda(),
                                         torch.tensor(q), torch.tensor(qd))
    assert cuda_fk.fk_derivatives_batched.launches == before == 0
    for g, w in zip(got, jax_fkd):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    model = robots.franka_panda()
    q = torch.zeros(4, 9)
    with pytest.raises(TypeError):
        cuda_fk.fk_derivatives_batched(model, q.double(), q.double())
    with pytest.raises(ValueError):
        cuda_fk.fk_derivatives_batched(model, q[:, :8], q[:, :8])
    with pytest.raises(ValueError):
        cuda_fk.fk_derivatives_batched(model, q.to("meta"), q.to("meta"))


def test_ancestor_table_matches_jacobian_columns():
    """anc[f, m] names the generator of each nonzero Jacobian column, as
    FkDerivatives.full_row picks it in the JAX package."""
    model = robots.franka_panda()
    anc = cuda_fk.ancestor_table(model)
    for f in range(model.n_frames):
        want = {model.q_index[j]: j for j in model.chain(f)
                if model.joint_type[j] != FIXED}
        got = {m: int(j) for m, j in enumerate(anc[f]) if j >= 0}
        assert got == want
