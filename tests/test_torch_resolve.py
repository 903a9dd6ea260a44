"""The plain version of the port's pullback + LU resolve kernel (K1), through
its public wrapper on the CPU, against the JAX package's Pallas kernel (in
interpret mode) and its unrolled LU, on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu.ops import linalg as jlinalg
from rmp_tpu_torch.ops import cuda_resolve
from rmp_tpu_torch.ops.linalg import lu_solve_unrolled

torch.set_num_threads(1)

ATOL = 2e-4
FLAGSHIP_TAGS = ("dense", "identity", "identity", "identity", "scalar")


def flagship_blocks(seed: int, B: int):
    """numpy blocks in the flagship layout: a dense EE block (3 rows), three
    identity blocks with SPD metrics, a scalar obstacle block (70 rows)."""
    rng = np.random.default_rng(seed)
    n, Rd, Rs = 9, 3, 70

    def spd(d):
        L = rng.normal(size=(B, d, d)) * 0.3
        return L @ L.transpose(0, 2, 1) + 0.5 * np.eye(d)

    Jd = rng.normal(size=(B, Rd, n))
    blocks = [(Jd, spd(Rd) @ Jd, rng.normal(size=(B, Rd)))]
    for _ in range(3):
        blocks.append((spd(n), rng.normal(size=(B, n))))
    blocks.append((rng.normal(size=(B, Rs, n)) * 0.3,
                   rng.uniform(0.0, 2.0, (B, Rs)), rng.normal(size=(B, Rs))))
    return [tuple(np.asarray(x, np.float32) for x in blk) for blk in blocks]


def _torch_blocks(blocks):
    return [tuple(torch.tensor(x) for x in blk) for blk in blocks]


def _assembled(tags, blocks):
    """(A, f) in float32 numpy, summed over the blocks."""
    A = f = 0.0
    for tag, blk in zip(tags, blocks):
        if tag == "identity":
            dA, df = blk
        elif tag == "scalar":
            J, m, v = blk
            dA = np.einsum("brn,br,brm->bnm", J, m, J)
            df = np.einsum("brn,br->bn", J, v)
        else:
            J, W, v = blk
            dA = np.einsum("brn,brm->bnm", J, W)
            df = np.einsum("brn,br->bn", J, v)
        A, f = A + dA, f + df
    return A.astype(np.float32), f.astype(np.float32)


def test_plain_k1_matches_jax_pallas_kernel_interpret():
    from jax.experimental.pallas import tpu as pltpu

    from rmp_tpu.ops.pallas_resolve import pullback_resolve_structured
    blocks = flagship_blocks(0, 128)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pullback_resolve_structured(
            FLAGSHIP_TAGS, [tuple(jnp.asarray(x) for x in b) for b in blocks],
            ridge=0.0))
    before = cuda_resolve.pullback_resolve_structured.launches
    got = cuda_resolve.pullback_resolve_structured(
        FLAGSHIP_TAGS, _torch_blocks(blocks)).numpy()
    assert cuda_resolve.pullback_resolve_structured.launches == before
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("ridge", [0.0, 1e-3])
def test_plain_k1_matches_jax_lu_on_assembled_system(ridge):
    blocks = flagship_blocks(1, 64)
    A, f = _assembled(FLAGSHIP_TAGS, blocks)
    want = np.asarray(jlinalg.lu_solve_unrolled(
        jnp.asarray(A + np.float32(ridge) * np.eye(9, dtype=np.float32)),
        jnp.asarray(f)))
    got = cuda_resolve.pullback_resolve_structured(
        FLAGSHIP_TAGS, _torch_blocks(blocks), ridge=ridge).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_singular_gram_stays_finite():
    """A rank-1 Gram matrix (no identity seed, one scalar block whose rows
    are one vector) gives finite output, after tests/test_pallas_resolve.py::
    test_singular_metric_stays_finite."""
    rng = np.random.default_rng(11)
    B, R, n = 16, 9, 9
    J = rng.normal(size=(B, R, n))
    J[0] = np.outer(np.ones(R), rng.normal(size=n)) / np.sqrt(R)
    blk = tuple(torch.tensor(np.asarray(x, np.float32))
                for x in (J, np.ones((B, R)), rng.normal(size=(B, R))))
    out = cuda_resolve.pullback_resolve_structured(("scalar",), [blk])
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("tags", [
    ("dense", "identity", "scalar", "dense", "identity", "scalar"),
    ("scalar",),
    ("identity", "dense"),
])
def test_kernel_operands_reassemble_the_system(tags):
    """The batch-minor operands the wrapper hands the CUDA kernel (pre-summed
    identity seed, row-stacked dense and scalar blocks) give the plain
    version's q̈ when the kernel's arithmetic is replayed on them."""
    base = flagship_blocks(2, 8)
    pick = {"dense": base[0], "identity": base[1], "scalar": base[4]}
    blocks = _torch_blocks([pick[t] for t in tags])
    k = cuda_resolve.kernel_inputs(tags, blocks)
    B, n = 8, 9
    A = torch.zeros(B, n, n) if k["A0"] is None else k["A0"].permute(2, 0, 1)
    f = torch.zeros(B, n) if k["f0"] is None else k["f0"].permute(1, 0)
    if k["Rd"]:
        assert k["Jd"].shape == (k["Rd"], n, B) and k["Jd"].is_contiguous()
        A = A + torch.einsum("rib,rjb->bij", k["Jd"], k["Wd"])
        f = f + torch.einsum("rib,rb->bi", k["Jd"], k["vd"])
    if k["Rs"]:
        assert k["Js"].shape == (k["Rs"], n, B) and k["Js"].is_contiguous()
        A = A + torch.einsum("rib,rb,rjb->bij", k["Js"], k["ms"], k["Js"])
        f = f + torch.einsum("rib,rb->bi", k["Js"], k["vs"])
    want = cuda_resolve.pullback_resolve_structured_plain(tags, blocks)
    np.testing.assert_allclose(lu_solve_unrolled(A, f).numpy(), want.numpy(),
                               atol=ATOL)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    blocks = _torch_blocks(flagship_blocks(3, 4))
    with pytest.raises(TypeError):
        cuda_resolve.pullback_resolve_structured(
            FLAGSHIP_TAGS, [tuple(x.double() for x in b) for b in blocks])
    with pytest.raises(ValueError):
        cuda_resolve.pullback_resolve_structured(
            ("dense", "identity", "identity", "identity", "unknown"), blocks)
    with pytest.raises(ValueError):
        cuda_resolve.pullback_resolve_structured(
            FLAGSHIP_TAGS, blocks[:4] + [(blocks[4][0][:, :5],) + blocks[4][1:]])
    with pytest.raises(ValueError):
        cuda_resolve.pullback_resolve_structured(
            FLAGSHIP_TAGS, [tuple(x.to("meta") for x in b) for b in blocks])


def dense_rows(seed: int, B: int, R: int = 30, n: int = 9):
    """J (B, R, n), W = diag(m) J, v (B, R): the layout of
    tests/test_pallas_resolve.py::test_pallas_pullback_resolve_interpret."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(B, R, n)).astype(np.float32)
    W = (J * rng.uniform(0.1, 2.0, (B, R, 1))).astype(np.float32)
    return J, W, rng.normal(size=(B, R)).astype(np.float32)


def test_plain_k2a_matches_jax_pallas_kernel_interpret():
    """pullback_resolve and pullback_resolve_t at their default ridge 1e-6
    (JAX's pullback_resolve runs pullback_resolve_t's kernel)."""
    from jax.experimental.pallas import tpu as pltpu

    from rmp_tpu.ops import pallas_resolve as jpr
    J, W, v = dense_rows(4, 128)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpr.pullback_resolve(
            jnp.asarray(J), jnp.asarray(W), jnp.asarray(v)))
    counts = (cuda_resolve.pullback_resolve.launches,
              cuda_resolve.pullback_resolve_t.launches)
    got = cuda_resolve.pullback_resolve(torch.tensor(J), torch.tensor(W),
                                        torch.tensor(v)).numpy()
    got_t = cuda_resolve.pullback_resolve_t(
        torch.tensor(J.transpose(2, 1, 0)), torch.tensor(W.transpose(2, 1, 0)),
        torch.tensor(v.T)).numpy()
    assert counts == (cuda_resolve.pullback_resolve.launches,
                      cuda_resolve.pullback_resolve_t.launches)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got_t, want, atol=ATOL)


def test_plain_k2b_matches_jax_pallas_kernel_interpret():
    """Three dense blocks at the default ridge 0."""
    from jax.experimental.pallas import tpu as pltpu

    from rmp_tpu.ops import pallas_resolve as jpr
    blocks = [dense_rows(5 + i, 128, R=R) for i, R in enumerate((3, 20, 9))]
    Js, Ws, vs = (list(x) for x in zip(*blocks))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpr.pullback_resolve_blocks(
            [jnp.asarray(x) for x in Js], [jnp.asarray(x) for x in Ws],
            [jnp.asarray(x) for x in vs]))
    before = cuda_resolve.pullback_resolve_blocks.launches
    got = cuda_resolve.pullback_resolve_blocks(
        [torch.tensor(x) for x in Js], [torch.tensor(x) for x in Ws],
        [torch.tensor(x) for x in vs]).numpy()
    assert cuda_resolve.pullback_resolve_blocks.launches == before
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("ridge", [0.0, 1e-6, 1e-3])
def test_plain_k2_matches_jax_lu_on_assembled_system(ridge):
    """K2a and K2b plain versions against the JAX package's unrolled LU of
    Σ Jᵀ W + ridge I, Σ Jᵀ v."""
    blocks = [dense_rows(7 + i, 64, R=R) for i, R in enumerate((3, 20))]
    A, f = _assembled(("dense", "dense"), blocks)
    want = np.asarray(jlinalg.lu_solve_unrolled(
        jnp.asarray(A + np.float32(ridge) * np.eye(9, dtype=np.float32)),
        jnp.asarray(f)))
    Js, Ws, vs = ([torch.tensor(b[i]) for b in blocks] for i in range(3))
    got = cuda_resolve.pullback_resolve_blocks(Js, Ws, vs, ridge=ridge)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    one = cuda_resolve.pullback_resolve(
        torch.cat(Js, 1), torch.cat(Ws, 1), torch.cat(vs, 1), ridge=ridge)
    np.testing.assert_allclose(one.numpy(), want, atol=ATOL)
    np.testing.assert_array_equal(
        cuda_resolve.pullback_resolve_t_plain(
            *(torch.cat(x, 1).permute(2, 1, 0) for x in (Js, Ws)),
            torch.cat(vs, 1).T, ridge=ridge).numpy(), one.numpy())


def test_k2_wrappers_reject_what_the_kernel_does_not_take():
    J, W, v = (torch.tensor(x) for x in dense_rows(6, 4))
    with pytest.raises(TypeError):
        cuda_resolve.pullback_resolve(J.double(), W.double(), v.double())
    with pytest.raises(ValueError):
        cuda_resolve.pullback_resolve(J, W[:, :5], v)
    with pytest.raises(ValueError):
        cuda_resolve.pullback_resolve_t(J, W, v)       # not batch-minor
    with pytest.raises(ValueError):
        cuda_resolve.pullback_resolve_blocks([J, J], [W], [v, v])
    with pytest.raises(ValueError):
        cuda_resolve.pullback_resolve(J.to("meta"), W.to("meta"),
                                      v.to("meta"))
