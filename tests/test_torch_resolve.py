"""The plain version of the port's pullback + LU resolve kernel (K1), through
its public wrapper on the CPU, against the JAX package's Pallas kernel (in
interpret mode) and its unrolled LU, on the same numpy inputs."""
import dataclasses
import os
import re

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


def layout_blocks(seed: int, B: int, n: int, layout):
    """numpy blocks of `layout`, a sequence of (tag, rows): dense blocks
    with W = S J (S SPD), identity blocks with SPD metrics, scalar blocks
    with non-negative metrics."""
    rng = np.random.default_rng(seed)

    def spd(d):
        L = rng.normal(size=(B, d, d)) * 0.3
        return L @ L.transpose(0, 2, 1) + 0.5 * np.eye(d)

    blocks = []
    for tag, R in layout:
        if tag == "identity":
            blk = (spd(n), rng.normal(size=(B, n)))
        elif tag == "dense":
            J = rng.normal(size=(B, R, n))
            blk = (J, spd(R) @ J, rng.normal(size=(B, R)))
        else:
            blk = (rng.normal(size=(B, R, n)) * 0.3,
                   rng.uniform(0.0, 2.0, (B, R)), rng.normal(size=(B, R)))
        blocks.append(tuple(np.asarray(x, np.float32) for x in blk))
    return tuple(tag for tag, _ in layout), blocks


# the layouts of the scenes that resolve with 'solve' at n = 6 (the UR5's
# two scenes) and of the two-joint robot's (two_joint/05 and /02)
K1_LAYOUTS = {
    "ur5/01": (6, (("dense", 3), ("identity", 0), ("identity", 0))),
    "ur5/02": (6, (("dense", 3), ("identity", 0), ("dense", 18))),
    "two_joint/05": (2, (("dense", 3), ("dense", 9))),
    "two_joint/02": (2, (("dense", 3), ("identity", 0))),
}


@pytest.mark.parametrize("layout", ["flagship"] + list(K1_LAYOUTS))
def test_plain_k1_matches_jax_pallas_kernel_interpret(layout):
    """K1's plain version at n = 9 (the flagship layout), 6 and 2 against
    JAX's Pallas kernel in interpret mode, on the same blocks."""
    from jax.experimental.pallas import tpu as pltpu

    from rmp_tpu.ops.pallas_resolve import pullback_resolve_structured
    if layout == "flagship":
        tags, blocks = FLAGSHIP_TAGS, flagship_blocks(0, 128)
    else:
        tags, blocks = layout_blocks(0, 128, *K1_LAYOUTS[layout])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pullback_resolve_structured(
            tags, [tuple(jnp.asarray(x) for x in b) for b in blocks],
            ridge=0.0))
    before = cuda_resolve.pullback_resolve_structured.launches
    got = cuda_resolve.pullback_resolve_structured(
        tags, _torch_blocks(blocks)).numpy()
    assert cuda_resolve.pullback_resolve_structured.launches == before
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("n", [65, 80])
def test_k1_raises_for_an_n_without_a_kernel(n):
    """The kernel takes every n from 1 to 64 (the CTA kernel past 32); off
    the CPU a larger n raises before a launch, with no fallback, and the
    message names the limit (meta tensors stand in for a device here)."""
    tags, blocks = layout_blocks(1, 4, n, (("dense", 3), ("identity", 0)))
    meta = [tuple(torch.tensor(x).to("meta") for x in b) for b in blocks]
    with pytest.raises(ValueError, match=f"no K1 kernel instantiated for "
                       f"n={n}: the kernel takes n from 1 to 64"):
        cuda_resolve.pullback_resolve_structured(tags, meta)
    assert cuda_resolve.KERNEL_N == range(1, 65)


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


def _kernel_constant(name: str) -> int:
    """A constexpr int of csrc/pullback_resolve.cu, read from the source."""
    src = os.path.join(os.path.dirname(cuda_resolve.__file__), os.pardir,
                       "csrc", "pullback_resolve.cu")
    with open(src) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


def _described(ptr, strides, shape, pool):
    """The tensor a descriptor names: the storage of the `pool` tensor that
    holds address `ptr`, read from that offset with the descriptor's
    strides (in elements)."""
    for x in pool:
        store = x.untyped_storage()
        if store.data_ptr() <= ptr < store.data_ptr() + store.nbytes():
            flat = torch.empty(0, dtype=x.dtype).set_(store)
            return torch.as_strided(flat, shape, tuple(strides[:len(shape)]),
                                    (ptr - store.data_ptr()) // x.itemsize)
    raise AssertionError(f"descriptor address {ptr:#x} lies in no block")


def replay_kernel(table, pool, B: int, n: int, ridge: float = 0.0):
    """The CUDA kernel's order, in torch, from its descriptor table alone:
    row r of each block on lane r % kGroup (blocks in tag order; a scalar
    row adds its upper triangle and mirrors it), the butterfly (xor
    kGroup / 2, ..., 1) over the lanes, the identity seed summed in tag
    order and added to the reduced rows, the ridge, the pivoted LU."""
    group = _kernel_constant("kGroup")
    kinds = {v: k for k, v in cuda_resolve.KINDS.items()}
    part_A = torch.zeros(group, B, n, n)
    part_f = torch.zeros(group, B, n)
    seed_A = seed = None
    for row in np.frombuffer(table, np.int64).reshape(-1, cuda_resolve.ROW_WORDS).tolist():
        kind, R, ptrs, st = kinds[row[0]], row[1], row[2:5], row[5:]
        if kind == "identity":
            M = _described(ptrs[0], st[0:3], (B, n, n), pool)
            v = _described(ptrs[1], st[3:6], (B, n), pool)
            seed_A = (torch.zeros(B, n, n) if seed_A is None else seed_A) + M
            seed = (torch.zeros(B, n) if seed is None else seed) + v
            continue
        J = _described(ptrs[0], st[0:3], (B, R, n), pool)
        X = _described(ptrs[1], st[3:6],
                       (B, R) if kind == "scalar" else (B, R, n), pool)
        V = _described(ptrs[2], st[6:9], (B, R), pool)
        for r in range(R):
            lane, Jr = r % group, J[:, r]
            part_f[lane] += Jr * V[:, r, None]
            if kind == "scalar":
                a = torch.triu((Jr * X[:, r, None])[:, :, None] * Jr[:, None])
                part_A[lane] += a + torch.triu(a, 1).transpose(1, 2)
            else:
                part_A[lane] += Jr[:, :, None] * X[:, r, None, :]
    off = group // 2
    while off:
        swap = [lane ^ off for lane in range(group)]
        part_A, part_f = part_A + part_A[swap], part_f + part_f[swap]
        off //= 2
    A, f = part_A[0], part_f[0]
    if seed_A is not None:
        A, f = seed_A + A, seed + f
    return lu_solve_unrolled(A + ridge * torch.eye(n), f)


def _strided(x: np.ndarray) -> torch.Tensor:
    """x as a view of batch-minor storage (axes reversed), not contiguous."""
    axes = tuple(reversed(range(x.ndim)))
    return torch.tensor(np.ascontiguousarray(x.transpose(axes))).permute(axes)


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("tags", [
    ("dense", "identity", "scalar", "dense", "identity", "scalar"),
    ("scalar",),
    ("identity", "dense"),
])
def test_kernel_operands_reassemble_the_system(tags, layout):
    """The descriptor table the wrapper hands the CUDA kernel names every
    block where it lies (address and strides, no copy), and the kernel's
    order replayed through it (lane split of rows, butterfly, identity seed
    in tag order, LU) gives the plain version's q̈."""
    base = flagship_blocks(2, 8)
    pick = {"dense": base[0], "identity": base[1], "scalar": base[4]}
    make = torch.tensor if layout == "contiguous" else _strided
    blocks = [tuple(make(x) for x in pick[t]) for t in tags]
    table = cuda_resolve.block_table(tags, blocks)
    rows = np.frombuffer(table, np.int64).reshape(len(tags),
                                                  cuda_resolve.ROW_WORDS)
    for row, blk in zip(rows, blocks):
        assert list(row[2:2 + len(blk)]) == [x.data_ptr() for x in blk]
    pool = [x for blk in blocks for x in blk]
    want = cuda_resolve.pullback_resolve_structured_plain(tags, blocks,
                                                          ridge=1e-3)
    got = replay_kernel(table, pool, 8, 9, ridge=1e-3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_kernel_reads_the_real_tick_blocks_where_they_lie():
    """One flagship tick's blocks on the CPU (B = 16): the scalar block's J
    is motor-major and the dense J a strided view, and the descriptor
    table points into the very tensors it was handed, with their own
    strides; the kernel's order replayed through it gives the plain q̈."""
    from rmp_tpu_torch import envs
    from rmp_tpu_torch.core import policy_row_blocks_structured
    from rmp_tpu_torch.envs.base import _policy_inputs

    env = envs.make("franka/06_cluttered_environment", device="cpu")
    B, rng = 16, np.random.default_rng(1)
    states = envs.make_batched_reset(env, B)()
    move = [torch.tensor(rng.uniform(-0.05, 0.05, (B, 9)), dtype=torch.float32)
            for _ in range(2)]
    states = dataclasses.replace(states, sim=dataclasses.replace(
        states.sim, q=states.sim.q + move[0], qd=move[1]))
    q, qd, params, ctxs, fk = _policy_inputs(env, states, env.gather_params())
    tags, blocks = policy_row_blocks_structured(env.policies, q, qd, params,
                                                ctxs, fk=fk)
    assert tags == FLAGSHIP_TAGS
    J_scalar, J_dense = blocks[4][0], blocks[0][0]
    assert J_scalar.stride() == (70, 1, 70 * B)
    assert not J_dense.is_contiguous()
    table = cuda_resolve.block_table(tags, blocks)
    for row, blk in zip(np.frombuffer(table, np.int64).reshape(5, -1), blocks):
        for t, x in enumerate(blk):
            assert row[2 + t] == x.data_ptr()
            assert tuple(row[5 + 3 * t:5 + 3 * t + x.dim()]) == x.stride()
    pool = [x for blk in blocks for x in blk]
    want = cuda_resolve.pullback_resolve_structured_plain(tags, blocks)
    got = replay_kernel(table, pool, B, 9)
    scale = max(1.0, float(want.abs().max()))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL * scale)


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
