"""The port's FK and the plain version of its FK-derivative kernel (K3)
against the JAX package, on the same numpy inputs, and the index map of
its CUDA kernel's stores replayed against that plain version."""
import os
import re

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


CSRC = os.path.join(os.path.dirname(cuda_fk.__file__), os.pardir, "csrc")


def k3_source_tiles() -> tuple:
    """kTiles of csrc/fk_derivatives.cu, the launcher's table: (frames,
    motors, envs per CTA) of each tile, first fit first. The first is the
    narrow kernel's (that file), the second the wide kernel's
    (fk_derivatives_wide.cuh)."""
    with open(os.path.join(CSRC, "fk_derivatives.cu")) as f:
        table = re.search(r"constexpr Tile kTiles\[\] = \{(.*)\};",
                          f.read()).group(1)
    return tuple(tuple(int(v) for v in t.split(","))
                 for t in re.findall(r"\{([^{}]*)\}", table))


def _k3_tile(model) -> int:
    """Index into k3_source_tiles of the tile that serves `model`."""
    for k, (frames, motors, _) in enumerate(k3_source_tiles()):
        if model.n_frames <= frames and model.n_q <= motors:
            return k
    raise ValueError(f"no K3 instantiation takes {model.name}")


def _k3_shared_arrays(model, q, qd):
    """What K3's shared memory holds once the recursion has passed every
    frame, from the plain recursion: T, W, Wd + W W and G per (env,
    frame), zero where a frame has no generator."""
    rec = fkd.FkDerivatives(model, q, qd)
    B = q.shape[0]

    def frames(mats):
        return np.stack([np.zeros((B, 4, 4), np.float32) if m is None
                         else m.numpy() for m in mats], axis=1)
    T, W, Wd, G = (frames(x) for x in (rec.T, rec.W, rec.Wd, rec.G))
    return T, W, Wd + W @ W, G


def replay_k3_stores(model, q: torch.Tensor, qd: torch.Tensor):
    """K3's stores, replayed in numpy: the index map from what shared
    memory holds to the four outputs, tile by tile, as the kernel that
    serves `model` makes it (`_k3_tile`); the values come from the plain
    recursion. Elements no store reaches stay NaN; an element stored twice
    raises."""
    if _k3_tile(model) == 0:
        return _replay_narrow(model, q, qd)
    return _replay_wide(model, q, qd)


def _replay_narrow(model, q, qd):
    """The narrow kernel's store pass after the recursion: float4 v of
    each output's contiguous range of the tile is mapped as the kernel
    maps it: T, Td, c -> (row ef = e F + f, matrix row i); J -> (row ef,
    frame f = ef % F, entry rr, motor m) and the operands row rr / 4 of
    G[anc[f][m]] and row rr % 4 of T_f's transpose."""
    E = k3_source_tiles()[0][2]
    B, F, n = q.shape[0], model.n_frames, model.n_q
    T, W, C, G = _k3_shared_arrays(model, q, qd)
    anc = cuda_fk.ancestor_table(model)
    outs = [np.full(B * F * 16, np.nan, np.float32) for _ in range(3)]
    J = np.full(B * F * 16 * n, np.nan, np.float32)
    for b0 in range(0, B, E):
        nv = min(E, B - b0)
        rows, row0 = nv * F, b0 * F

        def tile(x):
            return x[b0:b0 + nv].reshape(rows, 16)
        sT, sW, sC, sG = (tile(x) for x in (T, W, C, G))
        sTt = tile(T.transpose(0, 1, 3, 2))
        for v in range(rows * 4):
            ef, i = v >> 2, v & 3
            cols = [sTt[ef, 4 * j:4 * j + 4] for j in range(4)]
            at = slice(row0 * 16 + 4 * v, row0 * 16 + 4 * v + 4)
            outs[0][at] = sT[ef, 4 * i:4 * i + 4]
            for out, left in ((outs[1], sW), (outs[2], sC)):
                out[at] = [left[ef, 4 * i:4 * i + 4] @ c for c in cols]
        per_row = 4 * n
        for v in range(rows * per_row):
            ef = v // per_row
            f = ef % F
            rr, m = divmod(4 * (v - ef * per_row), n)
            for k in range(4):
                a = anc[f, m]
                J[row0 * 16 * n + 4 * v + k] = 0.0 if a < 0 else (
                    sG[ef - f + a, 4 * (rr >> 2):4 * (rr >> 2) + 4]
                    @ sTt[ef, 4 * (rr & 3):4 * (rr & 3) + 4])
                m += 1
                if m == n:
                    m, rr = 0, rr + 1
    return (outs[0].reshape(B, F, 16), outs[1].reshape(B, F, 16),
            J.reshape(B, F, 16, n), outs[2].reshape(B, F, 16))


def _replay_wide(model, q, qd):
    """The wide kernel's stores (fk_derivatives_wide.cuh): CTA `cta` holds
    envs cta E .. cta E + E - 1, a half warp each (an env past B stores
    nothing); right after the step of frame f, lane r = 4 i + j of env b
    stores entry r of T_f, Td_f = W_f T_f and c_f = (Wd_f + W_f W_f) T_f
    at (b F + f) 16 + r, the constants of row 3 (T: 0 0 0 1, Td and c:
    0) where i = 3. J's row of (b, f), 16 n floats at (b F + f) 16 n, goes
    out in passes gi = 0-2: for its motors m = r + 16 k below n (k below
    the tile's motors / 16: r and r + 16 on the (40, 32) tile) the lane
    stages J[4 gi + jj][m] = row gi of G[anc[f][m]] (the zero matrix
    when there is no ancestor) . column jj of T_f at jj n + m of the env's
    4 n-float stage, and then the half warp copies the stage out, float4
    w = r, r + 16, ... below n to float4 gi n + w of the row; a last pass
    stores zeros at float4s 3 n + w (rows 12-15). Every element is
    counted, and a stage must be whole before it goes out."""
    _, motors, E = k3_source_tiles()[_k3_tile(model)]
    B, F, n = q.shape[0], model.n_frames, model.n_q
    T, W, C, G = _k3_shared_arrays(model, q, qd)
    anc = cuda_fk.ancestor_table(model)
    zero = np.zeros((4, 4), np.float32)
    outs = [np.full(B * F * 16, np.nan, np.float32) for _ in range(4)]
    outs[2] = np.full(B * F * 16 * n, np.nan, np.float32)
    stored = [np.zeros(x.size, np.int64) for x in outs]
    entry = np.arange(16)                      # 4 gi + jj

    def store(k, at, values):
        outs[k][at] = values
        np.add.at(stored[k], at, 1)
    for cta in range(-(-B // E)):
        for f in range(F):
            for b in range(cta * E, min(cta * E + E, B)):
                row = (b * F + f) * 16
                for r in range(16):
                    i, j = r >> 2, r & 3
                    if i == 3:
                        store(0, row + r, float(j == 3))
                        store(1, row + r, 0.0)
                        store(3, row + r, 0.0)
                    else:
                        store(0, row + r, T[b, f, i, j])
                        store(1, row + r, W[b, f, i] @ T[b, f, :, j])
                        store(3, row + r, C[b, f, i] @ T[b, f, :, j])
                for gi in range(3):
                    stage = np.full(4 * n, np.nan, np.float32)
                    for r in range(16):
                        for m in range(r, motors, 16):
                            if m < n:
                                a = anc[f, m]
                                Ga = G[b, a] if a >= 0 else zero
                                stage[entry[:4] * n + m] = Ga[gi] @ T[b, f]
                    assert not np.isnan(stage).any(), "stage not whole"
                    for r in range(16):
                        for w in range(r, n, 16):
                            store(2, row * n + 4 * (gi * n + w)
                                  + np.arange(4), stage[4 * w:4 * w + 4])
                for r in range(16):
                    for w in range(r, n, 16):
                        store(2, row * n + 4 * (3 * n + w) + np.arange(4),
                              np.zeros(4, np.float32))
    for count in stored:
        assert count.max() <= 1, "an element stored twice"
    return (outs[0].reshape(B, F, 16), outs[1].reshape(B, F, 16),
            outs[2].reshape(B, F, 16, n), outs[3].reshape(B, F, 16))


@pytest.mark.parametrize("batch", [5, 13])
def test_kernel_store_map_reassembles_the_outputs(inputs, batch):
    """K3's index map from the tile's shared arrays to its coalesced stores
    writes every element of the four outputs once and reassembles the plain
    version's outputs: B = 5 is one ragged tile, B = 13 a full tile and a
    ragged one."""
    q, qd = (torch.tensor(x[:batch]) for x in inputs)
    model = robots.franka_panda()
    got = replay_k3_stores(model, q, qd)
    want = fkd.fk_derivatives(model, q, qd)
    for name, g, w in zip(("T16", "Td16", "J16", "c16"), got, want):
        assert g.shape == tuple(w.shape), name
        assert not np.isnan(g).any(), name
        np.testing.assert_allclose(g, w.numpy(), atol=ATOL, err_msg=name)
