"""K1's CTA kernel (rmp_tpu_torch/csrc/pullback_resolve_cta.cuh, n = 33..64)
replayed in torch on the CPU: the kernel's order of sums (every block in
tag order, chunks of 16 rows, 8 for a dense block, into rows padded to the
instantiation's kMaxN with f at column kMaxN), its elimination (rows in
place behind the `who` permutation, the strict record chain with NaN ending
it, whole rows updated as a product and then a difference) and its back
substitution by columns. The replay is held to the plain version
(ops/cuda_resolve.pullback_resolve_structured_plain) and to a float64 solve
with the limits phase 23 of chip_smoke.py holds the kernel to (`k1_held`):
on the envs whose float32 plain q̈ lies within PAST32_SCREEN x K1_TOL x
max(1, the env's largest |q̈|) of float64, every entry within K1_TOL x
max(1, |q̈|) of the plain version, K1_TOL = 2e-4; every env's float64
backward error within K1_RESIDUAL = 1e-5. The pivot cases of
ops/resolve_cases.py, on which the plain version and the kernel take the
same pivots, are held as phase 22 holds the warp kernel's
(`k1_compare_nan`). tests/test_torch_past_32_k1.py holds the plain version
against JAX's K1 body."""
import numpy as np
import pytest
import torch

from rmp_tpu_torch.ops import cuda_resolve
from rmp_tpu_torch.ops.resolve_cases import PIVOT_CASES, SINGULAR, pivot_case
from test_torch_resolve import layout_blocks

torch.set_num_threads(1)

K1_TOL, K1_RESIDUAL, PAST32_SCREEN = 2e-4, 1e-5, 0.1
B = 16
CHUNK, DENSE_CHUNK = 16, 8
# chip_smoke.K1_EVERY_N_LAYOUT
LAYOUT = (("dense", 3), ("identity", 0), ("identity", 0), ("scalar", 20))


def instantiation(n: int) -> int:
    """The kMaxN of the kernel that takes n (pullback_resolve_cta.cu)."""
    assert 33 <= n <= 64
    return 40 if n <= 40 else 64


def chunks(tags, blocks, n):
    """(tag, block, r0, rows) of every staged chunk, in the kernel's order."""
    for tag, blk in zip(tags, blocks):
        rows = n if tag == "identity" else blk[0].shape[1]
        size = DENSE_CHUNK if tag == "dense" else CHUNK
        for r0 in range(0, rows, size):
            yield tag, blk, r0, min(size, rows - r0)


def replay_sums(tags, blocks, ridge: float = 0.0) -> torch.Tensor:
    """[A + ridge I | f] (B, kMaxN, kMaxN + 1) in float32, summed as the
    kernel sums: each staged row into every row in turn (a row factor times
    the staged row), the identity blocks' rows added to the rows they are;
    columns n..kMaxN-1 and rows n..kMaxN-1 zero."""
    blocks = [tuple(x.float() for x in blk) for blk in blocks]
    n = blocks[0][0].shape[-1]
    kmax = instantiation(n)
    Bn = blocks[0][0].shape[0]
    R = torch.zeros(Bn, kmax, kmax + 1)
    for tag, blk, r0, nr in chunks(tags, blocks, n):
        for i in range(r0, r0 + nr):
            if tag == "identity":
                M, v = blk
                R[:, i, :n] = R[:, i, :n] + M[:, i, :]
                R[:, i, kmax] = R[:, i, kmax] + v[:, i]
                continue
            J, X, v = blk
            a = J[:, i, :]                               # (B, n) row factors
            if tag == "scalar":
                u, cols = X[:, i, None] * a, J[:, i, :]  # m J[i][r], J[i]
            else:
                u, cols = a, X[:, i, :]                  # J[i][r], W[i]
            R[:, :n, :n] = R[:, :n, :n] + u[:, :, None] * cols[:, None, :]
            R[:, :n, kmax] = R[:, :n, kmax] + a * v[:, i, None]
    if ridge:
        R[:, torch.arange(n), torch.arange(n)] += ridge
    return R


def clamp_ref(d: torch.Tensor) -> torch.Tensor:
    eps = 1e-12
    return torch.where(d >= 0, torch.clamp(d, min=eps),
                       torch.clamp(d, max=-eps))


def replay_solve(R: torch.Tensor, n: int, strict: bool = True) -> torch.Tensor:
    """q̈ (B, n) from the kernel's elimination and back substitution on the
    rows R (B, kMaxN, kMaxN + 1), env by env as a warp runs them; with
    strict=False a row takes the pivot on a tie too (not the reference's
    rule)."""
    kmax = R.shape[1]
    out = torch.empty(R.shape[0], n)
    for e in range(R.shape[0]):
        rows = R[e].clone()
        who = list(range(kmax))        # the physical row at each position
        done = [r >= n for r in range(kmax)]
        pos, diag = [0] * kmax, [1.0] * kmax
        for kk in range(n):
            val = [float(rows[who[p], kk]) for p in range(n)]
            mag = [abs(x) for x in val]
            cur, last, takes = mag[kk], kk, []
            if cur == cur:
                for i in range(kk + 1, n):
                    if mag[i] != mag[i]:
                        break            # a NaN ends the chain
                    if mag[i] > cur or (not strict and mag[i] == cur):
                        takes.append(i)
                        last, cur = i, mag[i]
            piv, pv = who[last], val[last]
            # kk takes the last taker's row, each taker its predecessor's
            chain = [kk] + takes
            moved = {chain[0]: who[chain[-1]]}
            for t in range(1, len(chain)):
                moved[chain[t]] = who[chain[t - 1]]
            for p, r in moved.items():
                who[p] = r
            done[piv], pos[piv], diag[piv] = True, kk, pv
            inv = 1.0 / clamp_ref(torch.tensor(pv, dtype=torch.float32))
            for r in range(kmax):
                if done[r]:
                    continue
                factor = rows[r, kk] * inv
                rows[r] = rows[r] - factor * rows[piv]
        x = torch.zeros(n)
        for c in range(n - 1, -1, -1):
            p = who[c]
            x[c] = rows[p, kmax] / clamp_ref(
                torch.tensor(diag[p], dtype=torch.float32))
            for r in range(n):
                if pos[r] < c:
                    rows[r, kmax] = rows[r, kmax] - rows[r, c] * x[c]
        out[e] = x
    return out


def replay(tags, blocks, ridge: float = 0.0) -> torch.Tensor:
    n = blocks[0][0].shape[-1]
    return replay_solve(replay_sums(tags, blocks, ridge), n)


def held(tags, blocks, got):
    """chip_smoke.k1_held's limits on the replay `got`."""
    want = cuda_resolve.pullback_resolve_structured_plain(tags, blocks)
    wide = [tuple(x.double() for x in blk) for blk in blocks]
    exact = cuda_resolve.pullback_resolve_structured_plain(tags, wide)
    A, f = cuda_resolve.assemble_structured(tags, wide)
    scale = exact.abs().amax(dim=1).clamp_min(1.0)
    keep = (want.double() - exact).abs().amax(dim=1) / scale \
        <= PAST32_SCREEN * K1_TOL
    share = ((got - want).abs()
             / (K1_TOL * want.abs().clamp_min(1.0))).amax(dim=1)
    x = got.double()
    r = (torch.einsum("bnm,bm->bn", A, x) - f).abs().amax(dim=1)
    backward = r / (A.abs().sum(dim=2).amax(dim=1) * x.abs().amax(dim=1)
                    + f.abs().amax(dim=1))
    assert torch.isfinite(got).all()
    assert 2 * int(keep.sum()) >= keep.numel()
    assert float(share[keep].max()) <= 1.0
    assert float(backward.max()) <= K1_RESIDUAL
    return float(share[keep].max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [33, 48, 64])
def test_replay_matches_plain_and_float64(n, dtype):
    tags, blocks = layout_blocks(400 + n, B, n, LAYOUT)
    blocks = [tuple(torch.tensor(x).to(dtype) for x in blk)
              for blk in blocks]
    share = held(tags, blocks, replay(tags, blocks))
    print(f"n={n} {dtype}: largest share of the limit {share:.3e}")


def test_replay_of_the_transposed_solve():
    """The backward's solve at n = 36: A as one identity block read through
    its transposed strides, with a ridge."""
    tags, blocks = layout_blocks(536, B, 36, LAYOUT)
    A, _ = cuda_resolve.assemble_structured(
        tags, [tuple(torch.tensor(x) for x in blk) for blk in blocks])
    g = torch.tensor(np.random.default_rng(3).normal(size=(B, 36)),
                     dtype=torch.float32)
    blk = [(A.transpose(-1, -2), g)]
    got = replay(("identity",), blk, ridge=1e-6)
    want = cuda_resolve.pullback_resolve_structured_plain(("identity",), blk,
                                                          ridge=1e-6)
    scale = K1_TOL * want.abs().clamp_min(1.0)
    assert float(((got - want).abs() / scale).max()) <= 1.0


def test_padding_is_zero_and_the_sums_are_the_plain_sums():
    """Rows and columns past n (to kMaxN) stay zero, f sits at column kMaxN,
    and [A | f] is the plain assembly within float32 rounding."""
    n = 42
    tags, blocks = layout_blocks(7, B, n, LAYOUT)
    blocks = [tuple(torch.tensor(x) for x in blk) for blk in blocks]
    R = replay_sums(tags, blocks)
    kmax = instantiation(n)
    assert R.shape == (B, 64, 65) and kmax == 64
    assert not R[:, n:, :].any() and not R[:, :, n:kmax].any()
    A, f = cuda_resolve.assemble_structured(tags, blocks)
    torch.testing.assert_close(R[:, :n, :n], A, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(R[:, :n, kmax], f, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("case", PIVOT_CASES)
def test_replay_takes_the_plain_versions_pivots(case):
    """The pivot cases at n = 40 (ties of both signs, a singular A, tiny and
    clamped pivots, NaN magnitudes): NaN envs as the plain version's, every
    other entry within K1_TOL x max(1, its |q̈|), or its env's largest on
    the singular case."""
    tags, blocks = pivot_case(case, 40, B, 40)
    blocks = [tuple(torch.tensor(x) for x in blk) for blk in blocks]
    got = replay(tags, blocks)
    want = cuda_resolve.pullback_resolve_structured_plain(tags, blocks)
    nan_got, nan_want = torch.isnan(got).any(1), torch.isnan(want).any(1)
    assert torch.equal(nan_got, nan_want)
    g, w = got[~nan_want], want[~nan_want]
    mag = w.abs().amax(1, keepdim=True) if case in SINGULAR else w.abs()
    assert torch.isfinite(g).all()
    assert float(((g - w).abs() / (K1_TOL * mag.clamp(min=1.0))).max()) <= 1.0


def test_a_wrong_chain_fails_the_ties():
    """The ties case tells the strict record chain from one that takes on a
    tie: the replay with `>=` parts from the plain version."""
    tags, blocks = pivot_case("ties", 40, B, 40)
    blocks = [tuple(torch.tensor(x) for x in blk) for blk in blocks]
    want = cuda_resolve.pullback_resolve_structured_plain(tags, blocks)
    wrong = replay_solve(replay_sums(tags, blocks), 40, strict=False)
    share = ((wrong - want).abs()
             / (K1_TOL * want.abs().amax(1, keepdim=True).clamp(min=1.0)))
    assert float(share.nan_to_num(nan=2.0).max()) > 1.0
