"""K1's pivot contract at n = 10..32 on the adversarial blocks of
rmp_tpu_torch/ops/resolve_cases.py (exact magnitude ties in a singular
integer system, negative pivots, a pivot under 1e-12 clamped with its sign,
a NaN in a column): the port's plain version against JAX's K1 body
`_kernel_structured` run eagerly (test_torch_resolve_n.jax_k1), at n = 10,
18 and 32, in float32 and on blocks rounded to bfloat16. Where a NaN reaches
q̈, both give NaN in the same envs; every entry of every other env within
2e-4 x max(1, its own |q̈|), and in the singular 'ties' case every env
within 2e-4 x max(1, its largest |q̈|); the plain solve with a wrong tie
rule fails the 'ties' case so held. chip_smoke.py holds the CUDA kernel
against the plain version on the same generator's inputs."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu_torch.ops import cuda_resolve, linalg
from rmp_tpu_torch.ops.resolve_cases import (PIVOT_CASES, SINGULAR, TINY,
                                             pivot_case)
from test_torch_resolve_n import TOL, jax_k1

torch.set_num_threads(1)

B = 32
PIVOT_N = (10, 18, 32)


def held(got: np.ndarray, want: np.ndarray, what: str,
         per_env: bool = False) -> None:
    """The NaN envs the same on both sides; every entry of every other env
    within TOL x max(1, its own |q̈|), or with per_env (a singular case,
    resolve_cases.SINGULAR) within TOL x max(1, its env's largest |q̈|)."""
    nan_got, nan_want = (np.isnan(x).any(axis=1) for x in (got, want))
    assert np.array_equal(nan_got, nan_want), what
    keep = ~nan_want
    g, w = got[keep], want[keep]
    mag = np.abs(w).max(axis=1, keepdims=True) if per_env else np.abs(w)
    limit = TOL * np.maximum(1.0, mag)
    worst = float((np.abs(g - w) / limit).max()) if w.size else 0.0
    print(f"{what}: max|Δq̈| / limit {worst:.3e}, "
          f"{int(nan_want.sum())} NaN envs")
    assert np.isfinite(g).all(), what
    assert (np.abs(g - w) <= limit).all(), what


def plain(tags, blocks, dtype=torch.float32) -> np.ndarray:
    return cuda_resolve.pullback_resolve_structured(
        tags, [tuple(torch.tensor(x).to(dtype) for x in blk)
               for blk in blocks]).numpy()


@pytest.mark.parametrize("n", PIVOT_N)
@pytest.mark.parametrize("case", PIVOT_CASES)
def test_plain_k1_follows_jax_on_pivot_cases(case, n):
    tags, blocks = pivot_case(case, 0, B, n)
    want = jax_k1(tags, blocks, eager=True)
    held(plain(tags, blocks), want, f"{case}, n={n}", case in SINGULAR)


@pytest.mark.parametrize("case", PIVOT_CASES)
def test_plain_k1_follows_jax_on_bf16_pivot_cases(case):
    """The blocks rounded to bfloat16 once: JAX's K1 with
    block_dtype=bfloat16 (its identity pre-sum in float32, then the cast)
    and the plain version on the same bfloat16 tensors."""
    tags, blocks = pivot_case(case, 1, B, 18)
    blocks = [tuple(np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                               .astype(jnp.float32)) for x in blk)
              for blk in blocks]
    want = jax_k1(tags, blocks, jnp.bfloat16, eager=True)
    got = cuda_resolve.pullback_resolve_structured(
        tags, [tuple(torch.tensor(x) for x in blk) for blk in blocks],
        block_dtype=torch.bfloat16).numpy()
    held(got, want, f"{case}, n=18, bfloat16", case in SINGULAR)


@pytest.mark.parametrize("n", PIVOT_N)
def test_ties_catch_a_wrong_tie_rule(n):
    """The plain solve with `>=` in place of the strict `>` (the last of
    the tied rows takes the pivot) fails the 'ties' comparison with JAX,
    which the plain solve as it is passes."""
    src = inspect.getsource(linalg.lu_solve_unrolled)
    assert src.count("(mag_i > piv_mag)") == 1
    scope = dict(vars(linalg))
    exec(src.replace("(mag_i > piv_mag)", "(mag_i >= piv_mag)"), scope)
    tags, blocks = pivot_case("ties", 0, B, n)
    A, f = cuda_resolve.assemble_structured(
        tags, [tuple(torch.tensor(x) for x in blk) for blk in blocks])
    want = jax_k1(tags, blocks, eager=True)
    assert "ties" in SINGULAR
    held(linalg.lu_solve_unrolled(A, f).numpy(), want, f"ties, n={n}",
         per_env=True)
    with pytest.raises(AssertionError):
        held(scope["lu_solve_unrolled"](A, f).numpy(), want,
             f"ties, n={n}, >=", per_env=True)


def test_the_cases_hold_what_they_claim():
    """Ties at the largest magnitude of A's first column and a singular A
    whose clamp decides q̈; the tiny pivots' values and the clamp's sign;
    NaN in every other env only."""
    n = 18
    tags, blocks = pivot_case("ties", 0, B, n)
    A, f = cuda_resolve.assemble_structured(
        tags, [tuple(torch.tensor(x, dtype=torch.float64) for x in blk)
               for blk in blocks])
    col = A[:, :, 0].abs()
    top = col.amax(dim=1, keepdim=True)
    assert bool(((col == top).sum(dim=1) >= 2).all())
    assert bool((torch.linalg.matrix_rank(A) < n).all())
    assert np.abs(plain(tags, blocks)).max() > 1e6
    tags, blocks = pivot_case("tiny", 0, B, n)
    A, f = cuda_resolve.assemble_structured(
        tags, [tuple(torch.tensor(x) for x in blk) for blk in blocks])
    x = plain(tags, blocks)
    for b in range(B):
        j = int(torch.nonzero(A[b].abs().sum(dim=1) < 1e-12)[0])
        t = float(A[b, j, j])
        assert t in np.asarray(TINY, np.float32)
        want = float(f[b, j]) / (1e-12 if t >= 0 else -1e-12)
        assert x[b, j] == pytest.approx(want, rel=1e-5)
    tags, blocks = pivot_case("nan", 0, B, n)
    nan = np.isnan(plain(tags, blocks)).any(axis=1)
    assert np.array_equal(nan, np.arange(B) % 2 == 1)
