"""Seeded K1 inputs that hold the resolve's pivot rule to account.

`pivot_case(case, seed, B, n)` gives (tags, blocks) of numpy float32 arrays
in the layout PIVOT_LAYOUT, each env drawn on its own from the seed:

- 'ties': small integers, so that every block sum is exact in any order.
  The first column of A has exact magnitude ties of both signs at its
  largest entry, and two rows of A are equal (J's two columns and the two
  identity rows), so A is singular: a pivot then falls to a rounding
  residue or to zero, the clamp decides q̈, and which tied row took the
  pivot (the strict `>`, the displaced candidate moving into the taking
  row) shows in q̈.
- 'negative': A negative definite (negated SPD identity blocks, W = -S J,
  m <= 0): every pivot is negative.
- 'tiny': row and column j of A zero but for a_jj = t, t one of ±1e-20,
  ±1e-13, ±0.0: the pivot at j is clamped to ±1e-12 with t's sign (-0.0
  clamps to +1e-12, as `d >= 0` holds for it), and x_j = f_j / (±1e-12).
- 'nan': in every other env one NaN in an identity block's column k at a
  row i >= k (the pivot search meets a NaN magnitude); q̈ is NaN there.

The CPU tests hold the plain version against JAX's K1 body on these, and
chip_smoke.py the kernel against its plain version, in float32 and in
bfloat16 (the integers, the tiny pivots and NaN keep their meaning in
bfloat16).
"""
from __future__ import annotations

import numpy as np

PIVOT_CASES = ("ties", "negative", "tiny", "nan")
# the cases whose A is singular: a float32 solve's error there is bounded
# by the env's largest |q̈| and not entry by entry (two correct solves that
# back-substitute in other orders differ in an entry by up to ~1e-4 of the
# env's largest), so they are held env by env; the others entry by entry
SINGULAR = ("ties",)
# two identity blocks, a dense block and a scalar block of 40 rows (more
# than a staged tile of 32)
PIVOT_LAYOUT = (("identity", 0), ("dense", 3), ("scalar", 40),
                ("identity", 0))
TINY = (1e-20, -1e-20, 1e-13, -1e-13, 0.0, -0.0)


def _spd(rng, B: int, d: int) -> np.ndarray:
    L = rng.normal(size=(B, d, d)) * 0.3
    return L @ L.transpose(0, 2, 1) + 0.5 * np.eye(d)


def _float_blocks(rng, B: int, n: int, sign: float) -> list:
    """PIVOT_LAYOUT's blocks as in chip_smoke.k1_layout_blocks, every
    metric multiplied by `sign`."""
    blocks = []
    for tag, R in PIVOT_LAYOUT:
        if tag == "identity":
            blocks.append([sign * _spd(rng, B, n), rng.normal(size=(B, n))])
        elif tag == "dense":
            J = rng.normal(size=(B, R, n))
            blocks.append([J, sign * (_spd(rng, B, R) @ J),
                           rng.normal(size=(B, R))])
        else:
            blocks.append([rng.normal(size=(B, R, n)) * 0.3,
                           sign * rng.uniform(0.0, 2.0, (B, R)),
                           rng.normal(size=(B, R))])
    return blocks


def _tie_blocks(rng, B: int, n: int) -> list:
    env = np.arange(B)
    ints = lambda *shape: rng.integers(-2, 3, size=shape).astype(np.float64)
    M1, M2 = ints(B, n, n), ints(B, n, n)
    # the first column: entries in {-1, 0, 1}, and 3 with both signs at
    # two or three rows (M2 adds nothing to it)
    M1[:, :, 0] = rng.integers(-1, 2, size=(B, n))
    M2[:, :, 0] = 0.0
    order = np.argsort(rng.random((B, n)), axis=1)
    for t in range(3):
        sign = np.where(rng.random(B) < 0.5, -3.0, 3.0)
        keep = (t < 2) | (rng.random(B) < 0.5)
        M1[env[keep], order[keep, t], 0] = sign[keep]
    # rows a != b of A equal: the two identity rows and J's two columns
    a, b = order[:, 3], order[:, 4]
    for M in (M1, M2):
        M[env, a] = M[env, b]
    blocks = [[M1, ints(B, n)]]
    for tag, R in PIVOT_LAYOUT[1:3]:
        J = rng.integers(-1, 2, size=(B, R, n)).astype(np.float64)
        J[:, :, 0] = 0.0                    # nothing else in column 0
        J[env, :, a] = J[env, :, b]
        if tag == "dense":
            W = rng.integers(-1, 2, size=(B, R, n)).astype(np.float64)
            W[:, :, 0] = 0.0
            W[env, :, a] = W[env, :, b]
            blocks.append([J, W, ints(B, R)])
        else:
            blocks.append([J, rng.integers(0, 3, size=(B, R)).astype(
                np.float64), ints(B, R)])
    blocks.append([M2, ints(B, n)])
    return blocks


def pivot_case(case: str, seed: int, B: int, n: int):
    """(tags, blocks): PIVOT_LAYOUT's tags and numpy float32 blocks of the
    pivot case `case` (PIVOT_CASES) at B envs and n joints."""
    if case not in PIVOT_CASES:
        raise ValueError(f"unknown pivot case {case!r}: {PIVOT_CASES}")
    rng = np.random.default_rng([seed, PIVOT_CASES.index(case), n])
    env = np.arange(B)
    if case == "ties":
        blocks = _tie_blocks(rng, B, n)
    else:
        blocks = _float_blocks(rng, B, n, -1.0 if case == "negative"
                               else 1.0)
    if case == "tiny":
        j = rng.integers(0, n, size=B)
        t = np.asarray(TINY)[rng.integers(0, len(TINY), size=B)]
        for k, (tag, _) in enumerate(PIVOT_LAYOUT):
            if tag == "identity":
                M = blocks[k][0]
                M[env, j, :] = 0.0
                M[env, :, j] = 0.0
                if k == 0:
                    M[env, j, j] = t
            else:
                blocks[k][0][env, :, j] = 0.0
                if tag == "dense":
                    blocks[k][1][env, :, j] = 0.0
    elif case == "nan":
        k = rng.integers(0, n, size=B)
        i = k + (rng.random(B) * (n - k)).astype(np.int64)
        hit = env[env % 2 == 1]
        blocks[0][0][hit, i[hit], k[hit]] = np.nan
    tags = tuple(tag for tag, _ in PIVOT_LAYOUT)
    return tags, [tuple(np.asarray(x, np.float32) for x in blk)
                  for blk in blocks]
