"""K1 at every n and on bfloat16 blocks: the plain version of the port's
pullback + LU resolve (rmp_tpu_torch/ops/cuda_resolve.py) against the JAX
package's K1 (rmp_tpu/ops/pallas_resolve.pullback_resolve_structured), on
the same numpy blocks. JAX's K1 runs in interpret mode at n <= 5; at n = 12
and 24 XLA takes minutes to compile its unrolled LU (92 s at n = 12 on a
CPU host), so there its kernel body `_kernel_structured` runs eagerly on
the operands its pallas_call gets (`jax_k1`, eager=True), the wrapper's
identity pre-sum and block_dtype cast included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu.ops import pallas_resolve as jpr
from rmp_tpu_torch.ops import cuda_resolve

torch.set_num_threads(1)

B = 128
TOL = 2e-4           # |Δq̈| <= TOL * max(1, |q̈|)
LAYOUT = (("identity", 0), ("dense", 3), ("scalar", 20))
INTERPRET_N = (1, 3, 5)
EAGER_N = (12, 24)


def layout_blocks(seed: int, n: int, layout=LAYOUT, bf16: bool = False):
    """(tags, numpy float32 blocks): identity blocks with SPD metrics, dense
    blocks with W = S J (S SPD), scalar blocks with non-negative metrics.
    bf16: every value rounded to bfloat16 once (both packages then read the
    same bits)."""
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
        blk = tuple(np.asarray(x, np.float32) for x in blk)
        if bf16:
            blk = tuple(np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                                   .astype(jnp.float32)) for x in blk)
        blocks.append(blk)
    return tuple(t for t, _ in layout), blocks


def jax_k1(tags, blocks, block_dtype=None, eager: bool = False):
    """q̈ (B, n) of JAX's K1: the Pallas kernel in interpret mode, or (eager)
    its body run under jax.disable_jit() on the operands its pallas_call
    gets, after the same identity pre-sum and block_dtype cast
    (pallas_resolve.py:253-296)."""
    jblocks = [tuple(jnp.asarray(x) for x in blk) for blk in blocks]
    if not eager:
        from jax.experimental.pallas import tpu as pltpu
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(jpr.pullback_resolve_structured(
                tags, jblocks, ridge=0.0, block_dtype=block_dtype))
    A0 = f0 = None
    rest = []
    for tag, blk in zip(tags, jblocks):
        if tag == "identity":
            A0 = blk[0] if A0 is None else A0 + blk[0]
            f0 = blk[1] if f0 is None else f0 + blk[1]
        else:
            rest.append((tag, blk))
    cast = (lambda x: x) if block_dtype is None else (
        lambda x: x.astype(block_dtype))
    kernel_tags, inputs = [], []
    if A0 is not None:
        kernel_tags.append("identity0")
        inputs += [jnp.transpose(cast(A0), (1, 2, 0)),
                   jnp.transpose(cast(f0), (1, 0))]
    for tag, (J, X, v) in rest:
        kernel_tags.append(tag)
        inputs += [jnp.transpose(cast(J), (2, 1, 0)),
                   jnp.transpose(cast(X), (1, 0)) if tag == "scalar"
                   else jnp.transpose(cast(X), (2, 1, 0)),
                   jnp.transpose(cast(v), (1, 0))]
    n = blocks[0][0].shape[-1]
    rows = {}

    class Out:
        def __setitem__(self, idx, value):
            rows[idx[0]] = np.asarray(value)
    with jax.disable_jit():
        jpr._kernel_structured(*inputs, Out(), n=n, ridge=0.0,
                               tags=tuple(kernel_tags))
    return np.stack([rows[i] for i in range(n)], axis=-1)


def port_k1(tags, blocks, block_dtype=None) -> np.ndarray:
    before = cuda_resolve.pullback_resolve_structured.launches
    out = cuda_resolve.pullback_resolve_structured(
        tags, [tuple(torch.tensor(x) for x in blk) for blk in blocks],
        block_dtype=block_dtype)
    assert cuda_resolve.pullback_resolve_structured.launches == before
    assert out.dtype == torch.float32
    return out.numpy()


def assert_close(got, want, what: str):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    print(f"{what}: max|Δq̈| {err:.3e} (limit {TOL * scale:.3e})")
    assert np.isfinite(got).all()
    assert err <= TOL * scale, what


@pytest.mark.parametrize("n", INTERPRET_N + EAGER_N)
def test_plain_k1_matches_jax_at_any_n(n):
    tags, blocks = layout_blocks(n, n)
    want = jax_k1(tags, blocks, eager=n in EAGER_N)
    assert_close(port_k1(tags, blocks), want, f"n={n}, float32")


@pytest.mark.parametrize("n", INTERPRET_N + EAGER_N)
def test_plain_k1_matches_jax_on_bf16_blocks(n):
    """Blocks rounded to bfloat16 once with numpy: JAX's K1 with
    block_dtype=bfloat16 and the port's plain version read the same bits
    (the casts are exact) and upcast them on load."""
    tags, blocks = layout_blocks(100 + n, n, bf16=True)
    want = jax_k1(tags, blocks, jnp.bfloat16, eager=n in EAGER_N)
    assert_close(port_k1(tags, blocks, torch.bfloat16), want,
                 f"n={n}, bfloat16 blocks")
    as_bf16 = [tuple(torch.tensor(x).to(torch.bfloat16) for x in blk)
               for blk in blocks]
    got = cuda_resolve.pullback_resolve_structured(tags, as_bf16).numpy()
    assert_close(got, want, f"n={n}, blocks handed over in bfloat16")


def test_identities_are_summed_in_float32_before_the_cast():
    """Two identity blocks whose values are not bfloat16 numbers: JAX sums
    them in float32, then casts the one seed; so does the port. Casting
    them one by one and summing the bfloat16 values gives another q̈."""
    n = 5
    layout = (("identity", 0), ("dense", 3), ("identity", 0), ("scalar", 20))
    tags, blocks = layout_blocks(7, n, layout)
    want = jax_k1(tags, blocks, jnp.bfloat16)
    assert_close(port_k1(tags, blocks, torch.bfloat16), want,
                 "two identities, pre-summed")
    one_by_one = [tuple(torch.tensor(x).to(torch.bfloat16) for x in blk)
                  for blk in blocks]
    apart = cuda_resolve.pullback_resolve_structured(tags,
                                                     one_by_one).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    gap = float(np.abs(apart - want).max())
    print(f"identities cast one by one: max|Δq̈| {gap:.3e}")
    assert gap > TOL * scale


def test_twenty_blocks_match_jax():
    """A layout of 20 blocks (past the kernel's earlier limit of 16):
    three identities, nine dense and eight scalar blocks at n = 6."""
    layout = ((("identity", 0),) * 3 + (("dense", 3),) * 9
              + (("scalar", 7),) * 8)
    tags, blocks = layout_blocks(20, 6, layout)
    assert len(tags) == 20
    assert_close(port_k1(tags, blocks), jax_k1(tags, blocks, eager=True),
                 "20 blocks, n=6")
    table = cuda_resolve.block_table(tags, [tuple(torch.tensor(x) for x in b)
                                            for b in blocks])
    assert len(table) == 20 * cuda_resolve.ROW_WORDS


def _meta(blocks):
    return [tuple(torch.tensor(x).to("meta") for x in b) for b in blocks]


def test_wrapper_limits_raise_before_a_launch():
    """Off the CPU, more than 32 blocks raise, and so does a block whose
    tensors mix float32 and bfloat16 (meta tensors stand in for a
    device)."""
    layout = (("dense", 2),) * 33
    tags, blocks = layout_blocks(3, 4, layout)
    with pytest.raises(ValueError, match="at most 32 blocks"):
        cuda_resolve.pullback_resolve_structured(tags, _meta(blocks))
    tags, blocks = layout_blocks(4, 4)
    mixed = [tuple(torch.tensor(x) for x in b) for b in blocks]
    mixed[1] = (mixed[1][0].to(torch.bfloat16),) + mixed[1][1:]
    with pytest.raises(TypeError, match="one type per block"):
        cuda_resolve.pullback_resolve_structured(tags, mixed)


def test_bf16_descriptors_name_the_blocks_where_they_lie():
    """A bfloat16 block is handed to the kernel as it is: its descriptor
    holds its own address, its strides in elements and element type 1; a
    float32 block's type is 0. block_dtype casts before the table, with the
    identity seed first."""
    tags, blocks = layout_blocks(5, 4)
    tb = [tuple(torch.tensor(x) for x in b) for b in blocks]
    tb[2] = tuple(x.to(torch.bfloat16) for x in tb[2])
    rows = np.frombuffer(cuda_resolve.block_table(tags, tb), np.int64
                         ).reshape(len(tags), cuda_resolve.ROW_WORDS)
    assert list(rows[:, -1]) == [0, 0, 1]
    for row, blk in zip(rows, tb):
        for t, x in enumerate(blk):
            assert row[2 + t] == x.data_ptr()
            assert tuple(row[5 + 3 * t:5 + 3 * t + x.dim()]) == x.stride()
    ctags, cblocks = cuda_resolve.cast_blocks(
        ("dense", "identity", "identity"),
        [tb[1], tb[0], tb[0]], torch.bfloat16)
    assert ctags == ("identity", "dense")
    assert all(x.dtype == torch.bfloat16 for b in cblocks for x in b)
    torch.testing.assert_close(cblocks[0][0].float(),
                               (tb[0][0] + tb[0][0]).to(torch.bfloat16)
                               .float(), rtol=0, atol=0)


def test_bf16_blocks_raise_under_grad():
    """JAX's K1 has no reverse rule (jax.grad through it raises, float32 or
    bfloat16 blocks); the port keeps its float32 derivative and raises
    for bfloat16 blocks, which only the bf16 fused path feeds."""
    tags, blocks = layout_blocks(6, 3)
    tb = [tuple(torch.tensor(x) for x in b) for b in blocks]
    J = tb[1][0].clone().requires_grad_(True)
    tb[1] = (J,) + tb[1][1:]
    with pytest.raises(RuntimeError, match="no derivative rule"):
        cuda_resolve.pullback_resolve_structured(tags, tb,
                                                 block_dtype=torch.bfloat16)
    cuda_resolve.pullback_resolve_structured(tags, tb).sum().backward()
    assert J.grad is not None
    with torch.no_grad():
        cuda_resolve.pullback_resolve_structured(tags, tb,
                                                 block_dtype=torch.bfloat16)
