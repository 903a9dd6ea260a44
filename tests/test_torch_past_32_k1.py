"""K1 past 32 motors: the plain version of the port's pullback + LU resolve
(rmp_tpu_torch/ops/cuda_resolve.py), which the CTA kernel
(csrc/pullback_resolve_cta.cuh) is held to on the card, against the JAX
package's K1 body `_kernel_structured` run eagerly on the operands its
pallas_call gets (test_torch_resolve_n.jax_k1, eager=True: XLA takes
minutes to compile the unrolled LU), at n = 33, 36 and 64, on float32 and
on bfloat16 blocks. The bfloat16 envs ride in the same JAX call as the
float32 ones: their values are rounded to bfloat16 once, so JAX's kernel,
which widens a bfloat16 element to float32 on load, reads the same
numbers either way, and the port gets them as bfloat16 tensors. Eager
JAX takes ~9 s at n = 33 and ~50 s at n = 64 on a CPU host, whatever
the batch."""
import numpy as np
import pytest
import torch

from rmp_tpu_torch.ops import cuda_resolve
from test_torch_resolve import layout_blocks
from test_torch_resolve_n import assert_close, jax_k1

torch.set_num_threads(1)

B = 16               # envs of each block type
# one identity block: JAX's identity pre-sum is then the block itself
LAYOUT = (("identity", 0), ("dense", 3), ("scalar", 20))


def bf16_rounded(blocks):
    return [tuple(torch.tensor(x).to(torch.bfloat16).float().numpy()
                  for x in blk) for blk in blocks]


@pytest.mark.parametrize("n", [33, 36, 64])
def test_plain_k1_matches_jax_past_32(n):
    """q̈ of the port's plain version against JAX's K1 body, float32 and
    bfloat16 blocks, each within TOL x max(1, |q̈|) (test_torch_resolve_n's
    limit)."""
    tags, f32 = layout_blocks(n, B, n, LAYOUT)
    _, other = layout_blocks(100 + n, B, n, LAYOUT)
    half = bf16_rounded(other)
    both = [tuple(np.concatenate([a, b]) for a, b in zip(x, y))
            for x, y in zip(f32, half)]
    want = jax_k1(tags, both, eager=True)
    before = cuda_resolve.pullback_resolve_structured.launches
    got32 = cuda_resolve.pullback_resolve_structured(
        tags, [tuple(torch.tensor(x) for x in blk) for blk in f32]).numpy()
    got16 = cuda_resolve.pullback_resolve_structured(
        tags, [tuple(torch.tensor(x).to(torch.bfloat16) for x in blk)
               for blk in half]).numpy()
    assert cuda_resolve.pullback_resolve_structured.launches == before
    assert_close(got32, want[:B], f"n={n}, float32")
    assert_close(got16, want[B:], f"n={n}, bfloat16 blocks")
