"""K1: fused RMP pullback + pivoted-LU resolve, the CUDA counterpart of
`rmp_tpu/ops/pallas_resolve.py::pullback_resolve_structured`, and the
dense-block entry points K2a (`pullback_resolve`, `pullback_resolve_t`) and
K2b (`pullback_resolve_blocks`) on the same kernel.

Structured per-policy blocks (core.policy_row_blocks_structured, leading
batch axis B on every tensor):

  'identity': (M (B, n, n), v (B, n))
  'scalar':   (J (B, R, n), m (B, R), v (B, R))
  'dense':    (J (B, R, n), W (B, R, n), v (B, R))

give q̈ = (A + ridge I)^{-1} f with A = Σ identity M + Σ Jᵀ diag(m) J +
Σ Jᵀ W and f = Σ v + Σ Jᵀ v. A CPU tensor takes the plain PyTorch version
(`pullback_resolve_structured_plain`); a CUDA tensor launches the kernel or
raises (n = 1..9 on a group of 8 lanes per env, csrc/pullback_resolve.cu;
n = 10..32 on a warp per env, csrc/pullback_resolve_wide.cuh; n = 33..64
on a warp per env with two rows of [A | f] a lane, the CTA kernel of
csrc/pullback_resolve_cta.cuh; n > 64 and more than 32 blocks raise). The
kernel reads every block where it lies, through its strides
(`block_table`): the call copies no operand and launches nothing else.
Every call, K2a's and K2b's and the backward's transposed solve too, goes
through K1's torch.library op (ops/library.py), which a traced graph keeps
whole: its CUDA implementation is `launch`, the kernel's one launch site
(counted on the calling entry point's counter, COUNTERS), its CPU one
`solve_plain`.

Blocks are float32 or bfloat16, each block's tensors of one type; the
kernel widens a bfloat16 element to float32 as it loads it, and every sum
and the LU stay float32, as the TPU kernel's upcast on load.
`block_dtype=torch.bfloat16` does what JAX's `block_dtype` does on the
producer side: the identity blocks are summed in float32 into one seed
block (placed first), and that seed and every other block are cast to
bfloat16 (`cast_blocks`; a few elementwise launches before K1's one). The
plain version upcasts the same bfloat16 tensors. JAX's K1 has no reverse
rule (`jax.grad` through it raises in interpret mode, float32 or bfloat16
blocks); the port differentiates float32 blocks (below) and raises under
grad for bfloat16 ones.

K2a and K2b compute q̈ = (Σ Jᵀ W + ridge I)⁻¹ Σ Jᵀ v from dense rows only,
as the TPU kernels `_kernel` and `_kernel_blocks` do: each launches K1's
kernel with no identity seed and no scalar rows, keeps its own launch
counter, and takes the plain version on a CPU tensor.

Gradients: while any block requires grad, each entry point goes through
`PullbackResolve`, a torch.autograd.Function on both devices whose forward
is the same kernel (or plain version). Its backward is closed-form: with
x = (A + ridge I)⁻¹ f and the cotangent x̄,

  f̄ = (A + ridge I)⁻ᵀ x̄,    Ā = -f̄ xᵀ,

then into each block by products (identity: M̄ = Ā, v̄ = f̄; scalar:
J̄ = -m (J x f̄ᵀ + J f̄ xᵀ) + v f̄ᵀ row by row, m̄ = -(J f̄)(J x), v̄ = J f̄;
dense: J̄ = (v - W x) f̄ᵀ, W̄ = -(J f̄) xᵀ, v̄ = J f̄). The transposed solve
is K1 itself on the card: A, assembled by einsum, goes in as one identity
block read through its transposed strides (the kernel reads an identity
block's M entry by entry, unsymmetrised), with the same ridge, counted on
`pullback_resolve_structured.transposed_launches`; the CPU takes the plain
version. Where the pivot clamp (|pivot| < 1e-12) is active the closed form
differs from autograd through the plain LU.
"""
from __future__ import annotations

import array
import ctypes

import torch

from rmp_tpu_torch import _build
from rmp_tpu_torch.ops.linalg import lu_solve_unrolled

_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]


def assemble_structured(tags, blocks):
    """(A (B, n, n), f (B, n)) summed over the blocks in tag order."""
    A = f = None
    for tag, blk in zip(tags, blocks):
        if tag == "identity":
            dA, df = blk
        elif tag == "scalar":
            J, m, v = blk
            dA = torch.einsum("brn,br,brm->bnm", J, m, J)
            df = torch.einsum("brn,br->bn", J, v)
        else:
            J, W, v = blk
            dA = torch.einsum("brn,brm->bnm", J, W)
            df = torch.einsum("brn,br->bn", J, v)
        A = dA if A is None else A + dA
        f = df if f is None else f + df
    return A, f


def pullback_resolve_structured_plain(tags, blocks, ridge: float = 0.0,
                                      block_dtype=None) -> torch.Tensor:
    """The plain PyTorch version of K1: the blocks cast as the wrapper casts
    them (`cast_blocks`), upcast to float32, einsum accumulation, then the
    unrolled pivoted LU of ops/linalg.py."""
    if block_dtype is not None:
        tags, blocks = cast_blocks(tags, blocks, block_dtype)
    blocks = [tuple(x.float() if x.dtype == torch.bfloat16 else x
                    for x in blk) for blk in blocks]
    A, f = assemble_structured(tags, blocks)
    if ridge:
        A = A + ridge * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return lu_solve_unrolled(A, f)


def cast_blocks(tags, blocks, block_dtype):
    """(tags, blocks) as K1 reads them with `block_dtype`
    (pallas_resolve.pullback_resolve_structured's producer side): the
    identity blocks summed in float32, in tag order, into one seed block
    placed first and then cast; every scalar and dense block cast. A lone
    float32 identity block is cast as it is."""
    if block_dtype not in ELEMENT_TYPES:
        raise TypeError(f"block_dtype must be one of "
                        f"{tuple(ELEMENT_TYPES)}, got {block_dtype}")
    seed = None
    rest_tags, rest = [], []
    for tag, blk in zip(tags, blocks):
        if tag == "identity":
            M, v = (x.float() for x in blk)
            seed = (M, v) if seed is None else (seed[0] + M, seed[1] + v)
        else:
            rest_tags.append(tag)
            rest.append(blk)
    if seed is not None:
        rest_tags.insert(0, "identity")
        rest.insert(0, seed)
    return tuple(rest_tags), [tuple(x.to(block_dtype) for x in blk)
                              for blk in rest]


KINDS = {"identity": 0, "scalar": 1, "dense": 2}
ELEMENT_TYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_N = 64           # n = 1..9 on 8 lanes per env, 10..32 on a warp,
                     # 33..MAX_N on a warp with two rows a lane
KERNEL_N = range(1, MAX_N + 1)  # the n the kernels take
MAX_BLOCKS = 32      # descriptors the kernel takes per call
ROW_WORDS = 15       # kind, rows, 3 addresses, 3 x 3 strides, element type


def _check_blocks(tags, blocks, table: bool = True):
    """(B, n, device, table) of validated float32 or bfloat16 blocks,
    `table` their descriptors for the kernel (block_table), or None
    without `table` (what a fake tensor, which has no address, allows);
    raises on anything else. One pass over the tensors: the kernel's call
    is host-bound."""
    if len(tags) != len(blocks) or not tags:
        raise ValueError("tags and blocks must be non-empty and aligned")
    first = blocks[0][0]
    B, n, device = first.shape[0], first.shape[-1], first.device
    index = first.get_device()      # the CUDA index; -1 off CUDA
    words = []
    for tag, blk in zip(tags, blocks):
        if tag == "identity":
            M, v = blk
            ok, rows = M.shape == (B, n, n) and v.shape == (B, n), 0
        elif tag in ("scalar", "dense"):
            J, X, v = blk
            rows = J.shape[1] if J.dim() == 3 else -1
            want = (B, rows) if tag == "scalar" else (B, rows, n)
            ok = (J.shape == (B, rows, n) and X.shape == want
                  and v.shape == (B, rows))
        else:
            raise ValueError(f"unknown block tag {tag!r}")
        if not ok:
            raise ValueError(f"bad {tag!r} block shapes "
                             f"{[tuple(x.shape) for x in blk]} for B={B}, n={n}")
        ptrs, strides = [0, 0, 0], []
        elem = ELEMENT_TYPES.get(blk[0].dtype)
        for t, x in enumerate(blk):
            if elem is None or x.dtype != blk[0].dtype:
                raise TypeError(f"pullback_resolve_structured takes float32 "
                                f"or bfloat16 blocks, one type per block, got "
                                f"{[y.dtype for y in blk]} in a {tag!r} "
                                f"block")
            if x.get_device() != index or (index < 0 and x.device != device):
                raise ValueError(f"blocks on {device} and {x.device}")
            if table:
                ptrs[t] = x.data_ptr()
                st = x.stride()
                strides += st if len(st) == 3 else (*st, 0)
        words += (KINDS[tag], rows, *ptrs, *strides,
                  *(0,) * (9 - len(strides)), elem)
    return B, n, device, array.array("q", words) if table else None


def block_table(tags, blocks) -> array.array:
    """The kernel's descriptor table, int64 words, ROW_WORDS per block in
    tag order: [kind, rows, 3 addresses, 3 x (batch, row, column) strides
    in elements, element type (ELEMENT_TYPES)]. Identity blocks have 0
    rows and no third tensor; a 2-D tensor's column stride is 0. Nothing
    is copied: the addresses are the blocks' own `data_ptr()`, views
    included."""
    return _check_blocks(tags, blocks)[3]


def check_limits(n: int, count: int, device) -> None:
    """Raise for a call the kernel does not take: an n it is not
    instantiated for, more than MAX_BLOCKS blocks, a device other than
    CUDA."""
    if n not in KERNEL_N:
        raise ValueError(f"no K1 kernel instantiated for n={n}: the kernel "
                         f"takes n from 1 to {MAX_N}")
    if count > MAX_BLOCKS:
        raise ValueError(f"the K1 kernel takes at most {MAX_BLOCKS} blocks, "
                         f"got {count}")
    if device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {device}")


def launch(tags, blocks, ridge: float, counter: int) -> torch.Tensor:
    """q̈ (B, n) from K1's CUDA kernel: one launch on the blocks where they
    lie, counted on COUNTERS[counter]. Raises for what the kernel does
    not take (check_limits) and for a failed launch."""
    B, n, device, table = _check_blocks(tags, blocks)
    check_limits(n, len(tags), device)
    out = torch.empty(B, n, dtype=torch.float32, device=device)
    fn = _build.c_function("rmp_pullback_resolve", _ARGTYPES)
    rc = fn(device.index, n, B, table.buffer_info()[0], len(tags),
            float(ridge), out.data_ptr(), _build.raw_stream(device))
    if rc in (-1, -2, -3):
        raise ValueError(f"the K1 kernel refused n={n}, {len(tags)} blocks "
                         f"(code {rc})")
    if rc != 0:
        raise RuntimeError(f"K1 pullback_resolve launch failed: CUDA error {rc}")
    holder, attr = COUNTERS[counter]
    setattr(holder, attr, getattr(holder, attr) + 1)
    return out


def solve_plain(tags, blocks, ridge: float) -> torch.Tensor:
    """The plain version on validated CPU blocks, contiguous as the
    kernel's output is."""
    _check_blocks(tags, blocks, table=False)
    return pullback_resolve_structured_plain(tags, blocks,
                                             ridge).contiguous()


def _solve(counter: int, tags, blocks, ridge: float) -> torch.Tensor:
    """q̈ of the blocks through K1's op (ops/library.py): the plain
    version on the CPU, the kernel on CUDA, counted on COUNTERS[counter];
    raises on any other device (on meta tensors, after the limits)."""
    from rmp_tpu_torch.ops import library
    unknown = [t for t in tags if t not in KINDS]
    if unknown:
        raise ValueError(f"unknown block tag {unknown[0]!r}")
    return library.pullback_resolve_structured(
        [x for blk in blocks for x in blk], [KINDS[t] for t in tags],
        float(ridge), counter)


def _entry(counter: int, tags, blocks, ridge: float) -> torch.Tensor:
    """q̈ through `PullbackResolve` while a block requires grad, else the
    forward alone. Raises under grad for bfloat16 blocks, as JAX's K1 has no
    reverse rule."""
    if torch.is_grad_enabled() and any(x.requires_grad for blk in blocks
                                       for x in blk):
        if any(x.dtype == torch.bfloat16 for blk in blocks for x in blk):
            raise RuntimeError("K1 on bfloat16 blocks has no derivative rule "
                               "(nor has JAX's): call it under "
                               "torch.no_grad() or with float32 blocks")
        sizes = tuple(len(blk) for blk in blocks)
        return PullbackResolve.apply(counter, tuple(tags), sizes,
                                     float(ridge),
                                     *(x for blk in blocks for x in blk))
    return _solve(counter, tags, blocks, ridge)


def transposed_solve(A: torch.Tensor, g: torch.Tensor,
                     ridge: float) -> torch.Tensor:
    """(A + ridge I)⁻ᵀ g for A (B, n, n), g (B, n): K1 on a CUDA tensor (A
    as one identity block, read through its transposed strides; counted on
    pullback_resolve_structured.transposed_launches), the plain version on
    a CPU tensor."""
    return _solve(TRANSPOSED, ("identity",), [(A.transpose(-1, -2), g)],
                  ridge)


def block_cotangents(tags, blocks, x: torch.Tensor, fbar: torch.Tensor):
    """The closed-form cotangents of every block tensor, in block order,
    given q̈ x and f̄ (B, n); see the module doc."""
    out = []
    for tag, blk in zip(tags, blocks):
        if tag == "identity":
            out.append((-fbar[:, :, None] * x[:, None, :], fbar))
            continue
        J, X, v = blk
        a = torch.einsum("brn,bn->br", J, fbar)          # J f̄
        if tag == "scalar":
            b = torch.einsum("brn,bn->br", J, x)         # J x
            Jbar = (v[..., None] * fbar[:, None, :]
                    - X[..., None] * (b[..., None] * fbar[:, None, :]
                                      + a[..., None] * x[:, None, :]))
            out.append((Jbar, -a * b, a))
        else:
            Wx = torch.einsum("brn,bn->br", X, x)
            out.append(((v - Wx)[..., None] * fbar[:, None, :],
                        -a[..., None] * x[:, None, :], a))
    return out


def _unflatten(flat, sizes) -> list:
    """The block tuples of a flat tensor sequence, `sizes` tensors each."""
    blocks, at = [], 0
    for size in sizes:
        blocks.append(tuple(flat[at:at + size]))
        at += size
    return blocks


class PullbackResolve(torch.autograd.Function):
    """K1 (and K2a/K2b, on K1's kernel) with the closed-form backward of
    the module doc. The blocks arrive flattened: `sizes` gives each
    block's tensor count, `counter` the entry of COUNTERS that a forward
    launch raises."""

    @staticmethod
    def forward(ctx, counter, tags, sizes, ridge, *flat):
        x = _solve(counter, tags, _unflatten(flat, sizes), ridge)
        ctx.tags, ctx.sizes, ctx.ridge = tags, sizes, ridge
        ctx.save_for_backward(x, *flat)
        return x

    @staticmethod
    def backward(ctx, xbar):
        x, *flat = ctx.saved_tensors
        blocks = _unflatten(flat, ctx.sizes)
        A, _ = assemble_structured(ctx.tags, blocks)
        fbar = transposed_solve(A, xbar, ctx.ridge)
        grads = [g for blk in block_cotangents(ctx.tags, blocks, x, fbar)
                 for g in blk]
        want = ctx.needs_input_grad[4:]
        return (None,) * 4 + tuple(g if w else None
                                   for g, w in zip(grads, want))


def pullback_resolve_structured(tags, blocks, ridge: float = 0.0,
                                block_dtype=None) -> torch.Tensor:
    """q̈ (B, n) from structured per-policy blocks; block_dtype
    (torch.bfloat16 or None) as JAX's; see the module doc."""
    if block_dtype is not None:
        tags, blocks = cast_blocks(tags, blocks, block_dtype)
    return _entry(STRUCTURED, tags, blocks, ridge)


pullback_resolve_structured.launches = 0
pullback_resolve_structured.transposed_launches = 0


# ------------------------------------------------- K2a, K2b: dense rows ---

def _dense(J_blocks, W_blocks, v_blocks):
    if not (len(J_blocks) == len(W_blocks) == len(v_blocks)):
        raise ValueError("J, W and v block lists must be aligned")
    return ("dense",) * len(J_blocks), list(zip(J_blocks, W_blocks, v_blocks))


def _from_batch_minor(Jt, Wt, vt):
    """(n, R, B) / (R, B) operands as (B, R, n) / (B, R) views; raises on
    anything else."""
    if Jt.dim() != 3 or Wt.shape != Jt.shape or vt.shape != Jt.shape[1:]:
        raise ValueError(f"pullback_resolve_t takes Jt, Wt (n, R, B) and vt "
                         f"(R, B), got {tuple(Jt.shape)}, {tuple(Wt.shape)}, "
                         f"{tuple(vt.shape)}")
    return Jt.permute(2, 1, 0), Wt.permute(2, 1, 0), vt.permute(1, 0)


def pullback_resolve_blocks_plain(J_blocks, W_blocks, v_blocks,
                                  ridge: float = 0.0) -> torch.Tensor:
    """The plain version of K2b: einsum Gram accumulation over the blocks,
    the ridge, the unrolled pivoted LU."""
    return pullback_resolve_structured_plain(
        *_dense(J_blocks, W_blocks, v_blocks), ridge)


def pullback_resolve_plain(J, W, v, ridge: float = 1e-6) -> torch.Tensor:
    """The plain version of K2a."""
    return pullback_resolve_blocks_plain([J], [W], [v], ridge)


def pullback_resolve_t_plain(Jt, Wt, vt, ridge: float = 1e-6) -> torch.Tensor:
    """The plain version of K2a on the batch-minor layout."""
    return pullback_resolve_plain(*_from_batch_minor(Jt, Wt, vt), ridge)


def _dense_entry(counter: int, J_blocks, W_blocks, v_blocks, ridge: float):
    """q̈ of dense blocks: the plain version on the CPU, else K1's kernel,
    counted on COUNTERS[counter]; through `PullbackResolve` under grad."""
    return _entry(counter, *_dense(J_blocks, W_blocks, v_blocks), ridge)


def pullback_resolve_blocks(J_blocks, W_blocks, v_blocks,
                            ridge: float = 0.0) -> torch.Tensor:
    """K2b: q̈ = (Σ_b J_bᵀ W_b + ridge I)⁻¹ Σ_b J_bᵀ v_b for lists of
    J_b, W_b (B, R_b, n) and v_b (B, R_b) -> (B, n), at most MAX_BLOCKS
    blocks; the kernel reads each block, views included, through its
    strides."""
    return _dense_entry(BLOCKS, J_blocks, W_blocks, v_blocks, ridge)


def pullback_resolve(J: torch.Tensor, W: torch.Tensor, v: torch.Tensor,
                     ridge: float = 1e-6) -> torch.Tensor:
    """K2a: q̈ = (Jᵀ W + ridge I)⁻¹ Jᵀ v for J, W (B, R, n), v (B, R) ->
    (B, n)."""
    return _dense_entry(DENSE, [J], [W], [v], ridge)


def pullback_resolve_t(Jt: torch.Tensor, Wt: torch.Tensor, vt: torch.Tensor,
                       ridge: float = 1e-6) -> torch.Tensor:
    """K2a on the JAX package's batch-minor layout: Jt, Wt (n, R, B), vt
    (R, B) -> (B, n). The kernel reads the permuted (B, R, n) views
    through their strides."""
    J, W, v = _from_batch_minor(Jt, Wt, vt)
    return _dense_entry(DENSE_T, [J], [W], [v], ridge)


pullback_resolve_blocks.launches = 0
pullback_resolve.launches = 0
pullback_resolve_t.launches = 0

# the launch counters of K1's kernel, by the entry that launched it: the
# `counter` argument of K1's op names one (an exported artifact calls the
# op with STRUCTURED)
STRUCTURED, TRANSPOSED, DENSE, DENSE_T, BLOCKS = range(5)
COUNTERS = ((pullback_resolve_structured, "launches"),
            (pullback_resolve_structured, "transposed_launches"),
            (pullback_resolve, "launches"), (pullback_resolve_t, "launches"),
            (pullback_resolve_blocks, "launches"))
