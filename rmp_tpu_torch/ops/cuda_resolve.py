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
(`pullback_resolve_structured_plain`); a CUDA tensor launches the kernel of
csrc/pullback_resolve.cu or raises (n = 2, 6 and 9 on a group of 8 lanes
per env, n = 18 on a warp per env). The kernel reads every block where it
lies, through its strides (`block_table`): the call copies no operand and
launches nothing else.

K2a and K2b compute q̈ = (Σ Jᵀ W + ridge I)⁻¹ Σ Jᵀ v from dense rows only,
as the TPU kernels `_kernel` and `_kernel_blocks` do: each launches K1's
kernel with no identity seed and no scalar rows, keeps its own launch
counter, and takes the plain version on a CPU tensor.
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


def pullback_resolve_structured_plain(tags, blocks,
                                      ridge: float = 0.0) -> torch.Tensor:
    """The plain PyTorch version of K1: einsum accumulation, then the
    unrolled pivoted LU of ops/linalg.py."""
    A, f = assemble_structured(tags, blocks)
    if ridge:
        A = A + ridge * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return lu_solve_unrolled(A, f)


KINDS = {"identity": 0, "scalar": 1, "dense": 2}
KERNEL_N = (2, 6, 9, 18)  # the n the kernel is instantiated for
MAX_BLOCKS = 16      # descriptors the kernel takes per call
ROW_WORDS = 14       # kind, rows, 3 addresses, 3 x 3 strides


def _check_blocks(tags, blocks):
    """(B, n, device, table) of validated float32 blocks, `table` their
    descriptors for the kernel (block_table); raises on anything else. One
    pass over the tensors: the kernel's call is host-bound."""
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
        for t, x in enumerate(blk):
            if x.dtype != torch.float32:
                raise TypeError(f"pullback_resolve_structured takes float32 "
                                f"blocks, got {x.dtype} in a {tag!r} block")
            if x.get_device() != index or (index < 0 and x.device != device):
                raise ValueError(f"blocks on {device} and {x.device}")
            ptrs[t] = x.data_ptr()
            st = x.stride()
            strides += st if len(st) == 3 else (*st, 0)
        words += (KINDS[tag], rows, *ptrs, *strides,
                  *(0,) * (9 - len(strides)))
    return B, n, device, array.array("q", words)


def block_table(tags, blocks) -> array.array:
    """The kernel's descriptor table, int64 words, ROW_WORDS per block in
    tag order: [kind, rows, 3 addresses, 3 x (batch, row, column) strides
    in elements]. Identity blocks have 0 rows and no third tensor; a 2-D
    tensor's column stride is 0. Nothing is copied: the addresses are the
    blocks' own `data_ptr()`, views included."""
    return _check_blocks(tags, blocks)[3]


def _launch(table, count: int, ridge: float, B: int, n: int, device):
    """q̈ (B, n) from K1's CUDA kernel on `count` validated blocks on
    `device`, described by `table`: one launch on the blocks where they
    lie. Raises for an n the kernel is not instantiated for."""
    if n not in KERNEL_N:
        raise ValueError(f"no K1 kernel instantiated for n={n} (have "
                         f"{KERNEL_N})")
    if device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {device}")
    if count > MAX_BLOCKS:
        raise ValueError(f"the K1 kernel takes at most {MAX_BLOCKS} blocks, "
                         f"got {count}")
    out = torch.empty(B, n, dtype=torch.float32, device=device)
    fn = _build.c_function("rmp_pullback_resolve_f32", _ARGTYPES)
    rc = fn(device.index, n, B, table.buffer_info()[0], count, float(ridge),
            out.data_ptr(), _build.raw_stream(device))
    if rc == -1:
        raise ValueError(f"no K1 kernel instantiated for n={n}")
    if rc != 0:
        raise RuntimeError(f"K1 pullback_resolve launch failed: CUDA error {rc}")
    return out


def pullback_resolve_structured(tags, blocks,
                                ridge: float = 0.0) -> torch.Tensor:
    """q̈ (B, n) from structured per-policy blocks; see the module doc."""
    B, n, device, table = _check_blocks(tags, blocks)
    if device.type == "cpu":
        return pullback_resolve_structured_plain(tags, blocks, ridge)
    out = _launch(table, len(tags), ridge, B, n, device)
    pullback_resolve_structured.launches += 1
    return out


pullback_resolve_structured.launches = 0


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


def _dense_entry(entry, J_blocks, W_blocks, v_blocks, ridge: float):
    """q̈ of dense blocks: the plain version on the CPU, else K1's kernel,
    counted on `entry`."""
    tags, blocks = _dense(J_blocks, W_blocks, v_blocks)
    B, n, device, table = _check_blocks(tags, blocks)
    if device.type == "cpu":
        return pullback_resolve_structured_plain(tags, blocks, ridge)
    out = _launch(table, len(tags), ridge, B, n, device)
    entry.launches += 1
    return out


def pullback_resolve_blocks(J_blocks, W_blocks, v_blocks,
                            ridge: float = 0.0) -> torch.Tensor:
    """K2b: q̈ = (Σ_b J_bᵀ W_b + ridge I)⁻¹ Σ_b J_bᵀ v_b for lists of
    J_b, W_b (B, R_b, n) and v_b (B, R_b) -> (B, n), at most MAX_BLOCKS
    blocks; the kernel reads each block, views included, through its
    strides."""
    return _dense_entry(pullback_resolve_blocks, J_blocks, W_blocks, v_blocks,
                        ridge)


def pullback_resolve(J: torch.Tensor, W: torch.Tensor, v: torch.Tensor,
                     ridge: float = 1e-6) -> torch.Tensor:
    """K2a: q̈ = (Jᵀ W + ridge I)⁻¹ Jᵀ v for J, W (B, R, n), v (B, R) ->
    (B, n)."""
    return _dense_entry(pullback_resolve, [J], [W], [v], ridge)


def pullback_resolve_t(Jt: torch.Tensor, Wt: torch.Tensor, vt: torch.Tensor,
                       ridge: float = 1e-6) -> torch.Tensor:
    """K2a on the JAX package's batch-minor layout: Jt, Wt (n, R, B), vt
    (R, B) -> (B, n). The kernel reads the permuted (B, R, n) views
    through their strides."""
    J, W, v = _from_batch_minor(Jt, Wt, vt)
    return _dense_entry(pullback_resolve_t, [J], [W], [v], ridge)


pullback_resolve_blocks.launches = 0
pullback_resolve.launches = 0
pullback_resolve_t.launches = 0
