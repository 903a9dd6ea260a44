"""The card's kernels K1, K3 and K4 as opaque `torch.library` ops.

A tracer (make_fx, torch.export) cannot see into a kernel launched
through ctypes: under fake tensors the launch reads `data_ptr()`, and under
real ones it writes into its outputs behind the tracer's back. So every
call of K1, K3 and K4 goes through one of these ops, which a traced graph
keeps as one node each, and an exported artifact (experiments/aot_export.py)
carries:

  rmp_tpu_torch::pullback_resolve_structured(Tensor[] flat, int[] kinds,
      float ridge, int counter) -> Tensor
      K1 (ops/cuda_resolve.py): the blocks' tensors in block order, each
      block's kind (cuda_resolve.KINDS); `counter` names the launch counter
      of the entry point that called it (cuda_resolve.COUNTERS). K2a, K2b
      and the resolve's transposed solve take it too.
  rmp_tpu_torch::fk_derivatives(Tensor q, Tensor qd, Tensor parent,
      Tensor joint_type, Tensor q_index, Tensor axis, Tensor T_constant,
      Tensor anc, int F, int n) -> (Tensor, Tensor, Tensor, Tensor)
      K3 (ops/cuda_fk.py): the model as its tables (cuda_fk.TABLES).
  rmp_tpu_torch::gjk_hull_obstacles(Tensor verts, Tensor R, Tensor t,
      Tensor p0, Tensor p1, Tensor an, Tensor radius, Tensor is_cyl,
      Tensor d0, int iters) -> (Tensor, Tensor, Tensor)
      K4 (ops/cuda_gjk.py).

Each op has three implementations: on CUDA tensors the kernel's one launch
site (`cuda_resolve.launch`, `cuda_fk.launch`, `cuda_gjk.launch`), which
counts the launch and raises on anything the kernel does not take or a
failed launch (never a fallback); on CPU tensors the plain version; and a
fake one that gives the outputs' shapes from the inputs' alone. The
wrappers' autograd Functions call the ops in their forward, so gradients
are as before. This module imports torch and the three kernel modules
(ctypes, the build and the plain versions), nothing of the scenes: a
serving host imports it alone to load an artifact.
"""
from __future__ import annotations

import torch

from rmp_tpu_torch.ops import cuda_fk, cuda_gjk, cuda_resolve

_NS = "rmp_tpu_torch"
_KIND_TAGS = {v: k for k, v in cuda_resolve.KINDS.items()}


def _blocks(flat, kinds):
    """(tags, blocks) of the op's flat operands: 2 tensors for an identity
    block, 3 for a scalar or dense one."""
    tags = [_KIND_TAGS[k] for k in kinds]
    sizes = [2 if t == "identity" else 3 for t in tags]
    if sum(sizes) != len(flat):
        raise ValueError(f"{len(flat)} tensors for block kinds {list(kinds)}")
    return tags, cuda_resolve._unflatten(flat, sizes)


@torch.library.custom_op(f"{_NS}::pullback_resolve_structured",
                         mutates_args=(), device_types="cpu")
def pullback_resolve_structured(flat: list[torch.Tensor], kinds: list[int],
                                ridge: float, counter: int) -> torch.Tensor:
    return cuda_resolve.solve_plain(*_blocks(flat, kinds), ridge)


@pullback_resolve_structured.register_kernel("cuda")
def _(flat, kinds, ridge, counter):
    return cuda_resolve.launch(*_blocks(flat, kinds), ridge, counter)


@pullback_resolve_structured.register_fake
def _(flat, kinds, ridge, counter):
    tags, blocks = _blocks(flat, kinds)
    B, n, device, _ = cuda_resolve._check_blocks(tags, blocks, table=False)
    if device.type != "cpu":
        cuda_resolve.check_limits(n, len(tags), device)
    return flat[0].new_empty((B, n), dtype=torch.float32)


@torch.library.custom_op(f"{_NS}::fk_derivatives", mutates_args=(),
                         device_types="cpu")
def fk_derivatives(q: torch.Tensor, qd: torch.Tensor, parent: torch.Tensor,
                   joint_type: torch.Tensor, q_index: torch.Tensor,
                   axis: torch.Tensor, T_constant: torch.Tensor,
                   anc: torch.Tensor, F: int, n: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    return cuda_fk.plain_of_tables(q, qd, parent, joint_type, q_index, axis,
                                   T_constant, anc, F, n)


@fk_derivatives.register_kernel("cuda")
def _(q, qd, parent, joint_type, q_index, axis, T_constant, anc, F, n):
    return cuda_fk.launch(q, qd, parent, joint_type, q_index, axis,
                          T_constant, anc, F, n)


@fk_derivatives.register_fake
def _(q, qd, parent, joint_type, q_index, axis, T_constant, anc, F, n):
    B = q.shape[0]
    return (q.new_empty((B, F, 16)), q.new_empty((B, F, 16)),
            q.new_empty((B, F, 16, n)), q.new_empty((B, F, 16)))


@torch.library.custom_op(f"{_NS}::gjk_hull_obstacles", mutates_args=(),
                         device_types="cpu")
def gjk_hull_obstacles(verts: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                       p0: torch.Tensor, p1: torch.Tensor, an: torch.Tensor,
                       radius: torch.Tensor, is_cyl: torch.Tensor,
                       d0: torch.Tensor, iters: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    cuda_gjk._check(verts, R, t, p0, p1, an, radius, is_cyl, d0)
    return tuple(x.contiguous() for x in cuda_gjk.gjk_hull_obstacles_plain(
        verts, R, t, p0, p1, an, radius, is_cyl, d0, iters))


@gjk_hull_obstacles.register_kernel("cuda")
def _(verts, R, t, p0, p1, an, radius, is_cyl, d0, iters):
    return cuda_gjk.launch(verts, R, t, p0, p1, an, radius, is_cyl, d0, iters)


@gjk_hull_obstacles.register_fake
def _(verts, R, t, p0, p1, an, radius, is_cyl, d0, iters):
    L, M, _, B = cuda_gjk._check(verts, R, t, p0, p1, an, radius, is_cyl, d0)
    return (p0.new_empty((L, M, 3, B)), p0.new_empty((L, M, 3, B)),
            p0.new_empty((L, M, B)))


# the ops' qualified names, as an exported graph's nodes call them
OPS = tuple(f"{_NS}::{name}" for name in
            ("pullback_resolve_structured", "fk_derivatives",
             "gjk_hull_obstacles"))
