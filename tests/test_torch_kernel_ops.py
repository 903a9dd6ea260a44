"""K1, K3 and K4 as opaque torch.library ops (rmp_tpu_torch/ops/library.py)
on the CPU.

- `torch.library.opcheck` of each op: its schema, its fake implementation
  against the CPU one (shapes, strides, dtypes), its registration, and a
  trace through AOT dispatch with dynamic shapes.
- Each op's CPU implementation against the plain version it wraps, bit for
  bit, on the inputs of the existing tests (scene 06's block layout and a
  real scene-06 tick for K1, the Panda and the UR5 for K3, the Panda's
  hull tables for K4).
- Gradients through the wrappers, which call the ops in their autograd
  Functions' forward, unchanged: the K1 and K4 cotangents equal the
  Functions' closed forms applied by hand, the K3 ones autograd through
  the plain version, bit for bit.
- The fake implementations raise where the card's kernels would (meta
  tensors stand in for a device), and a fake call reads no address.
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from rmp_tpu_torch.models import robots
from rmp_tpu_torch.models.fk_derivatives import fk_derivatives
from rmp_tpu_torch.models.hulls import hulls_for
from rmp_tpu_torch.ops import cuda_fk, cuda_gjk, cuda_resolve, library
from test_torch_gjk import KERNEL_ARGS, kernel_operands
from test_torch_grad_kernels import SCENE06, layout_blocks, scene06_tick_blocks

torch.set_num_threads(1)


def k1_inputs(seed=0, B=6, n=9, layout=SCENE06):
    tags, blocks = layout_blocks(seed, B, n, layout)
    return tags, [tuple(torch.tensor(x) for x in b) for b in blocks]


def k1_op_args(tags, blocks, ridge=0.0):
    return ([x for b in blocks for x in b],
            [cuda_resolve.KINDS[t] for t in tags], ridge,
            cuda_resolve.STRUCTURED)


def k3_inputs(model, seed=0, B=5):
    rng = np.random.default_rng(seed)
    q = torch.tensor(rng.uniform(-1, 1, (B, model.n_q)), dtype=torch.float32)
    qd = torch.tensor(rng.uniform(-1, 1, (B, model.n_q)), dtype=torch.float32)
    tab = cuda_fk.model_tables(model, "cpu")
    return q, qd, tuple(tab[k] for k in cuda_fk.TABLES)


def k4_inputs(seed=3, B=16):
    ops = kernel_operands(hulls_for(robots.franka_panda())[:4], seed, B=B)
    return [torch.tensor(ops[k]) for k in KERNEL_ARGS]


def test_opcheck_k1():
    tags, blocks = k1_inputs()
    torch.library.opcheck(library.pullback_resolve_structured,
                          k1_op_args(tags, blocks, 1e-6))


@pytest.mark.parametrize("robot", ["franka_panda", "ur5"])
def test_opcheck_k3(robot):
    model = getattr(robots, robot)()
    q, qd, tables = k3_inputs(model)
    torch.library.opcheck(library.fk_derivatives,
                          (q, qd, *tables, model.n_frames, model.n_q))


def test_opcheck_k4():
    torch.library.opcheck(library.gjk_hull_obstacles, (*k4_inputs(), 4))


@pytest.mark.parametrize("ridge", [0.0, 1e-6])
def test_k1_op_is_the_plain_version_bit_for_bit(ridge):
    for tags, blocks in (k1_inputs(), scene06_tick_blocks()):
        if isinstance(blocks[0][0], np.ndarray):
            blocks = [tuple(torch.tensor(x) for x in b) for b in blocks]
        got = library.pullback_resolve_structured(
            *k1_op_args(tags, blocks, ridge))
        want = cuda_resolve.pullback_resolve_structured_plain(tags, blocks,
                                                              ridge)
        assert torch.equal(got, want)
        assert torch.equal(cuda_resolve.pullback_resolve_structured(
            tags, blocks, ridge=ridge), want)


@pytest.mark.parametrize("robot", ["franka_panda", "ur5", "two_joint_robot"])
def test_k3_op_is_the_plain_version_bit_for_bit(robot):
    model = getattr(robots, robot)()
    q, qd, tables = k3_inputs(model)
    got = library.fk_derivatives(q, qd, *tables, model.n_frames, model.n_q)
    want = fk_derivatives(model, q, qd)
    wrapper = cuda_fk.fk_derivatives_batched(model, q, qd)
    for g, w, x in zip(got, want, wrapper):
        assert torch.equal(g, w) and torch.equal(x, w)


@pytest.mark.parametrize("iters", [1, 4, 10])
def test_k4_op_is_the_plain_version_bit_for_bit(iters):
    args = k4_inputs()
    got = library.gjk_hull_obstacles(*args, iters)
    want = cuda_gjk.gjk_hull_obstacles_plain(*args, iters)
    wrapper = cuda_gjk.gjk_hull_obstacles(*args, iters=iters)
    for g, w, x in zip(got, want, wrapper):
        assert torch.equal(g, w) and torch.equal(x, w)


def test_k1_gradients_are_the_closed_form():
    """The wrapper's cotangents (PullbackResolve, its forward the op) equal
    the closed form applied by hand: f̄ = (A + ridge I)⁻ᵀ x̄ by the
    plain LU, then block_cotangents."""
    tags, blocks = k1_inputs(seed=4)
    leaves = [tuple(x.clone().requires_grad_() for x in b) for b in blocks]
    x = cuda_resolve.pullback_resolve_structured(tags, leaves, ridge=1e-6)
    assert type(x.grad_fn).__name__ == "PullbackResolveBackward"
    xbar = torch.tensor(np.random.default_rng(5).normal(size=x.shape),
                        dtype=torch.float32)
    got = torch.autograd.grad(x, [t for b in leaves for t in b], xbar)
    A, _ = cuda_resolve.assemble_structured(tags, blocks)
    fbar = cuda_resolve.pullback_resolve_structured_plain(
        ("identity",), [(A.transpose(-1, -2), xbar)], 1e-6)
    want = cuda_resolve.block_cotangents(tags, blocks, x.detach(), fbar)
    for g, w in zip(got, [w for b in want for w in b]):
        assert torch.equal(g, w)


def test_k3_gradients_are_the_plain_vjp():
    model = robots.franka_panda()
    q, qd, _ = k3_inputs(model, seed=2)
    rng = np.random.default_rng(6)
    outs = fk_derivatives(model, q, qd)
    cts = [torch.tensor(rng.normal(size=o.shape), dtype=torch.float32)
           for o in outs]
    tq, tqd = q.clone().requires_grad_(), qd.clone().requires_grad_()
    got = torch.autograd.grad(cuda_fk.fk_derivatives_batched(model, tq, tqd),
                              (tq, tqd), cts)
    pq, pqd = q.clone().requires_grad_(), qd.clone().requires_grad_()
    want = torch.autograd.grad(fk_derivatives(model, pq, pqd), (pq, pqd), cts)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k4_gradients_are_the_envelope_rule():
    args = k4_inputs(seed=7)
    leaves = [a.clone().requires_grad_() for a in args]
    pa, pb, dist = cuda_gjk.gjk_hull_obstacles(*leaves)
    assert type(dist.grad_fn).__name__ == "GjkHullObstaclesBackward"
    rng = np.random.default_rng(8)
    cts = [torch.tensor(rng.normal(size=o.shape), dtype=torch.float32)
           for o in (pa, pb, dist)]
    got = torch.autograd.grad((pa, pb, dist), leaves, cts, allow_unused=True)
    verts, R, t, p0, p1, an, radius, is_cyl, d0 = args
    want = cuda_gjk.envelope_cotangents(R, t, p0, p1, pa.detach(),
                                        pb.detach(), dist.detach(), *cts)
    for name, w in zip(("R", "t", "p0", "p1", "radius"), want):
        assert torch.equal(got[KERNEL_ARGS.index(name)], w), name
    for name in ("verts", "an", "is_cyl", "d0"):
        assert got[KERNEL_ARGS.index(name)] is None, name


def test_fake_calls_give_the_shapes_and_read_no_address():
    """Under fake tensors (what the exporter traces with) each op gives
    its outputs' shapes and dtypes, on a CUDA device too."""
    model = robots.franka_panda()
    tags, blocks = k1_inputs()
    q, qd, tables = k3_inputs(model)
    k4 = k4_inputs()
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        for device in (torch.device("cpu"), torch.device("cuda", 0)):
            def fake(x):
                # a fake CUDA tensor needs no card: a meta tensor that
                # reports the device
                return FakeTensor(mode, x.to("meta"), device)
            x = library.pullback_resolve_structured(
                *k1_op_args(tags, [tuple(fake(t) for t in b)
                                   for b in blocks]))
            assert x.shape == (6, 9) and x.device == device
            outs = library.fk_derivatives(
                fake(q), fake(qd), *(fake(t) for t in tables),
                model.n_frames, model.n_q)
            assert [tuple(o.shape) for o in outs] == [
                (5, 12, 16), (5, 12, 16), (5, 12, 16, 9), (5, 12, 16)]
            pa, pb, dist = library.gjk_hull_obstacles(
                *(fake(a) for a in k4), 4)
            assert tuple(dist.shape) == (4, 2, 16)
            assert tuple(pa.shape) == tuple(pb.shape) == (4, 2, 3, 16)


def test_meta_calls_raise_where_the_kernels_would():
    """Off the CPU the fake implementations hold the kernels' limits: K1
    past n = 64, more than 32 blocks, and then no kernel for the meta
    device, before anything is allocated or launched."""
    tags, blocks = k1_inputs(B=2, n=65, layout=(("dense", 2),))
    meta = [tuple(x.to("meta") for x in b) for b in blocks]
    with pytest.raises(ValueError, match="no K1 kernel instantiated for "
                       "n=65"):
        library.pullback_resolve_structured(*k1_op_args(tags, meta))
    tags, blocks = k1_inputs(B=2, n=3, layout=(("dense", 2),) * 33)
    meta = [tuple(x.to("meta") for x in b) for b in blocks]
    with pytest.raises(ValueError, match="at most 32 blocks"):
        library.pullback_resolve_structured(*k1_op_args(tags, meta))
    tags, blocks = k1_inputs(B=2, n=3, layout=(("dense", 2),))
    meta = [tuple(x.to("meta") for x in b) for b in blocks]
    with pytest.raises(ValueError, match="no K1 kernel for device meta"):
        library.pullback_resolve_structured(*k1_op_args(tags, meta))


def test_k3_tables_rebuild_the_model():
    """The CPU implementation walks the model its tables describe: the
    rebuilt model's chains, joint types, motor indices and constants are
    the Panda's, and one model serves every call with those tables."""
    model = robots.franka_panda()
    _, _, tables = k3_inputs(model)
    rebuilt = cuda_fk.model_of_tables(*tables[:5], model.n_q)
    assert rebuilt is cuda_fk.model_of_tables(*tables[:5], model.n_q)
    assert rebuilt.parent == model.parent
    assert rebuilt.joint_type == model.joint_type
    assert rebuilt.q_index == model.q_index
    assert all(rebuilt.chain(f) == model.chain(f)
               for f in range(model.n_frames))
    np.testing.assert_array_equal(rebuilt.T_constant.astype(np.float32),
                                  model.T_constant.astype(np.float32))
