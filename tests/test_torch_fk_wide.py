"""K3 past 18 motors: the port's plain FK derivatives (K3's plain version)
on the N-link planar arms at N = 19, 24 and 32 against the JAX package's
`rmp_tpu/models/fk_derivatives.fk_derivatives` under vmap (the TPU
kernel's own oracle), K3's backward at N = 24, the capacity that the
wrapper checks before a launch (40 frames, 32 motors) and its table of
instantiations against the CUDA sources', the wide kernel's store map
(each frame's rows stored as its step ends) at an odd n, and a branched
tree on the wide tile (a revolute branch off a middle link: in BFS order
the two chains interleave, so a frame's parent is not the frame before)
against JAX and through the store map."""
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu.models import fk_derivatives as jfkd
from rmp_tpu.models import specs as jspecs
from rmp_tpu_torch.models import fk_derivatives as fkd
from rmp_tpu_torch.models import specs
from rmp_tpu_torch.ops import cuda_fk
from test_torch_kinematics import CSRC, k3_source_tiles, replay_k3_stores

torch.set_num_threads(1)

B = 8
NAMES = ("T16", "Td16", "J16", "c16")
ATOL = 2e-4          # the tolerance of tests/test_pallas_fk.py
# the backward's cotangents reach ~350 at n = 24: held to ATOL x max(1,
# max |JAX's|), float32 vjps of one closed form summed in other orders
RTOL = 2e-4


def planar(n_links: int):
    return specs.build_model(specs.make_planar_arm_spec(n_links))


def with_fixed_tail(n_links: int, extra: int):
    """The n_links planar arm with `extra` fixed links chained after its EE
    (n_links + 1 + extra frames, n_links motors)."""
    spec = specs.make_planar_arm_spec(n_links)
    links, joints, parent = list(spec.links), list(spec.joints), "ee"
    for k in range(extra):
        links.append(specs.LinkSpec(f"tail_{k}", 0.01))
        joints.append(specs.JointSpec(f"tail_joint_{k}", "fixed", parent,
                                      f"tail_{k}", xyz=(0.01, 0, 0)))
        parent = f"tail_{k}"
    return specs.build_model(dataclasses.replace(
        spec, name=f"{spec.name}_tail{extra}", links=tuple(links),
        joints=tuple(joints)))


def branched(sp, n_links: int = 14, n_branch: int = 6, at: int = 7):
    """The n_links planar arm of specs module `sp` (the port's or JAX's)
    with a branch of n_branch revolute links off link `at`, about y and z
    in turn, the first tilted, and a fixed tip (chip_smoke.branched_model
    at other sizes): n_links + n_branch motors, n_links + n_branch + 2
    frames."""
    spec = sp.make_planar_arm_spec(n_links)
    links, joints, parent = list(spec.links), list(spec.joints), f"link_{at}"
    for k in range(n_branch):
        links.append(sp.LinkSpec(f"branch_{k + 1}", 0.2))
        joints.append(sp.JointSpec(
            f"branch_joint_{k + 1}", "revolute", parent, f"branch_{k + 1}",
            xyz=(0.25, 0.0, 0.1) if k == 0 else (0.3, 0.0, 0.0),
            rpy=(0.3, 0.0, 0.2) if k == 0 else (0.0, 0.0, 0.0),
            axis=(0, 1, 0) if k % 2 == 0 else (0, 0, 1), lower=-np.pi,
            upper=np.pi, velocity=5, effort=50))
        parent = f"branch_{k + 1}"
    links.append(sp.LinkSpec("branch_tip", 0.05))
    joints.append(sp.JointSpec("branch_tip_joint", "fixed", parent,
                               "branch_tip", xyz=(0.3, 0.0, 0.0)))
    return sp.build_model(dataclasses.replace(
        spec, name=f"{spec.name}_branch{n_branch}", links=tuple(links),
        joints=tuple(joints)))


def inputs(n: int, batch: int = B, seed: int = 0):
    rng = np.random.default_rng(seed + n)
    return (rng.uniform(-1.2, 1.2, (batch, n)).astype(np.float32),
            rng.uniform(-1.0, 1.0, (batch, n)).astype(np.float32))


@pytest.mark.parametrize("n_links", [19, 24, 32])
def test_plain_k3_matches_jax_past_18_motors(n_links):
    """The wrapper on CPU tensors (the plain version, no launch) at F = n + 1
    frames against JAX's fk_derivatives under vmap on the same inputs."""
    model = planar(n_links)
    jmodel = jspecs.build_model(jspecs.make_planar_arm_spec(n_links))
    q, qd = inputs(n_links)
    want = jax.vmap(lambda a, b: jfkd.fk_derivatives(jmodel, a, b))(
        jnp.asarray(q), jnp.asarray(qd))
    before = cuda_fk.fk_derivatives_batched.launches
    got = cuda_fk.fk_derivatives_batched(model, torch.tensor(q),
                                         torch.tensor(qd))
    assert cuda_fk.fk_derivatives_batched.launches == before
    assert cuda_fk.tile_of(model) == cuda_fk.TILES[1]
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        err = float(np.abs(g.numpy() - w).max())
        print(f"N={n_links} {name}: max|port - JAX| {err:.3e} (max |JAX| "
              f"{float(np.abs(w).max()):.3e})")
        assert err <= ATOL, name


def test_k3_backward_at_24_motors():
    """K3's autograd Function at n = 24 (its backward, the plain version's
    vjp recomputed) against autograd through the plain version, and against
    JAX's vjp of fk_derivatives, with random cotangents on all four
    outputs."""
    model = planar(24)
    jmodel = jspecs.build_model(jspecs.make_planar_arm_spec(24))
    q, qd = inputs(24, batch=4, seed=7)
    rng = np.random.default_rng(8)
    F, n = model.n_frames, model.n_q
    cts = [rng.normal(size=s).astype(np.float32) for s in
           ((4, F, 16), (4, F, 16), (4, F, 16, n), (4, F, 16))]
    tq = torch.tensor(q, requires_grad=True)
    tqd = torch.tensor(qd, requires_grad=True)
    outs = cuda_fk.fk_derivatives_batched(model, tq, tqd)
    assert all(type(o.grad_fn).__name__ == "FkDerivativesBackward"
               for o in outs)
    got = torch.autograd.grad(outs, (tq, tqd), [torch.tensor(c) for c in cts])
    pq, pqd = (torch.tensor(x, requires_grad=True) for x in (q, qd))
    plain = torch.autograd.grad(fkd.fk_derivatives(model, pq, pqd), (pq, pqd),
                                [torch.tensor(c) for c in cts])
    for g, p in zip(got, plain):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    _, vjp = jax.vjp(jax.vmap(lambda a, b: jfkd.fk_derivatives(jmodel, a, b)),
                     jnp.asarray(q), jnp.asarray(qd))
    for g, w in zip(got, vjp(tuple(jnp.asarray(c) for c in cts))):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max())
        print(f"K3 backward n=24: max|port - JAX| {err:.3e} of "
              f"{float(np.abs(w).max()):.3e}")
        assert err <= RTOL * max(1.0, float(np.abs(w).max()))


def test_capacity_is_checked_before_a_launch():
    """73 frames (64 motors) and 65 motors (66 frames) exceed every
    instantiation: check_capacity raises, as the wrapper does on a CUDA
    tensor before it allocates or launches; 72 frames and 64 motors fit
    the third tile, 40 frames and 32 motors still the wide one, and the
    models of the narrow tile the narrow one."""
    for model in (with_fixed_tail(64, 8), planar(65)):
        assert cuda_fk.tile_of(model) is None
        with pytest.raises(ValueError, match="capacity"):
            cuda_fk.check_capacity(model)
    fits = with_fixed_tail(64, 7)
    assert (fits.n_frames, fits.n_q) == (72, 64)
    assert cuda_fk.tile_of(fits) == (72, 64, 2)
    cuda_fk.check_capacity(fits)
    wide = with_fixed_tail(32, 7)
    assert (wide.n_frames, wide.n_q) == (40, 32)
    assert cuda_fk.tile_of(wide) == (40, 32, 4)
    cuda_fk.check_capacity(wide)
    assert cuda_fk.tile_of(with_fixed_tail(32, 8)) == (72, 64, 2)
    assert cuda_fk.tile_of(planar(33)) == (72, 64, 2)
    assert cuda_fk.tile_of(planar(18)) == (32, 18, 8)
    assert cuda_fk.tile_of(planar(19)) == (40, 32, 4)
    # the plain version takes any model on the CPU
    q, qd = inputs(65, batch=2)
    out = cuda_fk.fk_derivatives_batched(planar(65), torch.tensor(q),
                                         torch.tensor(qd))
    assert out[2].shape == (2, 66, 16, 65)


def source_tile(tile: int, prefix: str, source: str, launch: str):
    """Tile `tile` of cuda_fk.TILES is the wide kernel's capacity and tile
    of the constants kXxxFrames, Motors and Envs of
    csrc/fk_derivatives_wide.cuh (prefix kXxx), instantiated at them in
    `source`, which the launcher reaches through rmp_k3::`launch`."""
    with open(os.path.join(CSRC, "fk_derivatives_wide.cuh")) as f:
        wide = dict(re.findall(rf"constexpr int {prefix}(\w+) = (\d+);",
                               f.read()))
    assert (int(wide["Frames"]), int(wide["Motors"]),
            int(wide["Envs"])) == cuda_fk.TILES[tile]
    with open(os.path.join(CSRC, "fk_derivatives.cu")) as f:
        launcher = f.read()
    assert f"rmp_k3::{launch}(" in launcher
    with open(os.path.join(CSRC, source)) as f:
        assert (f"WideLaunch<{prefix}Frames, {prefix}Motors, "
                f"{prefix}Envs>") in f.read()


def test_tiles_are_the_sources_instantiations():
    """cuda_fk.TILES, which check_capacity reads, is kTiles of
    csrc/fk_derivatives.cu, the table its launcher reads, and its second
    tile is the wide kernel's own capacity and tile
    (csrc/fk_derivatives_wide.cuh, instantiated in fk_derivatives_wide.cu)
    that the launcher hands every model past the first."""
    assert k3_source_tiles() == cuda_fk.TILES
    source_tile(1, "kWide", "fk_derivatives_wide.cu", "launch_wide")


def test_third_tile_is_the_wide_kernel_at_72_frames_64_motors():
    """The third tile of TILES is the wide kernel instantiated again at
    (72, 64) in fk_derivatives_xl.cu, which the launcher hands every model
    past the wide tile."""
    assert cuda_fk.TILES[2] == (72, 64, 2)
    source_tile(2, "kXl", "fk_derivatives_xl.cu", "launch_xl")


@pytest.mark.parametrize("n_links,batch", [(19, 5), (24, 6), ("branched", 6)])
def test_wide_tile_store_map_reassembles_the_outputs(n_links, batch):
    """The wide kernel's stores (4 envs per CTA, each frame's rows as its
    step ends, J by motor lanes r and r + 16) at an odd n, where lane r's
    second motor exists for r < 3 only, at n = 24 and on the branched tree:
    every element written once, the plain version's outputs reassembled
    (a full tile and a ragged one)."""
    model = (branched(specs) if n_links == "branched"
             else planar(n_links))
    n_links = model.n_q
    q, qd = (torch.tensor(x) for x in inputs(n_links, batch=batch))
    got = replay_k3_stores(model, q, qd)
    want = fkd.fk_derivatives(model, q, qd)
    for name, g, w in zip(NAMES, got, want):
        assert not np.isnan(g).any(), name
        np.testing.assert_allclose(g, w.numpy(), atol=ATOL, err_msg=name)


def test_branched_tree_on_the_wide_tile_matches_jax():
    """K3's plain version (the wrapper on CPU tensors) on the branched
    tree (F = 22, n = 20) against JAX's fk_derivatives under vmap on the
    same inputs: the tree reaches the wide tile, and past the branch a
    frame's parent is not the frame before it."""
    model, jmodel = branched(specs), branched(jspecs)
    assert (model.n_frames, model.n_q) == (22, 20)
    assert cuda_fk.tile_of(model) == cuda_fk.TILES[1]
    assert any(p != f - 1 for f, p in enumerate(model.parent))
    assert model.parent == tuple(jmodel.parent)
    q, qd = inputs(model.n_q)
    want = jax.vmap(lambda a, b: jfkd.fk_derivatives(jmodel, a, b))(
        jnp.asarray(q), jnp.asarray(qd))
    got = cuda_fk.fk_derivatives_batched(model, torch.tensor(q),
                                         torch.tensor(qd))
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        err = float(np.abs(g.numpy() - w).max())
        print(f"branched {name}: max|port - JAX| {err:.3e} (max |JAX| "
              f"{float(np.abs(w).max()):.3e})")
        assert err <= ATOL, name
