"""K3 past 18 motors: the port's plain FK derivatives (K3's plain version)
on the N-link planar arms at N = 19, 24 and 32 against the JAX package's
`rmp_tpu/models/fk_derivatives.fk_derivatives` under vmap (the TPU
kernel's own oracle), K3's backward at N = 24, the capacity that the
wrapper checks before a launch (40 frames, 32 motors) and its table of
instantiations against the CUDA source's, and the kernel's store map on
the wide tile at an odd n."""
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
from test_torch_kinematics import replay_k3_stores

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
    """41 frames (32 motors) and 33 motors (34 frames) exceed both
    instantiations: check_capacity raises, as the wrapper does on a CUDA
    tensor before it allocates or launches; 40 frames and 32 motors, and
    the models of the narrow tile, fit."""
    for model in (with_fixed_tail(32, 8), planar(33)):
        assert cuda_fk.tile_of(model) is None
        with pytest.raises(ValueError, match="capacity"):
            cuda_fk.check_capacity(model)
    fits = with_fixed_tail(32, 7)
    assert (fits.n_frames, fits.n_q) == (40, 32)
    assert cuda_fk.tile_of(fits) == (40, 32, 4)
    cuda_fk.check_capacity(fits)
    assert cuda_fk.tile_of(planar(18)) == (32, 18, 8)
    assert cuda_fk.tile_of(planar(19)) == (40, 32, 4)
    # the plain version takes any model on the CPU
    q, qd = inputs(33, batch=2)
    out = cuda_fk.fk_derivatives_batched(planar(33), torch.tensor(q),
                                         torch.tensor(qd))
    assert out[2].shape == (2, 34, 16, 33)


def test_tiles_are_the_sources_instantiations():
    """cuda_fk.TILES, which check_capacity reads, is kTiles of
    csrc/fk_derivatives.cu, the table its launcher reads."""
    src = os.path.join(os.path.dirname(cuda_fk.__file__), os.pardir, "csrc",
                       "fk_derivatives.cu")
    with open(src) as f:
        table = re.search(r"constexpr Tile kTiles\[\] = \{(.*)\};",
                          f.read()).group(1)
    tiles = tuple(tuple(int(v) for v in t.split(","))
                  for t in re.findall(r"\{([^{}]*)\}", table))
    assert tiles == cuda_fk.TILES


@pytest.mark.parametrize("n_links,batch", [(19, 5), (24, 6)])
def test_wide_tile_store_map_reassembles_the_outputs(n_links, batch):
    """The store map on the wide tile (4 envs per CTA) at an odd n, where a
    float4 of a J row spans two entries' motor ranges, and at n = 24: every
    element written once, the plain version's outputs reassembled (a full
    tile and a ragged one)."""
    model = planar(n_links)
    q, qd = (torch.tensor(x) for x in inputs(n_links, batch=batch))
    got = replay_k3_stores(model, q, qd)
    want = fkd.fk_derivatives(model, q, qd)
    for name, g, w in zip(NAMES, got, want):
        assert not np.isnan(g).any(), name
        np.testing.assert_allclose(g, w.numpy(), atol=ATOL, err_msg=name)
