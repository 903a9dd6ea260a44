"""Models past 32 motors and 40 frames on the CPU: K3's plain version at
(65, 64) and (72, 64) against the JAX package's
`rmp_tpu/models/fk_derivatives.fk_derivatives` under vmap (the TPU
kernel's own oracle), the wide kernel's store map on its (72, 64) tile,
the limits the wrappers check before a launch (K1 to n = 64, K3 to 72
frames and 64 motors; meta tensors stand in for the card), K1's
closed-form backward at n = 36 against autograd through its plain
version, and kernel_probe.py's choice of parts. K1 at n = 33, 36, 64
against JAX's kernel body is in test_torch_past_32_k1.py; K3 on four
Pandas, the 33-link arm and a branched tree, and the 33-link arm's
batched tick, in test_torch_past_32_slice.py."""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu.models import fk_derivatives as jfkd
from rmp_tpu.models import specs as jspecs
from rmp_tpu_torch.models import fk_derivatives as fkd
from rmp_tpu_torch.models import specs
from rmp_tpu_torch.ops import cuda_fk, cuda_resolve
from test_torch_fk_wide import NAMES, inputs, planar
from test_torch_grad_kernels import assert_cotangents_close
from test_torch_kinematics import replay_k3_stores
from test_torch_resolve import layout_blocks

torch.set_num_threads(1)

ATOL = 2e-4          # K3: the tolerance of tests/test_pallas_fk.py
K1_RTOL = 1e-4       # K1's backward, as tests/test_torch_grad_kernels.py
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def with_fixed_tail(sp, n_links: int, extra: int):
    """The n_links planar arm of specs module `sp` (the port's or JAX's)
    with `extra` fixed links chained after its EE (chip_smoke's
    fixed_tail_model): n_links + 1 + extra frames, n_links motors."""
    spec = sp.make_planar_arm_spec(n_links)
    links, joints, parent = list(spec.links), list(spec.joints), "ee"
    for k in range(extra):
        links.append(sp.LinkSpec(f"tail_{k}", 0.01))
        joints.append(sp.JointSpec(f"tail_joint_{k}", "fixed", parent,
                                   f"tail_{k}", xyz=(0.01, 0, 0)))
        parent = f"tail_{k}"
    return sp.build_model(dataclasses.replace(
        spec, name=f"{spec.name}_tail{extra}", links=tuple(links),
        joints=tuple(joints)))


def assert_k3_matches_jax(model, jmodel, batch: int = 4):
    """The wrapper on CPU tensors (the plain version, no launch) against
    JAX's fk_derivatives under vmap on the same inputs, each output within
    ATOL x max(1, max |JAX's|)."""
    assert tuple(model.parent) == tuple(jmodel.parent)
    q, qd = inputs(model.n_q, batch=batch)
    want = jax.vmap(lambda a, b: jfkd.fk_derivatives(jmodel, a, b))(
        jnp.asarray(q), jnp.asarray(qd))
    before = cuda_fk.fk_derivatives_batched.launches
    got = cuda_fk.fk_derivatives_batched(model, torch.tensor(q),
                                         torch.tensor(qd))
    assert cuda_fk.fk_derivatives_batched.launches == before
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        err = float(np.abs(g.numpy() - w).max())
        scale = max(1.0, float(np.abs(w).max()))
        print(f"{model.name} {name}: max|port - JAX| {err:.3e} (limit "
              f"{ATOL * scale:.3e})")
        assert err <= ATOL * scale, name


@pytest.mark.parametrize("extra", [0, 7])
def test_plain_k3_matches_jax_on_the_64_link_arm(extra):
    """K3's plain version on the 64-link arm (F = 65, the slice's model)
    and on it with 7 fixed tail links (F = 72, the third tile's capacity),
    both served by the (72, 64) tile, against JAX."""
    model = with_fixed_tail(specs, 64, extra)
    assert (model.n_frames, model.n_q) == (65 + extra, 64)
    assert cuda_fk.tile_of(model) == cuda_fk.TILES[2] == (72, 64, 2)
    assert_k3_matches_jax(model, with_fixed_tail(jspecs, 64, extra))


@pytest.mark.parametrize("n_links, batch", [(33, 3), (64, 2)])
def test_xl_tile_store_map_reassembles_the_outputs(n_links, batch):
    """The wide kernel's stores on the (72, 64) tile (2 envs a CTA, motors
    r + 16 k on lane r for k < 4): every element written once, the plain
    version's outputs reassembled, at n = 33 (one motor past the second
    slot on lane 0 only) and 64 (every slot full)."""
    model = planar(n_links)
    assert cuda_fk.tile_of(model) == (72, 64, 2)
    q, qd = (torch.tensor(x) for x in inputs(n_links, batch=batch))
    got = replay_k3_stores(model, q, qd)
    want = fkd.fk_derivatives(model, q, qd)
    for name, g, w in zip(NAMES, got, want):
        assert not np.isnan(g).any(), name
        np.testing.assert_allclose(g, w.numpy(), atol=ATOL, err_msg=name)


def test_limits_past_32():
    """K1 takes n = 1..64 and at most 32 blocks; K3 takes up to 72 frames
    and 64 motors, the first tile that fits: meta tensors stand in for the
    card, so the limits raise (or pass) before anything is allocated."""
    assert cuda_resolve.KERNEL_N == range(1, 65)
    assert cuda_resolve.MAX_N == 64
    meta = torch.device("meta")
    for n in (33, 36, 48, 49, 64):
        cuda_resolve.check_limits(n, 4, torch.device("cuda"))
        tags, blocks = layout_blocks(n, 4, n, (("dense", 3),
                                               ("identity", 0)))
        fake = [tuple(torch.tensor(x).to(meta) for x in b) for b in blocks]
        with pytest.raises(ValueError, match="no K1 kernel for device meta"):
            cuda_resolve.pullback_resolve_structured(tags, fake)
    with pytest.raises(ValueError, match="takes n from 1 to 64"):
        cuda_resolve.check_limits(65, 4, torch.device("cuda"))
    with pytest.raises(ValueError, match="at most 32 blocks"):
        cuda_resolve.check_limits(64, 33, torch.device("cuda"))
    assert cuda_fk.tile_of(planar(32)) == (40, 32, 4)
    for model in (planar(33), planar(64), with_fixed_tail(specs, 64, 7)):
        assert cuda_fk.tile_of(model) == (72, 64, 2)
        cuda_fk.check_capacity(model)
    for model in (planar(65), with_fixed_tail(specs, 64, 8)):
        with pytest.raises(ValueError, match="72 frames, 64 motors"):
            cuda_fk.check_capacity(model)


def test_k1_backward_at_36():
    """K1's closed-form backward (PullbackResolve: f̄ from the transposed
    solve, then the blocks' products) at n = 36, the CTA kernel's n on the
    card, against autograd through the plain version on the same blocks,
    each cotangent within K1_RTOL x max(1, its largest |entry|)."""
    tags, blocks = layout_blocks(36, 16, 36, (("dense", 3), ("identity", 0),
                                              ("identity", 0),
                                              ("scalar", 20)))
    xbar = np.random.default_rng(9).normal(size=(16, 36)).astype(np.float32)
    leaves = [tuple(torch.tensor(x, requires_grad=True) for x in blk)
              for blk in blocks]
    x = cuda_resolve.pullback_resolve_structured(tags, leaves)
    assert type(x.grad_fn).__name__ == "PullbackResolveBackward"
    flat = [t for blk in leaves for t in blk]
    got = torch.autograd.grad(x, flat, torch.tensor(xbar))
    plain = [tuple(torch.tensor(x, requires_grad=True) for x in blk)
             for blk in blocks]
    y = cuda_resolve.pullback_resolve_structured_plain(tags, plain)
    want = torch.autograd.grad(y, [t for b in plain for t in b],
                               torch.tensor(xbar))
    np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(),
                               atol=0)
    assert_cotangents_close([g.numpy() for g in got],
                            [w.numpy() for w in want], K1_RTOL)


def kernel_probe():
    spec = importlib.util.spec_from_file_location(
        "kernel_probe", os.path.join(ROOT, "kernel_probe.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


PARTS = ["sass", "k3", "k3narrow", "k3tile", "k3ab", "k4", "k5", "k5wide",
         "k5ab", "k1", "k1parts", "k1ab", "k1cta", "k1ctaab", "sassab",
         "host", "traces"]
NEEDS_AGAINST = ["k5ab", "k1ctaab", "sassab"]


def test_kernel_probe_without_parts_skips_those_that_need_against():
    """A run of kernel_probe.py that names no part and gives no --against
    runs every part but those of NEEDS_AGAINST, which it names as skipped
    (it used to raise SystemExit in k5parent before writing anything);
    k5parent is gone."""
    kp = kernel_probe()
    assert "k5parent" not in kp.__doc__ and not hasattr(kp, "K5_PARENT")
    chosen, skipped = kp.choose_parts([], False, PARTS)
    assert skipped == list(kp.NEEDS_AGAINST) == NEEDS_AGAINST
    assert chosen == [p for p in PARTS if p not in NEEDS_AGAINST]
    assert kp.choose_parts([], True, PARTS) == (PARTS, [])
    assert kp.choose_parts(["k1", "k3ab", "k1cta"], False, PARTS) == (
        ["k1", "k3ab", "k1cta"], [])
    for part in NEEDS_AGAINST:
        with pytest.raises(SystemExit, match="need --against"):
            kp.choose_parts([part], False, PARTS)
    with pytest.raises(SystemExit, match="unknown parts"):
        kp.choose_parts(["k5parent"], True, PARTS)


def test_kernel_probe_edit_anchors_match_the_sources():
    """Every edit of kernel_probe.py's variants finds its anchor once in
    this tree's csrc/ (a stale anchor fails its variant on the card)."""
    kp = kernel_probe()
    csrc = os.path.join(ROOT, "rmp_tpu_torch", "csrc")
    tables = [kp.VARIANTS, kp.K3_TILES, kp.K5_WIDE_SPLITS, kp.K1_SPLITS,
              kp.K1_PARTS, kp.K1_AB, kp.K1CTA_SPLITS, kp.K1CTA_AB]
    checked = 0
    for table in tables:
        for source, variants in table.items():
            for name, edits in variants.items():
                for edit in edits or ():
                    target, old, _ = ((source, *edit) if len(edit) == 2
                                      else edit)
                    with open(os.path.join(csrc, target)) as f:
                        assert f.read().count(old) == 1, (source, name,
                                                          target, old)
                    checked += 1
    assert checked >= 20


def test_kernel_probe_names_a_moved_kernel_as_itself():
    """sassab's names: a kernel in an anonymous namespace carries its
    source's name and hashes (and their length), so one moved to another
    source compares under one name; named namespaces are left alone."""
    kp = kernel_probe()
    old = ("_ZN46_GLOBAL__N__ceda65cc_13_fused_tick_cu_01ac950e16fused_qdd_"
           "kernelILi12EEEviiiiii")
    new = ("_ZN49_GLOBAL__N__0badc0de_16_fused_tick_10_cu_12345678"
           "16fused_qdd_kernelILi12EEEviiiiii")
    assert kp.ANON.sub("ANON", old) == kp.ANON.sub("ANON", new)
    warp = ("_ZN6rmp_k157_GLOBAL__N__1e3fbee8_24_pullback_resolve_wide_cu_"
            "aa1c58ed28pullback_resolve_wide_kernelILi12EEEv")
    moved = ("_ZN6rmp_k160_GLOBAL__N__96e54000_27_pullback_resolve_wide_14_"
             "cu_e5f264db28pullback_resolve_wide_kernelILi12EEEv")
    assert kp.ANON.sub("ANON", warp) == kp.ANON.sub("ANON", moved)
    named = "_ZN6rmp_k521fused_qdd_wide_kernelILi24EEEv"
    assert kp.ANON.sub("ANON", named) == named
