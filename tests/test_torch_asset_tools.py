"""The port's asset tools (rmp_tpu_torch/experiments/fit_hulls.py,
fit_capsules.py, collision_mesh_error.py, pack_visual_meshes.py) against
the JAX package's scripts (experiments/*.py), on meshes the test writes:
OBJ boxes and cylinders (quads and n-gons, so fan triangulation is held),
one per mesh file the tools read, and a three-link URDF.

- The copied numpy helpers equal the scripts' bit for bit: load_obj,
  surface_samples, point_segment_dist, signed_dist_to_capsules,
  fibonacci_directions, kmeans, init_capsules, hull_planes, parse_obj,
  _rpy_matrix; decimate_hull picks the same vertices.
- pack_visual_meshes on the URDF gives the script's arrays.
- fit_link's 20 Adam steps (torch.optim, float32) against the script's
  (optax under jit): the capsules within 1e-4 m. The two round apart; at
  20 steps of lr 3e-3 they part by up to 3.2e-7 m (measured on the CPU
  host).
- collision_mesh_error's sampled errors on 64 configurations and
  obstacles, the port's capsule query and mesh oracle against JAX's
  robot_obstacle_distances and the script's numpy oracle: within 1e-5
  (1.2e-7 m measured).
- The tools write where they are told and refuse reports/, and stop
  without --meshes (--urdf): they read no default path.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmp_tpu.models import kinematics as JK
from rmp_tpu.models import robots as jrobots
from rmp_tpu.sim import collision as jcollision
from rmp_tpu_torch.experiments import collision_mesh_error as cme
from rmp_tpu_torch.experiments import fit_capsules, fit_hulls
from rmp_tpu_torch.experiments import pack_visual_meshes as pvm
from rmp_tpu_torch.models import robots

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the scripts import each other by bare name from experiments/
sys.path.insert(0, os.path.join(ROOT, "experiments"))
try:
    import collision_mesh_error as jcme  # noqa: E402
    import fit_capsules as jfc  # noqa: E402
    import fit_hulls as jfh  # noqa: E402
    import pack_visual_meshes as jpvm  # noqa: E402
finally:
    sys.path.remove(os.path.join(ROOT, "experiments"))

torch.set_num_threads(1)


def box(lo, hi):
    """An OBJ box of quads."""
    (x0, y0, z0), (x1, y1, z1) = lo, hi
    v = [(x, y, z) for x in (x0, x1) for y in (y0, y1) for z in (z0, z1)]
    f = [(1, 2, 4, 3), (5, 7, 8, 6), (1, 5, 6, 2), (3, 4, 8, 7),
         (1, 3, 7, 5), (2, 6, 8, 4)]
    return v, f


def cylinder(r, h, z0=0.0, n=12, x0=0.0):
    """An OBJ cylinder: quads around, n-gons for the caps, a vertex/normal
    index form on the faces."""
    ang = 2 * np.pi * np.arange(n) / n
    v = [(x0 + r * np.cos(a), r * np.sin(a), z) for z in (z0, z0 + h)
         for a in ang]
    f = [(i + 1, (i + 1) % n + 1, (i + 1) % n + n + 1, i + n + 1)
         for i in range(n)]
    f += [tuple(range(n, 0, -1)), tuple(range(n + 1, 2 * n + 1))]
    return v, f


def write_obj(path, mesh):
    v, f = mesh
    with open(path, "w") as out:
        out.write("# test mesh\n")
        for p in v:
            out.write("v %.6f %.6f %.6f\n" % p)
        out.write("vn 0 0 1\n")
        for face in f:
            out.write("f " + " ".join(f"{i}//1" for i in face) + "\n")


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """A directory of the collision OBJs the tools read."""
    d = tmp_path_factory.mktemp("meshes")
    shapes = {f"link{i}.obj": cylinder(0.05 + 0.005 * i, 0.12 + 0.01 * i,
                                       -0.06, x0=0.01 * i)
              for i in range(1, 8)}
    shapes["hand.obj"] = box((-0.03, -0.1, 0.0), (0.03, 0.1, 0.06))
    shapes["finger.obj"] = box((-0.01, 0.0, 0.0), (0.01, 0.02, 0.05))
    for name, mesh in shapes.items():
        write_obj(d / name, mesh)
    return str(d)


def test_numpy_helpers_equal_the_scripts(meshes):
    model = robots.franka_panda()
    for link in cme.MESH_OF_LINK:
        fname = cme.MESH_OF_LINK[link][0]
        got = cme.load_obj(os.path.join(meshes, fname))
        want = jcme.load_obj(os.path.join(meshes, fname))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(cme.surface_samples(*got),
                                      jcme.surface_samples(*want))
    pts = cme.surface_samples(*cme.link_mesh(meshes, "panda_link3"))
    caps = model.collision[model.frame_index("panda_joint3")]
    np.testing.assert_array_equal(cme.signed_dist_to_capsules(pts, caps),
                                  jcme.signed_dist_to_capsules(pts, caps))
    rng = np.random.default_rng(0)
    p, s0, s1 = rng.normal(size=(4, 50, 3)), *rng.normal(size=(2, 4, 3))
    np.testing.assert_array_equal(cme.point_segment_dist(p, s0, s1),
                                  jcme.point_segment_dist(p, s0, s1))
    np.testing.assert_array_equal(fit_hulls.fibonacci_directions(300),
                                  jfh.fibonacci_directions(300))
    for k in (1, 2, 3):
        for g, w in zip(fit_capsules.kmeans(pts.copy(), k),
                        jfc.kmeans(pts.copy(), k)):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(fit_capsules.init_capsules(pts, k),
                                      jfc.init_capsules(pts, k))
    for g, w in zip(fit_capsules.hull_planes(pts), jfc.hull_planes(pts)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(pvm._rpy_matrix((0.3, -1.1, 2.0)),
                                  jpvm._rpy_matrix((0.3, -1.1, 2.0)))


@pytest.mark.parametrize("max_verts", [8, 16, 96])
def test_decimate_hull_picks_the_same_vertices(meshes, max_verts):
    dirs = fit_hulls.fibonacci_directions(512)
    for link in ("panda_link2", "panda_hand", "panda_rightfinger"):
        verts, _ = cme.link_mesh(meshes, link)
        sub, err = fit_hulls.decimate_hull(verts, max_verts, dirs)
        want, want_err = jfh.decimate_hull(verts, max_verts, dirs)
        np.testing.assert_array_equal(sub, want)
        assert err == want_err


def test_fit_hulls_writes_where_told(meshes, tmp_path):
    out = tmp_path / "hulls.npz"
    assert fit_hulls.main(["--meshes", meshes, "--max-verts", "16",
                           "--dirs", "256", "--out", str(out)]) == 0
    tables = np.load(out)
    assert sorted(tables.files) == sorted(cme.MESH_OF_LINK)
    assert (tmp_path / "hull_fit.json").exists()
    with pytest.raises(ValueError, match="may not overwrite"):
        fit_hulls.main(["--meshes", meshes, "--out",
                        os.path.join(ROOT, "reports", "hull_fit.json")])


def test_pack_visual_meshes_equals_the_script(tmp_path):
    (tmp_path / "meshes").mkdir()
    write_obj(tmp_path / "meshes" / "base.obj",
              box((-0.1, -0.1, 0.0), (0.1, 0.1, 0.05)))
    write_obj(tmp_path / "meshes" / "arm.obj", cylinder(0.04, 0.3))
    urdf = tmp_path / "robot.urdf"
    urdf.write_text("""<robot name="test">
  <link name="base"><visual><origin xyz="0 0 0.01" rpy="0 0 0.5"/>
    <geometry><mesh filename="meshes/base.obj"/></geometry></visual></link>
  <link name="arm"><visual><origin xyz="0.1 0 0" rpy="0.2 -0.4 1.0"/>
    <geometry><mesh filename="package://meshes/arm.obj"/></geometry>
  </visual></link>
  <link name="tip"/>
  <joint name="j1" type="revolute"><parent link="base"/><child link="arm"/>
  </joint>
  <joint name="j2" type="fixed"><parent link="arm"/><child link="tip"/>
  </joint>
</robot>""")
    got = pvm.pack(str(urdf), log=lambda _: None)
    argv = sys.argv
    sys.argv = ["pack_visual_meshes.py", "--urdf", str(urdf), "--out",
                str(tmp_path / "want.npz")]
    try:
        jpvm.main()
    finally:
        sys.argv = argv
    want = np.load(tmp_path / "want.npz")
    assert sorted(got) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    for g, w in zip(pvm.parse_obj(str(tmp_path / "meshes" / "arm.obj")),
                    jpvm.parse_obj(str(tmp_path / "meshes" / "arm.obj"))):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [1, 2])
def test_fit_link_follows_the_scripts_adam(meshes, k):
    pts = cme.surface_samples(*cme.link_mesh(meshes, "panda_link4"))
    caps, dev, bulge = fit_capsules.fit_link(pts, k, steps=20)
    want, want_dev, want_bulge = jfc.fit_link(pts, k, steps=20)
    err = float(np.abs(caps - want).max())
    print(f"fit_link k={k}, 20 steps: max |port - JAX| {err:.3e} m")
    assert err < 1e-4
    assert abs(float(dev.max()) - float(want_dev.max())) < 1e-4
    assert abs(bulge - want_bulge) < 1e-4


def test_sampled_errors_equal_jax_on_the_same_problem(meshes):
    """64 configurations and one capsule obstacle each (the port's
    sample_problem), through the port's capsule query and mesh oracle and
    through JAX's robot_obstacle_distances under vmap and the script's
    numpy oracle."""
    model = robots.franka_panda()
    link_pts = {f: cme.surface_samples(*cme.link_mesh(
        meshes, model.link_names[f])) for f in model.collision_frames}
    q, obstacles = cme.sample_problem(model, 64, 3, "cpu")
    d_ours, d_mesh, _ = cme.sampled_errors(model, link_pts, q, obstacles)
    got = (d_ours - d_mesh).numpy()

    jmodel = jrobots.franka_panda()

    @jax.jit
    @jax.vmap
    def jax_ours(qq, p0, p1, r):
        T_all = JK.fk_all(jmodel, qq)
        d = jcollision.robot_obstacle_distances(
            jmodel, T_all, jcollision.ObstacleSet(p0, p1, r))[3]
        return d[:, 0], T_all

    p0, p1, r = (x.numpy() for x in (obstacles.p0, obstacles.p1,
                                      obstacles.radius))
    jd, jT = jax_ours(jnp.asarray(q.numpy()), jnp.asarray(p0),
                      jnp.asarray(p1), jnp.asarray(r))
    jT = np.asarray(jT, np.float64)
    want = np.empty_like(got)
    for li, f in enumerate(model.collision_frames):
        T = jT[:, f]
        world = np.einsum("cij,nj->cni", T[:, :3, :3], link_pts[f]) \
            + T[:, None, :3, 3]
        want[:, li] = (jcme.point_segment_dist(world, p0[:, 0], p1[:, 0])
                       - r[:, 0][:, None]).min(axis=1)
    want = np.asarray(jd, np.float64) - want
    err = float(np.abs(got - want).max())
    print(f"sampled errors: max |port - JAX| {err:.3e} m")
    assert err < 1e-5


def test_collision_mesh_error_report(meshes, tmp_path):
    out = tmp_path / "cme.json"
    assert cme.main(["--cpu", "--configs", "16", "--meshes", meshes,
                     "--out", str(out), "--geometry", "hull"]) == 0
    import json
    report = json.loads(out.read_text())
    assert report["configs"] == 16 and report["geometry"] == "hull"
    assert set(report["per_link_surface_deviation"]) == set(
        cme.MESH_OF_LINK)
    assert report["gjk_solver_error_vs_hull_oracle"]["separated_pairs"] > 0


@pytest.mark.parametrize("tool,flag", [
    (cme, "--meshes"), (fit_hulls, "--meshes"), (fit_capsules, "--meshes"),
    (pvm, "--urdf")])
def test_mesh_tools_need_their_files_named(tool, flag, capsys):
    """No tool reads a default path outside the checkout: without --meshes
    (or --urdf) it stops and says where the reference keeps the files."""
    with pytest.raises(SystemExit) as exc:
        tool.main(["--out", "unused.json"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"{flag} is required" in err
    assert "urdf/franka_panda" in err and "ROADMAP Queue 1" in err
