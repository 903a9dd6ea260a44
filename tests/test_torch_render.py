"""The port's renderers and animation capture (rmp_tpu_torch/utils/
native.py, utils/render.py, models/meshes.py, Simulation's capture,
experiments/make_gifs.py) on the CPU: tests/test_subsystems.py's renderer
cases on the port's own frames -- each drawn (not uniform) and of the asked
shape, the hull and visual geometries on every robot with the asset, flat
cylinder caps, the BVH tracer's geometry -- the GIF writer decoded by PIL
and equal to the frames under its palette, and the native library built
from native/tinyrender.cpp into rmp_tpu_torch/_build/ without a write
into native/."""
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from rmp_tpu_torch.envs.franka import cluttered_obstacles
from rmp_tpu_torch.experiments import make_gifs
from rmp_tpu_torch.models import robots
from rmp_tpu_torch.models.meshes import _vertex_normals, visual_meshes_for
from rmp_tpu_torch.sim.world import init_state
from rmp_tpu_torch.utils import native, render

torch.set_num_threads(1)

NATIVE_DIR = os.path.join(os.path.dirname(native.SOURCE))


def drawn(frame: np.ndarray) -> bool:
    return frame.reshape(-1, 3).std(0).mean() > 1.0


@pytest.fixture(scope="module")
def built():
    """The native library, built (needs g++, which the CPU host has)."""
    assert shutil.which("g++"), "the CPU host needs g++ for these tests"
    before = sorted(os.listdir(NATIVE_DIR))
    path = native.build()
    assert path.startswith(os.path.abspath(native.BUILD_DIR))
    assert sorted(os.listdir(NATIVE_DIR)) == before
    return path


def panda_state():
    model = robots.franka_panda()
    return model, init_state(model, 1, "cpu", q=robots.PANDA_Q_READY,
                             obstacles=cluttered_obstacles("cpu"),
                             goal=[0.2, -0.2, 0.5])


def test_matplotlib_renderer():
    model = robots.two_joint_robot()
    state = init_state(model, 1, "cpu", q=[0.3, -0.5], goal=[1.0, 1.0, 0.1])
    frame = render.render_scene(model, state)
    assert frame.ndim == 3 and frame.shape[2] == 3
    assert frame.dtype == np.uint8 and drawn(frame)


def test_native_renderer(built):
    model, state = panda_state()
    frame = native.render_scene_native(model, state, width=64, height=48)
    assert frame.shape == (48, 64, 3) and drawn(frame)
    got, name = render.render_frame(model, state)
    assert name == "native" and drawn(got)


def test_native_renderer_hull_geometry(built):
    """geometry='hull' draws each robot with a hull asset as its convex
    hulls: drawn, and apart from the capsule frame only in the thin
    capsule-against-hull silhouette band."""
    for maker, q, obs in (
            (robots.franka_panda, robots.PANDA_Q_READY,
             cluttered_obstacles("cpu")),
            (robots.ur5, None, None), (robots.two_joint_robot, None, None)):
        model = maker()
        q = np.zeros(model.n_q, np.float32) if q is None else q
        state = init_state(model, 1, "cpu", q=q, obstacles=obs)
        hull = native.render_scene_native(model, state, width=96, height=72,
                                          geometry="hull")
        cap = native.render_scene_native(model, state, width=96, height=72)
        assert hull.shape == (72, 96, 3) and drawn(hull)
        diff = (np.abs(hull.astype(int) - cap.astype(int)).sum(-1) > 10)
        assert 0.0 < diff.mean() < 0.25, model.name


def test_native_renderer_visual_meshes(built):
    model, state = panda_state()
    meshes, instances = visual_meshes_for(model)
    assert len(meshes) == 11 and len(instances) == 11
    assert sorted(f for _, f in instances)[0] == -1
    assert sum(f >= 0 for _, f in instances) == 10
    for m in meshes:
        used = np.unique(m["tris"])
        n = np.linalg.norm(m["normals"][used], axis=-1)
        assert (np.abs(n - 1.0) < 1e-3).mean() > 0.999
    vis = native.render_scene_native(model, state, width=96, height=72,
                                     geometry="visual")
    cap = native.render_scene_native(model, state, width=96, height=72)
    assert vis.shape == (72, 96, 3) and drawn(vis)
    diff = (np.abs(vis.astype(int) - cap.astype(int)).sum(-1) > 10)
    assert 0.0 < diff.mean() < 0.25
    _, dual_inst = visual_meshes_for(robots.dual_panda())
    assert len(dual_inst) == 22 and all(f >= 0 for _, f in dual_inst)


def test_native_cylinder_rows_flat_caps(built):
    cam = np.array([1.5, -1.5, 0.8, 0.0, 0.0, 0.4, 45.0], np.float32)
    caps = np.asarray([[0.0, 0.0, 0.15, 0.0, 0.0, 0.65, 0.12, 0.3, 0.3,
                        0.9]], np.float32)
    cyl = caps.copy()
    cyl[0, 6] = -cyl[0, 6]

    def prim_px(im):
        return int((im[..., 2].astype(int) > im[..., 0].astype(int) + 30)
                   .sum())
    img_cap = native.render_capsules(caps, cam, 160, 120)
    img_cyl = native.render_capsules(cyl, cam, 160, 120)
    assert 0 < prim_px(img_cyl) < prim_px(img_cap)


def test_native_mesh_ray_trace_geometry(built):
    """A unit cube at a known pose shades the image centre with its
    instance colour and leaves a corner as sky."""
    v = np.array([[x, y, z] for x in (-.5, .5) for y in (-.5, .5)
                  for z in (-.5, .5)], np.float32)
    tris = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                     [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                     [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    pack = dict(verts=v, normals=_vertex_normals(v, tris).astype(np.float32),
                tris=tris, v_off=np.array([0, 8], np.int32),
                t_off=np.array([0, 12], np.int32),
                inst_mesh=np.array([0], np.int32),
                inst_color=np.array([[1.0, 0.1, 0.1]], np.float32))
    pose = np.array([[1, 0, 0, 0, 1, 0, 0, 0, 1, 0.0, 0.0, 0.5]],
                    np.float32)
    cam = np.array([3.0, 0.0, 0.5, 0.0, 0.0, 0.5, 40.0], np.float32)
    img = native.render_meshes(np.zeros((0, 10), np.float32), pack, pose,
                               cam, 64, 48)
    centre, corner = img[24, 32].astype(int), img[0, 0].astype(int)
    assert centre[0] > centre[1] + 30 and centre[0] > centre[2] + 30
    assert not (corner[0] > corner[1] + 30)


def test_gif_writer_decodes_to_the_frames_under_its_palette(tmp_path):
    """save_gif without PIL: PIL reads every frame back as the frame's
    palette colours (noise frames fill the LZW table and restart it),
    with the delay of the fps and a loop."""
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
              for _ in range(3)]
    frames += [np.zeros((60, 80, 3), np.uint8),
               np.tile(np.linspace(0, 255, 80, dtype=np.uint8)[None, :, None],
                       (60, 1, 3))]
    path = str(tmp_path / "f.gif")
    render.save_gif(frames, path, fps=16)
    im = Image.open(path)
    assert im.n_frames == len(frames) and im.info["loop"] == 0
    assert im.info["duration"] == 60
    for i, f in enumerate(frames):
        im.seek(i)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")),
                                      render.PALETTE[render.quantize(f)])
    assert np.abs(render.PALETTE[render.quantize(frames[4])].astype(int)
                  - frames[4]).max() <= 43


def test_make_gifs_writes_a_gif(built, tmp_path):
    rec = make_gifs.make_gif("two_joint/01_target_rmp_only", 6, 2,
                             "capsule", str(tmp_path), "cpu")
    assert rec["renderer"] == "native" and rec["frames"] == 3
    assert Image.open(rec["path"]).n_frames == 3
    assert rec["path"].startswith(str(tmp_path))
    with pytest.raises(ValueError):
        make_gifs.make_gif("two_joint/01_target_rmp_only", 2, 2, "capsule",
                           os.path.join(make_gifs.REPORT_DIR, os.pardir,
                                        "reports"), "cpu")
