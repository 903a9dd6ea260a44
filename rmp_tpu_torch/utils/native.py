"""ctypes bindings of the native C++ ray tracer (native/tinyrender.cpp).

The port's `rmp_tpu/utils/native.py`, the counterpart of the reference's
PyBullet TinyRenderer camera frames (simulation.py:296-300). At first use
g++ builds native/tinyrender.cpp into rmp_tpu_torch/_build/<hash>/
libtinyrender.so (keyed by a hash of the source and the flags; native/ is
never written), and ctypes loads it. `available()` says whether a C++
compiler is there (or the library built); where one is and the build
fails, the build raises. Frames are numpy (H, W, 3) uint8 of one env of a
batched SimState (row `env`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, os.pardir, os.pardir, "native", "tinyrender.cpp")
BUILD_DIR = os.path.join(_HERE, os.pardir, "_build")
FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall",
         "-fopenmp")
_ROBOT_RGB = (0.85, 0.85, 0.88)    # visual meshes: the reference's white

_lock = threading.Lock()
_LIB = None
_PLANE_CACHE: dict = {}
_MESH_CACHE: dict = {}


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.abspath(os.path.join(BUILD_DIR, h.hexdigest()[:16],
                                        "libtinyrender.so"))


def available() -> bool:
    """Whether the native renderer can be had: built already, or a C++
    compiler on PATH to build it."""
    return os.path.exists(library_path()) or shutil.which("g++") is not None


def _exports(symbol: str) -> bool:
    """Whether the library, built or loaded on demand, exports `symbol`:
    False where it cannot be built (no g++) or loaded."""
    try:
        return hasattr(_load(), symbol)
    except (OSError, RuntimeError):
        return False


def hulls_available() -> bool:
    """The exact-hull renderer (rmp_render_frame_hulls) is there."""
    return _exports("rmp_render_frame_hulls")


def meshes_available() -> bool:
    """The visual-mesh renderer (rmp_render_frame_meshes) is there."""
    return _exports("rmp_render_frame_meshes")


def cylinder_rows_available() -> bool:
    """The renderer draws flat-capped cylinder rows (rmp_has_cylinder_rows)."""
    return _exports("rmp_has_cylinder_rows")


def build() -> str:
    """Build the library unless this source is built; returns its path.
    Raises where g++ is missing or fails. The library is moved into place
    whole, so processes building at once do not read each other's halves."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native renderer cannot be "
                           "built")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    out = subprocess.run([cxx, *FLAGS, "-o", tmp, SOURCE],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if out.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed:\n{out.stdout}")
    os.replace(tmp, path)
    return path


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _load():
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(build())
        f, i, u8 = (ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_uint8))
        c_int = ctypes.c_int
        lib.rmp_render_frame.argtypes = [f, c_int, f, c_int, c_int, u8]
        lib.rmp_render_frame_hulls.argtypes = [f, c_int, f, i, f, c_int, f,
                                               c_int, c_int, u8]
        lib.rmp_render_frame_meshes.argtypes = [
            f, c_int,            # capsules
            f, f, i, i, i, c_int,  # verts, normals, tris, v_off, t_off, n
            i, f, f, c_int,      # inst_mesh, inst_pose, color, n
            f, c_int, c_int, u8]
        for fn in (lib.rmp_render_frame, lib.rmp_render_frame_hulls,
                   lib.rmp_render_frame_meshes):
            fn.restype = None
        _LIB = lib
        return lib


def _camera(camera: np.ndarray) -> np.ndarray:
    cam = np.ascontiguousarray(camera, dtype=np.float32)
    if cam.shape != (7,):
        raise ValueError(f"camera must be (eye xyz, target xyz, fov), got "
                         f"{cam.shape}")
    return cam


def _rows(capsules) -> np.ndarray:
    caps = np.ascontiguousarray(capsules, dtype=np.float32).reshape(-1, 10)
    return caps


def render_capsules(capsules: np.ndarray, camera: np.ndarray,
                    width: int = 320, height: int = 240) -> np.ndarray:
    """Ray-trace capsules [(p0 xyz, p1 xyz, radius, rgb) x N] (a negative
    radius: a flat-capped cylinder) from a camera [eye xyz, target xyz,
    fov_deg] -> (H, W, 3) uint8."""
    lib = _load()
    caps, cam = _rows(capsules), _camera(camera)
    out = np.empty((height, width, 3), dtype=np.uint8)
    lib.rmp_render_frame(_fp(caps), len(caps), _fp(cam), width, height,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def render_hulls(capsules: np.ndarray, planes: np.ndarray,
                 counts: np.ndarray, colors: np.ndarray, camera: np.ndarray,
                 width: int = 320, height: int = 240) -> np.ndarray:
    """Ray-trace capsules and convex polytopes: planes, the hulls' world
    half-space rows [n xyz, d] (inside: n.x <= d) one after another,
    counts the rows of each hull, colors (n_hulls, 3)."""
    lib = _load()
    caps, cam = _rows(capsules), _camera(camera)
    pl = np.ascontiguousarray(planes, dtype=np.float32)
    cnt = np.ascontiguousarray(counts, dtype=np.int32)
    col = np.ascontiguousarray(colors, dtype=np.float32)
    if pl.ndim != 2 or pl.shape[1] != 4 or pl.shape[0] != cnt.sum() \
            or col.shape != (len(cnt), 3):
        raise ValueError(f"planes {pl.shape}, counts summing to {cnt.sum()}, "
                         f"colors {col.shape} do not fit")
    out = np.empty((height, width, 3), dtype=np.uint8)
    lib.rmp_render_frame_hulls(
        _fp(caps), len(caps), _fp(pl), _ip(cnt), _fp(col), len(cnt),
        _fp(cam), width, height,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def render_meshes(capsules: np.ndarray, scene_pack: dict,
                  inst_pose: np.ndarray, camera: np.ndarray,
                  width: int = 320, height: int = 240) -> np.ndarray:
    """Ray-trace capsules and rigid triangle-mesh instances: scene_pack the
    concatenated mesh library of _visual_scene, inst_pose (n_inst, 12)
    [R row-major | t] world poses."""
    lib = _load()
    caps, cam = _rows(capsules), _camera(camera)
    pose = np.ascontiguousarray(inst_pose, dtype=np.float32)
    if pose.ndim != 2 or pose.shape != (len(scene_pack["inst_mesh"]), 12):
        raise ValueError(f"inst_pose {pose.shape} does not fit the scene's "
                         f"{len(scene_pack['inst_mesh'])} instances")
    out = np.empty((height, width, 3), dtype=np.uint8)
    lib.rmp_render_frame_meshes(
        _fp(caps), len(caps),
        _fp(scene_pack["verts"]), _fp(scene_pack["normals"]),
        _ip(scene_pack["tris"]), _ip(scene_pack["v_off"]),
        _ip(scene_pack["t_off"]), len(scene_pack["v_off"]) - 1,
        _ip(scene_pack["inst_mesh"]), _fp(pose),
        _fp(scene_pack["inst_color"]), len(pose),
        _fp(cam), width, height,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def _visual_scene(model):
    """The concatenated mesh library of the robot's visual meshes
    (models/meshes.py) for render_meshes, with each instance's frame (-1:
    the base, at the identity), or None without a visual asset."""
    key = (model.name, tuple(model.link_names))
    if key in _MESH_CACHE:
        return _MESH_CACHE[key]
    from rmp_tpu_torch.models.meshes import visual_meshes_for
    loaded = visual_meshes_for(model)
    pack = None
    if loaded is not None:
        meshes, instances = loaded
        v_off = np.cumsum([0] + [len(m["verts"]) for m in meshes])
        t_off = np.cumsum([0] + [len(m["tris"]) for m in meshes])
        pack = dict(
            verts=np.ascontiguousarray(
                np.concatenate([m["verts"] for m in meshes]), np.float32),
            normals=np.ascontiguousarray(
                np.concatenate([m["normals"] for m in meshes]), np.float32),
            tris=np.ascontiguousarray(
                np.concatenate([m["tris"] for m in meshes]), np.int32),
            v_off=v_off.astype(np.int32), t_off=t_off.astype(np.int32),
            inst_mesh=np.asarray([m for m, _ in instances], np.int32),
            inst_frame=np.asarray([f for _, f in instances], np.int32),
            inst_color=np.ascontiguousarray(np.tile(
                np.asarray([_ROBOT_RGB], np.float32), (len(instances), 1))))
    _MESH_CACHE[key] = pack
    return pack


def _hull_planes_local(model):
    """Per collision link, its hull's local half-space rows [(F_i, 4)
    n | d] from the hull asset (models/hulls.py), or None without one; the
    hulls are rigid, so the planes are computed once."""
    key = (model.name, tuple(model.collision_frames))
    if key in _PLANE_CACHE:
        return _PLANE_CACHE[key]
    from rmp_tpu_torch.models.hulls import hulls_for
    verts = hulls_for(model)
    planes = None
    if verts is not None:
        from scipy.spatial import ConvexHull
        planes = []
        for v in np.asarray(verts, np.float64):
            eq = ConvexHull(v, qhull_options="QJ").equations  # QJ: joggle
            # qhull: n.x + b <= 0 inside  ->  n.x <= d with d = -b
            planes.append(np.concatenate([eq[:, :3], -eq[:, 3:4]],
                                         axis=-1).astype(np.float32))
    _PLANE_CACHE[key] = planes
    return planes


def render_scene_native(model, state, goal=None, camera=None,
                        width: int = 320, height: int = 240,
                        geometry: str = "capsule", env: int = 0
                        ) -> np.ndarray:
    """The frame of env `env` of a batched SimState: the robot's capsules,
    the obstacles (cylinders flat-capped), the goal. camera: dict(eye,
    target, fov) or None for the default view. geometry 'hull' draws the
    links as their convex hulls (models/hulls.py), 'visual' as the
    reference's visual meshes (models/meshes.py); each falls back to the
    capsules where the robot has no such asset."""
    from rmp_tpu_torch.models import kinematics as K
    from rmp_tpu_torch.sim.collision import link_world_capsules_all

    q = state.q[env:env + 1]
    T_b = K.fk_all(model, q)
    T_all = T_b[0].detach().cpu().numpy()
    mesh_pack = _visual_scene(model) if geometry == "visual" else None
    hull_planes = hull_counts = None
    if geometry == "hull":
        local = _hull_planes_local(model)
        if local is not None:
            # n.x_loc <= d with x_loc = R^T (x - t): (R n).x <= d + (R n).t
            hull_planes, hull_counts = [], []
            for f, pl in zip(model.collision_frames, local):
                R, t = T_all[f, :3, :3], T_all[f, :3, 3]
                n_w = pl[:, :3] @ R.T
                hull_planes.append(np.concatenate(
                    [n_w, (pl[:, 3] + n_w @ t)[:, None]], axis=-1))
                hull_counts.append(len(pl))
    rows = []
    if hull_planes is None and mesh_pack is None:
        p0, p1, radius, _ = link_world_capsules_all(model, T_b)
        for a, b, r in zip(p0[0].detach().cpu().numpy(),
                           p1[0].detach().cpu().numpy(),
                           radius.detach().cpu().numpy()):
            rows.append([*a, *b, r, 0.25, 0.45, 0.8])       # robot: blue
    obs = state.obstacles
    if obs is not None:
        kinds = obs.kinds
        for k, (a, b, r) in enumerate(zip(*(
                (x if x.dim() == nd else x[env]).detach().cpu().numpy()
                for x, nd in ((obs.p0, 2), (obs.p1, 2), (obs.radius, 1))))):
            # a negative radius tags a flat-capped cylinder
            rr = -r if kinds is not None and kinds[k] == "cylinder" else r
            rows.append([*a, *b, rr, 0.35, 0.35, 0.35])     # obstacles: grey
    gp = None
    if goal is not None:
        gp = np.asarray(getattr(goal, "base_position", goal), np.float32)
    elif state.goal is not None:
        gp = state.goal[env].detach().cpu().numpy()
    if gp is not None:
        for g in np.atleast_2d(gp):   # multi-goal scenes: one marker each
            rows.append([*g, *g, 0.03, 0.1, 0.2, 0.9])      # goal: marker
    cam = camera or dict(eye=(1.6, -1.6, 1.2), target=(0.0, 0.0, 0.4), fov=50)
    cam_arr = np.asarray([*cam["eye"], *cam["target"], cam["fov"]],
                         np.float32)
    caps = (np.asarray(rows, np.float32) if rows
            else np.zeros((0, 10), np.float32))
    if mesh_pack is not None:
        poses = []
        for f in mesh_pack["inst_frame"]:
            T = np.eye(4, dtype=np.float32) if f < 0 else T_all[f]
            poses.append(np.concatenate([np.asarray(T[:3, :3]).reshape(-1),
                                         np.asarray(T[:3, 3])]))
        return render_meshes(caps, mesh_pack, np.stack(poses), cam_arr,
                             width, height)
    if hull_planes is not None:
        colors = np.tile(np.asarray([[0.25, 0.45, 0.8]], np.float32),
                         (len(hull_planes), 1))
        return render_hulls(caps, np.concatenate(hull_planes),
                            np.asarray(hull_counts, np.int32), colors,
                            cam_arr, width, height)
    return render_capsules(caps, cam_arr, width, height)
