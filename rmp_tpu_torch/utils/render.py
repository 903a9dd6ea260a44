"""Host-side scene rendering and GIF export (an observer, never on the
device path).

The port's `rmp_tpu/utils/render.py`, the reference's visual record
(PyBullet's camera and imageio's GIF writer, simulation.py:289-300,
384-386): `render_scene` draws a matplotlib 3D wireframe of the robot's
capsules, the obstacles and the goal (for a host with matplotlib; the
native ray tracer, utils/native.py, needs none), and `save_gif` writes
frames as an animated GIF89a with numpy and the standard library alone:
each pixel takes the nearest colour of a fixed 3-3-2 palette (PALETTE),
LZW-coded.
"""
from __future__ import annotations

import io
import struct

import numpy as np

# the fixed palette: 8 levels of red and green, 4 of blue (index r g b as
# 3, 3 and 2 bits)
_R = np.round(np.arange(8) * 255 / 7).astype(np.uint8)
_B = np.round(np.arange(4) * 255 / 3).astype(np.uint8)
PALETTE = np.stack(np.meshgrid(_R, _R, _B, indexing="ij"),
                   axis=-1).reshape(256, 3)


def render_scene(model, state, objects=(), goal=None, camera=None,
                 figsize=(4, 4), dpi=80, env: int = 0) -> np.ndarray:
    """One frame (H, W, 3) uint8 of env `env` of a batched SimState."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from rmp_tpu_torch.models import kinematics as K
    from rmp_tpu_torch.sim.collision import link_world_capsules_all

    fig = plt.figure(figsize=figsize, dpi=dpi)
    ax = fig.add_subplot(projection="3d")
    T_b = K.fk_all(model, state.q[env:env + 1])
    T_all = T_b[0].detach().cpu().numpy()
    # kinematic chain skeleton
    origins = np.concatenate([np.zeros((1, 3)), T_all[:, :3, 3]], axis=0)
    for i, p in enumerate(model.parent):
        ax.plot(*zip(origins[p + 1], origins[i + 1]), color="tab:blue", lw=2)
    # collision capsules
    p0, p1, _, _ = link_world_capsules_all(model, T_b)
    for a, b in zip(p0[0].detach().cpu().numpy(),
                    p1[0].detach().cpu().numpy()):
        ax.plot(*zip(a, b), color="tab:cyan", lw=4, alpha=0.5)
    obs = state.obstacles
    if obs is not None:
        o0, o1 = ((x if x.dim() == 2 else x[env]).detach().cpu().numpy()
                  for x in (obs.p0, obs.p1))
        for a, b in zip(o0, o1):
            ax.plot(*zip(a, b), color="0.3", lw=6, alpha=0.8)
    if goal is not None:
        gp = np.asarray(getattr(goal, "base_position", goal), np.float32)
    elif state.goal is not None:
        gp = state.goal[env].detach().cpu().numpy()
    else:
        gp = None
    if gp is not None:
        for g in np.atleast_2d(gp):
            ax.scatter(*g, color="tab:blue", s=40)
    lim = camera["limit"] if camera and "limit" in camera else 1.2
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_zlim(0, 2 * lim)
    if camera and "azim" in camera:
        ax.view_init(elev=camera.get("elev", 30), azim=camera["azim"])
    ax.set_axis_off()
    fig.tight_layout(pad=0)
    buf = io.BytesIO()
    fig.savefig(buf, format="raw", dpi=dpi)
    w, h = fig.canvas.get_width_height()
    frame = np.frombuffer(buf.getvalue(), np.uint8).reshape(h, w, 4)[..., :3]
    plt.close(fig)
    return frame.copy()


def render_frame(model, state, goal=None, camera=None, objects=(),
                 geometry: str = "capsule", env: int = 0,
                 width: int = 320, height: int = 240):
    """(frame, renderer) of env `env`: the native ray tracer where it is
    available (utils/native.available), else matplotlib, as the JAX
    package chooses. camera, geometry ('capsule', 'hull' or 'visual'),
    width and height are the native renderer's."""
    from rmp_tpu_torch.utils import native
    if native.available():
        return native.render_scene_native(model, state, goal=goal,
                                          camera=camera, geometry=geometry,
                                          env=env, width=width,
                                          height=height), "native"
    return render_scene(model, state, objects=objects, goal=goal,
                        env=env), "matplotlib"


def quantize(frame: np.ndarray) -> np.ndarray:
    """(H, W) PALETTE indices of an (H, W, 3) uint8 frame: each channel to
    its nearest level."""
    f = np.asarray(frame, np.float32)
    r = np.rint(f[..., 0] * 7 / 255).astype(np.uint8)
    g = np.rint(f[..., 1] * 7 / 255).astype(np.uint8)
    b = np.rint(f[..., 2] * 3 / 255).astype(np.uint8)
    return (r << 5) | (g << 2) | b


def _lzw(indices: bytes) -> bytes:
    """GIF LZW code of 8-bit indices (minimum code size 8), packed LSB
    first into sub-blocks of at most 255 bytes, the terminator included."""
    clear, end = 256, 257
    table = {}
    width, next_code = 9, 258
    acc = n_bits = 0
    out = bytearray()

    def emit(code):
        nonlocal acc, n_bits
        acc |= code << n_bits
        n_bits += width
        while n_bits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            n_bits -= 8

    emit(clear)
    prefix = indices[0]
    for b in indices[1:]:
        key = (prefix << 8) | b
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << width) and width < 12:
                width += 1
        else:       # the table is full: start afresh
            emit(clear)
            table.clear()
            width, next_code = 9, 258
        prefix = b
    emit(prefix)
    emit(end)
    if n_bits:
        out.append(acc & 0xFF)
    blocks = bytearray()
    for i in range(0, len(out), 255):
        chunk = out[i:i + 255]
        blocks.append(len(chunk))
        blocks += chunk
    blocks.append(0)
    return bytes(blocks)


def encode_gif(frames, fps: int = 16) -> bytes:
    """An animated, looping GIF89a of frames (equal (H, W, 3) uint8
    arrays) at `fps`, in PALETTE's colours."""
    frames = [np.asarray(f, np.uint8) for f in frames]
    h, w, _ = frames[0].shape
    delay = max(1, round(100 / fps))          # hundredths of a second
    out = bytearray(b"GIF89a")
    out += struct.pack("<HHBBB", w, h, 0xF7, 0, 0)   # 256-colour table
    out += PALETTE.tobytes()
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"  # loop forever
    for f in frames:
        if f.shape != (h, w, 3):
            raise ValueError(f"frame {f.shape} differs from {(h, w, 3)}")
        out += b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0)
        out += b"\x08" + _lzw(quantize(f).tobytes())
    out += b"\x3b"
    return bytes(out)


def save_gif(frames, path: str, fps: int = 16) -> None:
    """Write frames (a list of (H, W, 3) uint8) to an animated GIF; no
    file for no frames."""
    if not frames:
        return
    with open(path, "wb") as f:
        f.write(encode_gif(frames, fps))
