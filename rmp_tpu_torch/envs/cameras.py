"""Per-scenario camera configs for the render/GIF pipeline: a copy of
`rmp_tpu/envs/cameras.py` (plain Python, no array library).

Mirrors the reference's per-experiment `camera_view_kwargs` dicts
(experiments/franka_panda/config/camera_config.py:1-6 and
experiments/two_joint_robot/config/camera_config.py), in the same
target/distance/yaw/pitch convention (PyBullet resetDebugVisualizerCamera),
converted to the eye/target rays our renderers consume.
"""
from __future__ import annotations

import math

# reference values: franka camera_config.py (distance 1.5, yaw 50, pitch -35);
# two_joint camera_config.py (distance 3.48, yaw 49.2, pitch -23)
_FAMILY_DEFAULTS = {
    "franka": dict(target=(0.0, 0.0, 0.0), distance=1.5, yaw=50.0,
                   pitch=-35.0),
    "two_joint": dict(target=(0.0, 0.0, 0.0), distance=3.48, yaw=49.2,
                      pitch=-23.0),
    "ur5": dict(target=(0.0, 0.0, 0.3), distance=1.6, yaw=50.0, pitch=-30.0),
    "dual_panda": dict(target=(0.2, 0.0, 0.4), distance=2.2, yaw=30.0,
                       pitch=-25.0),
}

# per-scenario overrides (keys = env registry names)
CAMERAS: dict[str, dict] = {
    # lift the target toward the workspace center for the cluttered scenes
    "franka/06_cluttered_environment": dict(target=(0.0, 0.0, 0.4),
                                            distance=1.8),
    "franka/moving_obstacles": dict(target=(0.0, 0.0, 0.4), distance=1.8),
    "franka/randomized_cluttered": dict(target=(0.0, 0.0, 0.4), distance=1.8),
    "franka/neural_clutter": dict(target=(0.0, 0.0, 0.4), distance=1.8),
    # frame the shared workspace box between the two bases
    "dual_panda/randomized_clutter": dict(target=(0.3, 0.0, 0.5),
                                          distance=2.0),
}


def camera_for(env_name: str) -> dict:
    """{'target', 'distance', 'yaw', 'pitch'} for a scenario."""
    family = env_name.split("/")[0]
    cfg = dict(_FAMILY_DEFAULTS.get(family, _FAMILY_DEFAULTS["franka"]))
    cfg.update(CAMERAS.get(env_name, {}))
    return cfg


def eye_target(cfg: dict, yaw_offset_deg: float = 0.0,
               fov: float = 50.0) -> dict:
    """Convert a debug-camera config to the renderers' eye/target/fov kwargs.

    yaw_offset_deg lets callers orbit around the configured framing (the
    reference flagship orbits its camera, 06_cluttered_environment.py:18-23).
    """
    yaw = math.radians(cfg["yaw"] + yaw_offset_deg)
    pitch = math.radians(cfg["pitch"])
    tx, ty, tz = cfg["target"]
    d = cfg["distance"]
    eye = (tx + d * math.cos(pitch) * math.cos(yaw),
           ty + d * math.cos(pitch) * math.sin(yaw),
           tz - d * math.sin(pitch))
    return dict(eye=eye, target=(tx, ty, tz), fov=fov)
