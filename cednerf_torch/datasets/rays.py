"""Pose, render-path and pinhole ray helpers (host-side numpy), the port's
copy of cednerf_tpu/datasets/rays.py (`Rays`, `normalize`, `viewmatrix`,
`average_poses`, `generate_spiral_path`, `generate_hemispherical_orbit`,
`pinhole_rays`)."""

from typing import NamedTuple

import numpy as np


def normalize(v):
    return v / np.linalg.norm(v)


def viewmatrix(z, up, pos):
    """Camera-to-world [3, 4] from a look direction and an up vector
    (reference datasets/utils.py:23-28)."""
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([-vec0, vec1, vec2, pos], axis=1)


class Rays(NamedTuple):
    """origins/viewdirs pytree (reference datasets/utils.py:8)."""

    origins: np.ndarray
    viewdirs: np.ndarray


def average_poses(poses):
    """Mean camera pose of [N, 3, 4] poses (datasets/utils.py:33-65)."""
    center = poses[..., 3].mean(0)
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(z, y_))
    y = np.cross(x, z)
    return np.stack([x, y, z, center], 1)


def generate_spiral_path(poses, near_fars, n_frames=120, n_rots=2, zrate=0.5,
                         dt=0.75, percentile=70):
    """LLFF-style forward-facing spiral render path (datasets/utils.py:67-112)."""
    c2w = average_poses(poses)
    up = normalize(poses[:, :3, 1].sum(0))
    close_depth, inf_depth = near_fars.min() * 1.0, near_fars.max() * 5.0
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    positions = poses[:, :3, 3]
    radii = np.percentile(np.abs(positions), percentile, 0)
    radii = np.concatenate([radii, [1.0]])
    render_poses = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_frames, endpoint=False):
        t = radii * [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]
        position = c2w @ t
        lookat = c2w @ np.array([0, 0, -focal, 1.0])
        z_axis = normalize(position - lookat)
        render_poses.append(viewmatrix(z_axis, up, position))
    return np.stack(render_poses, axis=0)


def generate_hemispherical_orbit(poses, n_frames=120):
    """z-axis orbit render path (datasets/utils.py:114-133)."""
    origins = poses[:, :3, 3]
    radius = np.sqrt(np.mean(np.sum(origins ** 2, axis=-1)))
    sin_phi = np.mean(origins[:, 2], axis=0) / radius
    cos_phi = np.sqrt(1 - sin_phi ** 2)
    up = np.array([0.0, 0.0, 1.0])
    render_poses = []
    for theta in np.linspace(0.0, 2.0 * np.pi, n_frames, endpoint=False):
        camorigin = radius * np.array(
            [cos_phi * np.cos(theta), cos_phi * np.sin(theta), sin_phi]
        )
        render_poses.append(viewmatrix(camorigin, up, camorigin))
    return np.stack(render_poses, axis=0)


def pinhole_rays(x, y, K, c2w, opengl_camera: bool):
    """Pixel coordinates -> world rays through a pinhole camera.

    x, y: [N] pixel indices; K: [3, 3]; c2w: [N, 3, 4] (per-pixel poses).
    Matches the reference's +0.5 pixel centering and OpenGL y/z sign flip
    (dnerf_synthetic.py:199-221). Returns (origins, viewdirs, directions).
    """
    sign = -1.0 if opengl_camera else 1.0
    camera_dirs = np.stack(
        [
            (x - K[0, 2] + 0.5) / K[0, 0],
            (y - K[1, 2] + 0.5) / K[1, 1] * sign,
            np.full_like(x, sign, dtype=np.float32),
        ],
        axis=-1,
    )  # [N, 3]
    directions = (camera_dirs[:, None, :] * c2w[:, :3, :3]).sum(-1)
    origins = np.broadcast_to(c2w[:, :3, -1], directions.shape)
    viewdirs = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
    return (origins.astype(np.float32), viewdirs.astype(np.float32),
            directions.astype(np.float32))
