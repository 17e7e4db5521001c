"""Pinhole ray generation (host-side numpy), copied from
cednerf_tpu/datasets/rays.py::pinhole_rays."""

import numpy as np


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
