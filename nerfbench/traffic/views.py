"""The viewer's frames: a fixed set of views on the viewer page's orbit
(radius, elevation phi), `views` azimuths evenly spaced, each with its own
time, shown in an order drawn from the run's seed and cycled. Every seed
asks for the same views; only the order moves."""

import math

import numpy as np


def orbit_c2w(radius: float, theta: float, phi: float) -> np.ndarray:
    """The viewer page's orbit camera (OpenGL convention), [3, 4] f32."""
    pos = np.array([radius * math.cos(phi) * math.cos(theta),
                    radius * math.cos(phi) * math.sin(theta),
                    radius * math.sin(phi)])
    z = pos / np.linalg.norm(pos)
    x = np.cross([0.0, 0.0, 1.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z, pos], axis=1).astype(np.float32)


def view_set(p: dict) -> list:
    """[(c2w [3, 4], time)] of the traffic file's views: azimuth i 2 pi / n,
    time (i * time_stride mod n) / (n - 1)."""
    n = p["views"]
    return [(orbit_c2w(p["radius"], 2.0 * math.pi * i / n, p["phi"]),
             ((i * p["time_stride"]) % n) / (n - 1)) for i in range(n)]


def order(p: dict, seed: int):
    """Endless view indices: a fresh permutation of the set per cycle, from
    the seed."""
    rng = np.random.default_rng(seed)
    while True:
        yield from rng.permutation(p["views"]).tolist()
