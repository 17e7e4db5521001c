"""Procedural dynamic scenes for training without dataset files (numpy only,
the port's copy of cednerf_tpu/datasets/procedural.py's BallScene and
BallCloudScene, host samplers).

BallScene: one opaque coloured ball drifting with time, rendered
analytically by ray-sphere intersection. BallCloudScene: K drifting balls
filling the box, the nearest hit's colour, for a denser per-ray sample load.
Both expose the sampler protocol of engine/train.py's Trainer:
`sample(num_rays) -> batch dict` of numpy arrays and `timestamps_pool`.
The same seed gives the same batches as the JAX package's scenes.
"""

import numpy as np

from .rays import pinhole_rays, viewmatrix

BALL_COLOR = np.array([0.9, 0.25, 0.1], np.float32)
BG = np.array([1.0, 1.0, 1.0], np.float32)
RADIUS = 0.5


def ball_center(t):
    return np.array([0.3 * (t - 0.5), 0.0, 0.0], np.float32)


def render_gt(origins, viewdirs, t):
    """Analytic opaque-sphere render: ball colour where the ray hits, else
    the background."""
    c = ball_center(t)
    oc = origins - c
    b = np.sum(oc * viewdirs, axis=-1)
    disc = b ** 2 - (np.sum(oc * oc, axis=-1) - RADIUS ** 2)
    hit = (disc > 0) & (-b - np.sqrt(np.maximum(disc, 0)) > 0)
    return np.where(hit[:, None], BALL_COLOR, BG).astype(np.float32)


class BallScene:
    """Sampler protocol: sample(num_rays) + timestamps_pool + eval rays."""

    #: When True the camera index is the time index (monocular capture);
    #: requires n_cams == n_times.
    monocular = False

    def __init__(self, n_cams: int = 6, wh: int = 48, n_times: int = 4,
                 seed: int = 0):
        self.wh = wh
        focal = wh * 1.1
        self.K = np.array([[focal, 0, wh / 2], [0, focal, wh / 2], [0, 0, 1]],
                          np.float32)
        c2ws = []
        for i in range(n_cams):
            th = 2 * np.pi * i / n_cams
            pos = np.array([3.0 * np.cos(th), 3.0 * np.sin(th), 1.0],
                           np.float32)
            # OpenGL camera: -z looks at the origin
            c2ws.append(viewmatrix(pos, np.array([0.0, 0, 1]), pos))
        self.c2ws = np.stack(c2ws).astype(np.float32)
        self.times = np.linspace(0, 1, n_times).astype(np.float32)
        self._rng = np.random.default_rng(seed)

    @property
    def timestamps_pool(self):
        return self.times.reshape(-1, 1)

    def _render_gt(self, origins, viewdirs, t):
        return render_gt(origins, viewdirs, t)

    def sample(self, num_rays: int, key=None) -> dict:
        rng = self._rng
        ti = rng.integers(0, len(self.times), num_rays)
        cam = ti if self.monocular else rng.integers(0, len(self.c2ws),
                                                     num_rays)
        x = rng.integers(0, self.wh, num_rays).astype(np.float32)
        y = rng.integers(0, self.wh, num_rays).astype(np.float32)
        origins, viewdirs, _ = pinhole_rays(x, y, self.K, self.c2ws[cam],
                                            True)
        t = self.times[ti]
        pixels = np.empty((num_rays, 3), np.float32)
        for k in range(len(self.times)):
            m = ti == k
            if m.any():
                pixels[m] = self._render_gt(origins[m], viewdirs[m],
                                            self.times[k])
        return {"origins": origins, "viewdirs": viewdirs, "pixels": pixels,
                "timestamps": t.reshape(-1, 1), "color_bkgd": BG.copy()}

    def eval_view(self, theta: float, t: float):
        """Held-out full image from a novel camera angle: (gt, origins,
        viewdirs), each [wh, wh, 3]."""
        pos = np.array([3.0 * np.cos(theta), 3.0 * np.sin(theta), 1.0],
                       np.float32)
        c2w = viewmatrix(pos, np.array([0.0, 0, 1]), pos).astype(np.float32)
        x, y = np.meshgrid(np.arange(self.wh, dtype=np.float32),
                           np.arange(self.wh, dtype=np.float32),
                           indexing="xy")
        x, y = x.reshape(-1), y.reshape(-1)
        c2ws = np.broadcast_to(c2w, (x.shape[0], 3, 4))
        origins, viewdirs, _ = pinhole_rays(x, y, self.K, c2ws, True)
        gt = self._render_gt(origins, viewdirs, t)
        wh = self.wh
        return (gt.reshape(wh, wh, 3), origins.reshape(wh, wh, 3),
                viewdirs.reshape(wh, wh, 3))

    def image_rays(self, cam: int, t: float) -> dict:
        x, y = np.meshgrid(np.arange(self.wh, dtype=np.float32),
                           np.arange(self.wh, dtype=np.float32),
                           indexing="xy")
        x, y = x.reshape(-1), y.reshape(-1)
        c2w = np.broadcast_to(self.c2ws[cam], (x.shape[0], 3, 4))
        origins, viewdirs, _ = pinhole_rays(x, y, self.K, c2w, True)
        pixels = self._render_gt(origins, viewdirs, t)
        return {"origins": origins.reshape(self.wh, self.wh, 3),
                "viewdirs": viewdirs.reshape(self.wh, self.wh, 3),
                "pixels": pixels.reshape(self.wh, self.wh, 3),
                "timestamp": t, "color_bkgd": BG.copy()}


class BallCloudScene(BallScene):
    """Denser dynamic scene: n_balls drifting opaque spheres filling the box
    (the nearest sphere hit's colour, else the background). One small ball
    trains to a thin occupied shell, ~3 valid samples per ray; the cloud
    keeps many surfaces along most rays."""

    def __init__(self, n_cams: int = 8, wh: int = 128, n_times: int = 8,
                 n_balls: int = 48, seed: int = 0):
        super().__init__(n_cams=n_cams, wh=wh, n_times=n_times, seed=seed)
        rng = np.random.default_rng(seed + 1)
        self.centers0 = rng.uniform(-0.9, 0.9, (n_balls, 3)).astype(
            np.float32)
        self.vels = rng.uniform(-0.4, 0.4, (n_balls, 3)).astype(np.float32)
        self.radii = rng.uniform(0.12, 0.3, (n_balls,)).astype(np.float32)
        self.colors = rng.uniform(0.1, 1.0, (n_balls, 3)).astype(np.float32)

    def _centers(self, t):
        return self.centers0 + self.vels * (np.asarray(t, np.float32) - 0.5)

    def _render_gt(self, origins, viewdirs, t):
        c = self._centers(t)                               # [K, 3]
        oc = origins[:, None, :] - c[None]                 # [N, K, 3]
        b = np.sum(oc * viewdirs[:, None, :], axis=-1)     # [N, K]
        disc = b ** 2 - (np.sum(oc * oc, -1) - self.radii[None] ** 2)
        tt = -b - np.sqrt(np.maximum(disc, 0))
        hit = (disc > 0) & (tt > 0)
        tt = np.where(hit, tt, np.inf)
        k = np.argmin(tt, axis=-1)
        any_hit = np.isfinite(tt[np.arange(len(k)), k])
        return np.where(any_hit[:, None], self.colors[k], BG).astype(
            np.float32)
