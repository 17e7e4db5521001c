"""Procedural dynamic scenes for training without dataset files, the port's
copy of cednerf_tpu/datasets/procedural.py's BallScene, BallCloudScene,
TexturedCloudScene, MonocularOrbitScene and ProceduralLoader: host samplers
in numpy and device samplers in PyTorch.

BallScene: one opaque coloured ball drifting with time, rendered
analytically by ray-sphere intersection. BallCloudScene: K drifting balls
filling the box, the nearest hit's colour, for a denser per-ray sample load.
TexturedCloudScene: smaller balls with a high-frequency surface texture,
the encoder gate. MonocularOrbitScene: the cloud seen by one camera per
time (the HyperNeRF vrig capture regime).
All expose the sampler protocol of engine/train.py's Trainer:
`sample(num_rays) -> batch dict` of numpy arrays and `timestamps_pool`.
The same seed gives the same batches as the JAX package's scenes.
`device_sampler()` returns the scanned train path's (data, sample_fn) pair
(engine/sampling.py): camera, time and pixel draws from the Trainer's
generator, then rays and analytic ground truth by `sample_at`, a function
of the draws alone.
"""

import numpy as np
import torch

from ..engine.sampling import pinhole_rays_device
from ..utils.device import resolve_device
from .rays import generate_hemispherical_orbit, pinhole_rays, viewmatrix

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

    def device_data(self, device) -> dict:
        """The sampler's constants on `device`, colours included (a per-step
        upload from numpy would cost a host sync)."""
        return {"c2ws": torch.as_tensor(self.c2ws, device=device),
                "K": torch.as_tensor(self.K, device=device),
                "times": torch.as_tensor(self.times, device=device),
                "bg": torch.as_tensor(BG, device=device),
                "ball_color": torch.as_tensor(BALL_COLOR, device=device)}

    def device_sampler(self, device="cuda"):
        """(data, sample_fn) for the scanned train path, the data on
        `device` (CUDA unless device="cpu"). sample_fn(data, generator,
        n_rays, i=None) draws camera, time, x and y indices in that order
        from `generator` (all four always; monocular scenes take the time
        as the camera) and hands them to sample_at."""
        data = self.device_data(resolve_device(device))
        wh, mono = self.wh, self.monocular

        def sample(d, generator, n_rays: int, i=None):
            dev = d["times"].device

            def draw(high):
                return torch.randint(0, high, (n_rays,), device=dev,
                                     generator=generator)

            cam = draw(d["c2ws"].shape[0])
            ti = draw(d["times"].shape[0])
            x, y = draw(wh), draw(wh)
            return self.sample_at(d, ti if mono else cam, ti, x.float(),
                                  y.float())

        return data, sample

    def sample_at(self, d: dict, cam, ti, x, y) -> dict:
        """The batch of the draws cam, ti [R] (int) and pixel x, y [R]
        (float): pinhole rays and the analytic ground truth."""
        origins, viewdirs = pinhole_rays_device(x, y, d["K"], d["c2ws"][cam],
                                                True)
        t = d["times"][ti]
        center = torch.stack([0.3 * (t - 0.5), torch.zeros_like(t),
                              torch.zeros_like(t)], dim=-1)
        oc = origins - center
        b = (oc * viewdirs).sum(-1)
        disc = b ** 2 - ((oc * oc).sum(-1) - RADIUS ** 2)
        hit = (disc > 0) & (-b - torch.sqrt(torch.clamp(disc, min=0)) > 0)
        bg = d["bg"]
        pixels = torch.where(hit[:, None], d["ball_color"], bg)
        return {"origins": origins, "viewdirs": viewdirs, "pixels": pixels,
                "timestamps": t.reshape(-1, 1), "color_bkgd": bg}

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

    def device_data(self, device) -> dict:
        return {**super().device_data(device),
                "centers0": torch.as_tensor(self.centers0, device=device),
                "vels": torch.as_tensor(self.vels, device=device),
                "radii": torch.as_tensor(self.radii, device=device),
                "colors": torch.as_tensor(self.colors, device=device)}

    def sample_at(self, d: dict, cam, ti, x, y) -> dict:
        origins, viewdirs = pinhole_rays_device(x, y, d["K"], d["c2ws"][cam],
                                                True)
        t = d["times"][ti]
        c = d["centers0"][None] + d["vels"][None] * (t[:, None, None] - 0.5)
        oc = origins[:, None, :] - c                       # [N, K, 3]
        b = (oc * viewdirs[:, None, :]).sum(-1)
        disc = b ** 2 - ((oc * oc).sum(-1) - d["radii"][None] ** 2)
        tt = -b - torch.sqrt(torch.clamp(disc, min=0))
        hit = (disc > 0) & (tt > 0)
        tt = torch.where(hit, tt, torch.inf)
        k = torch.argmin(tt, dim=-1)
        any_hit = torch.isfinite(torch.gather(tt, 1, k[:, None])[:, 0])
        bg = d["bg"]
        pixels = torch.where(any_hit[:, None], d["colors"][k], bg)
        return {"origins": origins, "viewdirs": viewdirs, "pixels": pixels,
                "timestamps": t.reshape(-1, 1), "color_bkgd": bg}


class TexturedCloudScene(BallCloudScene):
    """The encoder gate of the JAX rounds: many spheres whose surface colour
    is modulated by a per-ball 3D sinusoid of the hit point at 30-120
    rad/unit, features of ~0.05-0.2 units that only the finest hash levels
    (res >= ~500) hold. The sphere surfaces cover ~4M+ fine-level cells,
    far above a capped table's 2^20 corner slots, so the fine levels run
    deep into hash collisions, where brick-granularity hashing could part
    from the reference's per-corner hashing."""

    def __init__(self, n_cams: int = 8, wh: int = 128, n_times: int = 8,
                 n_balls: int = 64, seed: int = 0):
        super().__init__(n_cams=n_cams, wh=wh, n_times=n_times,
                         n_balls=n_balls, seed=seed)
        rng = np.random.default_rng(seed + 7)
        self.radii = rng.uniform(0.08, 0.22, (n_balls,)).astype(np.float32)
        self.tex_freq = rng.uniform(30.0, 120.0, (n_balls,)).astype(
            np.float32)
        self.tex_phase = rng.uniform(0, 2 * np.pi, (n_balls, 3)).astype(
            np.float32)

    def _texture(self, xp, k):
        """Modulation in [0.1, 1.0] from the 3D sinusoid of hit point xp."""
        f = self.tex_freq[k][:, None]
        ph = self.tex_phase[k]
        s = np.sin(xp * f + ph)
        return (0.55 + 0.45 * s[:, 0] * s[:, 1] * s[:, 2])[:, None]

    def _render_gt(self, origins, viewdirs, t):
        c = self._centers(t)
        oc = origins[:, None, :] - c[None]
        b = np.sum(oc * viewdirs[:, None, :], axis=-1)
        disc = b ** 2 - (np.sum(oc * oc, -1) - self.radii[None] ** 2)
        tt = -b - np.sqrt(np.maximum(disc, 0))
        hit = (disc > 0) & (tt > 0)
        tt = np.where(hit, tt, np.inf)
        k = np.argmin(tt, axis=-1)
        t_hit = tt[np.arange(len(k)), k]
        any_hit = np.isfinite(t_hit)
        xp = origins + viewdirs * np.where(any_hit, t_hit, 0.0)[:, None]
        col = self.colors[k] * self._texture(xp, k)
        return np.where(any_hit[:, None], col, BG).astype(np.float32)

    def device_data(self, device) -> dict:
        return {**super().device_data(device),
                "tex_freq": torch.as_tensor(self.tex_freq, device=device),
                "tex_phase": torch.as_tensor(self.tex_phase, device=device)}

    def sample_at(self, d: dict, cam, ti, x, y) -> dict:
        origins, viewdirs = pinhole_rays_device(x, y, d["K"], d["c2ws"][cam],
                                                True)
        t = d["times"][ti]
        c = d["centers0"][None] + d["vels"][None] * (t[:, None, None] - 0.5)
        oc = origins[:, None, :] - c                       # [N, K, 3]
        b = (oc * viewdirs[:, None, :]).sum(-1)
        disc = b ** 2 - ((oc * oc).sum(-1) - d["radii"][None] ** 2)
        tt = -b - torch.sqrt(torch.clamp(disc, min=0))
        hit = (disc > 0) & (tt > 0)
        tt = torch.where(hit, tt, torch.inf)
        k = torch.argmin(tt, dim=-1)
        t_hit = torch.gather(tt, 1, k[:, None])[:, 0]
        any_hit = torch.isfinite(t_hit)
        xp = origins + viewdirs * torch.where(any_hit, t_hit, 0.0)[:, None]
        s = torch.sin(xp * d["tex_freq"][k][:, None] + d["tex_phase"][k])
        tex = (0.55 + 0.45 * s[:, 0] * s[:, 1] * s[:, 2])[:, None]
        bg = d["bg"]
        pixels = torch.where(any_hit[:, None], d["colors"][k] * tex, bg)
        return {"origins": origins, "viewdirs": viewdirs, "pixels": pixels,
                "timestamps": t.reshape(-1, 1), "color_bkgd": bg}


class MonocularOrbitScene(BallCloudScene):
    """The HyperNeRF vrig capture regime: each time is observed from exactly
    one camera of an orbit (n_cams == n_times, camera i <-> time i), so
    viewpoint and scene time are entangled, as in the reference's only
    published numbers (run_hyper.sh vrig scenes: one moving rig camera).
    The multi-camera scenes sample (camera, time) independently (the D-NeRF
    / DyNeRF regime).

    Eval protocol, as vrig's held-out rig: a novel camera angle at a
    training time (eval_view)."""

    monocular = True

    def __init__(self, n_frames: int = 32, wh: int = 128,
                 n_balls: int = 48, seed: int = 0):
        super().__init__(n_cams=n_frames, wh=wh, n_times=n_frames,
                         n_balls=n_balls, seed=seed)
        # the per-ball drift slowed to what one orbit pass can constrain
        self.vels = (0.5 * self.vels).astype(np.float32)


class ProceduralLoader:
    """Dataset-free loader with the train_real.py dataset protocol (the JAX
    package's `ProceduralLoader`): `--scene procedural` (one ball) and
    `--scene procedural_cloud` (the ball cloud) train the whole pipeline,
    CLI to checkpoint, video and viewer, on analytic ground truth. Test
    split: 4 held-out camera angles at mid-sequence times."""

    TEST_VIEWS = [(0.21, 0.36), (0.93, 0.5), (1.71, 0.64), (2.6, 0.43)]

    def __init__(self, subject_id: str = "procedural", root_fp: str = "",
                 split: str = "train", num_rays=None, **_kw):
        cls = BallCloudScene if "cloud" in subject_id else BallScene
        self.scene = cls(n_cams=8, wh=128, n_times=8)
        self.split = split
        self.width = self.height = self.scene.wh
        self.K = self.scene.K
        self.camtoworlds = self.scene.c2ws

    @property
    def timestamps_pool(self):
        return self.scene.timestamps_pool

    def sample(self, num_rays: int, key=None) -> dict:
        return self.scene.sample(num_rays, key)

    def device_sampler(self, device="cuda"):
        return self.scene.device_sampler(device)

    def __len__(self):
        return len(self.TEST_VIEWS)

    def image_rays(self, index: int) -> dict:
        theta, t = self.TEST_VIEWS[index]
        gt, origins, viewdirs = self.scene.eval_view(theta=theta * np.pi, t=t)
        return {"origins": origins, "viewdirs": viewdirs, "pixels": gt,
                "timestamp": t, "color_bkgd": BG.copy()}

    def render_poses(self, n_frames: int = 60) -> dict:
        return {"c2w": generate_hemispherical_orbit(self.camtoworlds,
                                                    n_frames)}

    def pose_rays(self, poses: dict, index: int) -> dict:
        c2w_one = poses["c2w"][index]
        x, y = np.meshgrid(np.arange(self.width, dtype=np.float32),
                           np.arange(self.height, dtype=np.float32),
                           indexing="xy")
        x, y = x.reshape(-1), y.reshape(-1)
        c2w = np.broadcast_to(c2w_one, (x.shape[0], 3, 4))
        origins, viewdirs, _ = pinhole_rays(x, y, self.K, c2w, True)
        hw = (self.height, self.width)
        return {"origins": origins.reshape(*hw, 3),
                "viewdirs": viewdirs.reshape(*hw, 3),
                "timestamp": index / len(poses["c2w"])}
