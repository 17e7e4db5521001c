"""D-NeRF synthetic dataset loader (transforms_{split}.json + RGBA PNGs).

Rebuild of the reference loader (datasets/dnerf_synthetic.py): 800x800
frames, focal from camera_angle_x, per-frame `time` (or index/(N-1)),
OpenGL camera, NEAR/FAR 2/6 (unused by the occupancy path, kept for parity),
RGBA composited over a white/black/random background.

Train batches sample (image, x, y) independently across all images
(dnerf_synthetic.py:173-187); eval returns full image grids. `sample` is
the host-side numpy path; `device_sampler` puts the uint8 image stack on
the device and samples there, inside the scanned train loop.

The port's copy of cednerf_tpu/datasets/dnerf_synthetic.py: the same
arrays, rays and batches, its PNGs read by the port's own decoder
(utils/image.py) in place of imageio.
"""

import json
import os
from typing import Optional

import numpy as np

from ..utils.image import read_png
from .rays import generate_hemispherical_orbit, pinhole_rays

SPLITS = ["train", "val", "test", "trainval"]

WIDTH, HEIGHT = 800, 800
NEAR, FAR = 2.0, 6.0
OPENGL_CAMERA = True


def _load_renderings(root_fp: str, subject_id: str, split: str):
    """Read transforms_{split}.json + PNGs (dnerf_synthetic.py:16-57)."""
    data_dir = os.path.join(root_fp, subject_id)
    with open(os.path.join(data_dir, f"transforms_{split}.json")) as fp:
        meta = json.load(fp)
    images, camtoworlds, timestamps = [], [], []
    n = len(meta["frames"])
    for i in range(n):
        frame = meta["frames"][i]
        fname = os.path.join(data_dir, frame["file_path"] + ".png")
        images.append(read_png(fname))
        timestamps.append(frame["time"] if "time" in frame else float(i) / (n - 1))
        camtoworlds.append(frame["transform_matrix"])
    images = np.stack(images, 0).astype(np.uint8)
    camtoworlds = np.asarray(camtoworlds, np.float32)[:, :3, :4]
    timestamps = np.asarray(timestamps, np.float32)
    h, w = images.shape[1:3]
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    return images, camtoworlds, focal, timestamps


class DNeRFSyntheticDataset:
    """Train-batch sampler / eval-image iterator for D-NeRF synthetic scenes."""

    def __init__(
        self,
        subject_id: str,
        root_fp: str,
        split: str,
        color_bkgd_aug: str = "white",
        num_rays: Optional[int] = None,
        seed: int = 0,
    ):
        assert split in SPLITS
        assert color_bkgd_aug in ("white", "black", "random")
        self.split = split
        self.color_bkgd_aug = color_bkgd_aug
        self.num_rays = num_rays
        self.training = (num_rays is not None) and split in ("train", "trainval")
        self.images, self.camtoworlds, self.focal, self.timestamps = _load_renderings(
            root_fp, subject_id, split
        )
        self.width, self.height = self.images.shape[2], self.images.shape[1]
        self.K = np.asarray(
            [
                [self.focal, 0, self.width / 2.0],
                [0, self.focal, self.height / 2.0],
                [0, 0, 1],
            ],
            np.float32,
        )
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.images)

    @property
    def timestamps_pool(self):
        return self.timestamps.reshape(-1, 1)

    def _bkgd(self, rng):
        if self.training:
            if self.color_bkgd_aug == "random":
                return rng.random(3).astype(np.float32)
            if self.color_bkgd_aug == "black":
                return np.zeros(3, np.float32)
            return np.ones(3, np.float32)
        return np.ones(3, np.float32)  # white at inference (reference behavior)

    def sample(self, num_rays: int, key=None) -> dict:
        """Random (image, x, y) ray batch (dnerf_synthetic.py:173-242)."""
        rng = self._rng
        image_id = rng.integers(0, len(self.images), num_rays)
        x = rng.integers(0, self.width, num_rays)
        y = rng.integers(0, self.height, num_rays)
        rgba = self.images[image_id, y, x].astype(np.float32) / 255.0
        c2w = self.camtoworlds[image_id]
        origins, viewdirs, _ = pinhole_rays(
            x.astype(np.float32), y.astype(np.float32), self.K, c2w, OPENGL_CAMERA
        )
        bkgd = self._bkgd(rng)
        pixels = rgba[:, :3] * rgba[:, 3:] + bkgd * (1.0 - rgba[:, 3:])
        return {
            "origins": origins,
            "viewdirs": viewdirs,
            "pixels": pixels.astype(np.float32),
            "timestamps": self.timestamps[image_id].reshape(-1, 1),
            "color_bkgd": bkgd,
        }

    def device_sampler(self, device="cuda"):
        """(data, sample_fn) for the scanned train path, the data on
        `device` (CUDA unless device="cpu")."""
        from ..engine.sampling import dnerf_device_data

        return dnerf_device_data(self, device)

    # --- hemispherical-orbit video rendering (datasets/utils.py:114-133) --- #

    def render_poses(self, n_frames: int = 120) -> dict:
        return {"c2w": generate_hemispherical_orbit(self.camtoworlds, n_frames)}

    def pose_rays(self, poses: dict, index: int) -> dict:
        c2w_one = poses["c2w"][index]
        x, y = np.meshgrid(np.arange(self.width, dtype=np.float32),
                           np.arange(self.height, dtype=np.float32),
                           indexing="xy")
        x, y = x.reshape(-1), y.reshape(-1)
        c2w = np.broadcast_to(c2w_one, (x.shape[0], 3, 4))
        origins, viewdirs, _ = pinhole_rays(x, y, self.K, c2w, OPENGL_CAMERA)
        hw = (self.height, self.width)
        return {
            "origins": origins.reshape(*hw, 3),
            "viewdirs": viewdirs.reshape(*hw, 3),
            "timestamp": index / len(poses["c2w"]),
        }

    def image_rays(self, index: int) -> dict:
        """Full-image eval rays for test/val frames (dnerf_synthetic.py:189-197)."""
        x, y = np.meshgrid(
            np.arange(self.width, dtype=np.float32),
            np.arange(self.height, dtype=np.float32),
            indexing="xy",
        )
        x, y = x.reshape(-1), y.reshape(-1)
        c2w = np.broadcast_to(self.camtoworlds[index], (x.shape[0], 3, 4))
        origins, viewdirs, _ = pinhole_rays(x, y, self.K, c2w, OPENGL_CAMERA)
        rgba = self.images[index].reshape(-1, 4).astype(np.float32) / 255.0
        bkgd = self._bkgd(self._rng)
        pixels = rgba[:, :3] * rgba[:, 3:] + bkgd * (1.0 - rgba[:, 3:])
        return {
            "origins": origins.reshape(self.height, self.width, 3),
            "viewdirs": viewdirs.reshape(self.height, self.width, 3),
            "pixels": pixels.reshape(self.height, self.width, 3),
            "timestamp": float(self.timestamps[index]),
            "color_bkgd": bkgd,
        }
