"""HyperNeRF real-capture dataset loader.

Rebuild of the reference loader (datasets/hypernerf.py:84-542):
  * scene.json (near/far/scale/center), metadata.json (time_id per image),
    dataset.json (ids + train/val splits), per-image camera/<id>.json;
  * cameras rescaled by 1/factor, recentered by scene center, scaled into
    scene coordinates;
  * vrig scenes (`add_cam`) use dataset train_ids/val_ids; others take every
    4th frame for train and the +2 offset frames for test;
  * training batches draw ONE random image and sample num_rays pixels from it
    (hypernerf.py:456-461);
  * ray directions come from the full distortion camera model
    (camera.pixels_to_rays), not a pinhole K.

Reference bug NOT reproduced (SURVEY §7): the reference passes *unnormalized*
directions as viewdirs (hypernerf.py:534), so its rays march in a stretched
parameterization; we use unit viewdirs.

The port's copy of cednerf_tpu/datasets/hypernerf.py: the same cameras,
arrays, rays and batches, its PNGs read by the port's own decoder
(utils/image.py) in place of imageio.
"""

import json
import os
from typing import Optional

import numpy as np

from ..utils.image import read_png
from .camera import Camera

SPLITS = ["train", "test"]
SUB_SPLITS = ["interp_", "misc_", "vrig_"]


def load_hyper_cameras(datadir: str, ratio: float, add_cam: bool):
    """Load scene metadata + per-image cameras (hypernerf.py:84-156)."""
    with open(os.path.join(datadir, "scene.json")) as f:
        scene_json = json.load(f)
    with open(os.path.join(datadir, "metadata.json")) as f:
        meta_json = json.load(f)
    with open(os.path.join(datadir, "dataset.json")) as f:
        dataset_json = json.load(f)

    near, far = scene_json["near"], scene_json["far"]
    coord_scale = scene_json["scale"]
    scene_center = np.asarray(scene_json["center"], np.float32)

    all_img = dataset_json["ids"]
    val_id = dataset_json["val_ids"]
    if len(val_id) == 0:
        assert not add_cam
        i_train = np.array([i for i in range(len(all_img)) if i % 4 == 0])
        i_test = (i_train + 2)[:-1]
    else:
        assert add_cam
        train_id = dataset_json["train_ids"]
        i_train = [i for i, x in enumerate(all_img) if x in train_id]
        i_test = [i for i, x in enumerate(all_img) if x in val_id]

    all_time = [meta_json[i]["time_id"] for i in all_img]
    max_time = max(all_time)
    all_time = np.asarray([t / max_time for t in all_time], np.float32)

    cameras = []
    for im in all_img:
        cam = Camera.from_json(os.path.join(datadir, "camera", f"{im}.json"))
        cam = cam.scale(ratio)
        cam.position = (cam.position - scene_center) * coord_scale
        cameras.append(cam)

    image_paths = [
        os.path.join(datadir, "rgb", f"{int(1 / ratio)}x", f"{i}.png") for i in all_img
    ]
    return {
        "near": near,
        "far": far,
        "cameras": cameras,
        "image_paths": image_paths,
        "times": all_time,
        "i_train": np.asarray(i_train, np.int64),
        "i_test": np.asarray(i_test, np.int64),
    }


class HyperNeRFDataset:
    """Train-batch sampler / eval-image iterator for HyperNeRF scenes."""

    def __init__(
        self,
        subject_id: str,
        root_fp: str,
        split: str,
        color_bkgd_aug: str = "black",
        num_rays: Optional[int] = None,
        factor: int = 2,
        add_cam: bool = False,
        seed: int = 0,
    ):
        assert split in SPLITS
        sub = next(s for s in SUB_SPLITS if subject_id.startswith(s))
        datadir = os.path.join(root_fp, subject_id, subject_id.split(sub)[-1])
        meta = load_hyper_cameras(datadir, ratio=1.0 / factor, add_cam=add_cam)

        idx = meta["i_train"] if split == "train" else meta["i_test"]
        self.cameras = [meta["cameras"][i] for i in idx]
        self.image_paths = [meta["image_paths"][i] for i in idx]
        self.timestamps = meta["times"][idx]
        self.near, self.far = meta["near"], meta["far"]
        self.split = split
        self.num_rays = num_rays
        self.training = (num_rays is not None) and split == "train"
        self.color_bkgd_aug = color_bkgd_aug
        self._rng = np.random.default_rng(seed)

        self.images = np.stack(
            [read_png(p)[..., :3].astype(np.uint8) for p in self.image_paths]
        )
        self.height, self.width = self.cameras[0].image_shape
        assert self.images.shape[1:3] == (self.height, self.width)
        # cached full-image world ray dirs per camera (Newton undistortion is
        # the slow part; each camera is queried thousands of times)
        self._dir_cache = {}

    def __len__(self):
        return len(self.images)

    @property
    def timestamps_pool(self):
        return self.timestamps.reshape(-1, 1)

    def _bkgd(self, rng):
        if self.training and self.color_bkgd_aug == "random":
            return rng.random(3).astype(np.float32)
        if self.color_bkgd_aug == "black":
            return np.zeros(3, np.float32)
        return np.ones(3, np.float32)

    def _camera_dirs(self, index: int) -> np.ndarray:
        if index not in self._dir_cache:
            cam = self.cameras[index]
            self._dir_cache[index] = cam.pixels_to_rays(cam.get_pixel_centers())
        return self._dir_cache[index]

    def sample(self, num_rays: int, key=None) -> dict:
        """One random image; num_rays random pixels (hypernerf.py:439-478)."""
        rng = self._rng
        image_id = int(rng.integers(0, len(self.images)))
        x = rng.integers(0, self.width, num_rays)
        y = rng.integers(0, self.height, num_rays)
        dirs = self._camera_dirs(image_id)[y, x]
        origins = np.broadcast_to(
            self.cameras[image_id].position[None, :], dirs.shape
        ).astype(np.float32)
        pixels = self.images[image_id, y, x].astype(np.float32) / 255.0
        t = np.full((num_rays, 1), self.timestamps[image_id], np.float32)
        return {
            "origins": origins,
            "viewdirs": dirs.astype(np.float32),
            "pixels": pixels,
            "timestamps": t,
            "color_bkgd": self._bkgd(rng),
        }

    def device_sampler(self, device="cuda"):
        """(data, sample_fn) for the scanned train path, the data on
        `device` (CUDA unless device="cpu"), or None when per-image
        calibration defeats camera grouping (the stacked host path then)."""
        from ..engine.sampling import hypernerf_device_data

        return hypernerf_device_data(self, device)

    def image_rays(self, index: int) -> dict:
        dirs = self._camera_dirs(index)
        origins = np.broadcast_to(
            self.cameras[index].position[None, None, :], dirs.shape
        ).astype(np.float32)
        return {
            "origins": origins,
            "viewdirs": dirs.astype(np.float32),
            "pixels": self.images[index].astype(np.float32) / 255.0,
            "timestamp": float(self.timestamps[index]),
            "color_bkgd": self._bkgd(self._rng),
        }
