"""DyNeRF (Neural 3D Video) multi-camera video dataset loader with optional
ISG/IST importance ray sampling.

Rebuild of the reference loaders datasets/dnerf_3d_video.py (uniform) and
datasets/dnerf_3d_video_IS.py (importance-sampled; the one train_real.py
actually uses for DyNeRF, train_real.py:152):

  * poses_bounds.npy (LLFF) + pre-split frame manifest images_x{factor}_list.json
    (keys 'weight'/'height' are width/height — the key-name quirk is
    load-bearing, convert_video2image.py:68-73);
  * pose pipeline: correct_poses_bounds, then flip y/z columns, scale camera
    positions by 0.4, offset z by +1.5; spiral render path (300 frames,
    zrate 0.1, dt 0.7, percentile 50);
  * split: train = cameras 1..N every frame; test = camera 0 every 10th frame;
  * flame_salmon's 1200-frame video is split into 4 scenes of 300 frames;
  * timestamps = frame_idx / (n_frames - 1); OpenCV camera (no y/z flip);
  * ISG/IST sampling: multinomial over per-pixel weight maps (2M uniform
    subset first when larger), each drawn coarse index expanded into a
    weights_subsampled^2 block of fine pixels (dnerf_3d_video_IS.py:401-440).

Reference bug NOT reproduced (SURVEY §7): dnerf_3d_video_IS.py:271 loads the
IST weights from the ISG file; we load ist_weights from the IST file.
Weights are read from .npy files written by tools/gen_isg_ist.py (replacing
the reference's gen_isg_ist.ipynb notebook + torch .pt files; .pt files are
also accepted for drop-in compatibility).

The port's copy of cednerf_tpu/datasets/dynerf.py: the same arrays, rays,
weights and batches, its PNGs read by the port's own decoder
(utils/image.py) in place of imageio, and its C++ built from the port's own
sources (native.py). `device` sets the policy for that C++: on CUDA a
failed g++ build raises; on the CPU the loader takes the numpy versions
instead, as the JAX loader does.
"""

import json
import os
from typing import Optional

import numpy as np
import torch

from ..utils.image import read_png
from . import native as nat
from .llff import correct_poses_bounds
from .rays import generate_spiral_path, pinhole_rays

SPLITS = ["train", "test"]
OPENGL_CAMERA = False


def isg_weights(imgs, median_imgs, gamma: float = 2e-2):
    """ISG: psi(diff^2 / (diff^2 + gamma^2)) vs the per-camera median image
    (dnerf_3d_video.py:13-33). imgs: [n_cams*n_frames, h, w, 3] uint8;
    median_imgs: [n_cams, h, w, 3] uint8. Returns [n_cams, n_frames, h, w]."""
    n_cams = median_imgs.shape[0]
    h, w, c = imgs.shape[1:]
    frames = imgs.reshape(n_cams, -1, h, w, c).astype(np.float32) / 255.0
    med = median_imgs.astype(np.float32)[:, None] / 255.0
    sq = (frames - med) ** 2
    psi = sq / (sq + gamma ** 2)
    return psi.mean(axis=-1)  # (1/3) * sum over channels


def ist_weights(imgs, num_cameras: int, alpha: float = 0.1, frame_shift: int = 25):
    """IST: max |frame - frame+-s| over shifts s <= frame_shift, clamped at
    alpha (dnerf_3d_video.py:36-54). Returns [n_cams, n_frames, h, w]."""
    n, h, w, c = imgs.shape
    frames = imgs.reshape(num_cameras, -1, h, w, c).astype(np.float32)
    max_diff = np.zeros_like(frames)
    frame_shift = min(frame_shift, frames.shape[1] - 1)
    for shift in range(1, frame_shift + 1):
        zeros = np.zeros((num_cameras, shift, h, w, c), np.float32)
        left = np.concatenate([frames[:, shift:], zeros], axis=1)
        right = np.concatenate([zeros, frames[:, :-shift]], axis=1)
        np.maximum(max_diff, np.abs(left - frames), out=max_diff)
        np.maximum(max_diff, np.abs(right - frames), out=max_diff)
    return np.maximum(max_diff.mean(axis=-1), alpha)


def load_dynerf_scene(root_fp: str, subject_id: str, factor: int = 4,
                      split: str = "train", read_img: bool = True):
    """Load poses + frame manifest + images (dnerf_3d_video.py:78-195)."""
    scene = subject_id
    is_flame_salmon = False
    flame_id = 0
    if "flame_salmon" in subject_id:
        flame_id = int(subject_id.split("_")[-1]) - 1
        is_flame_salmon = True
        subject_id = "flame_salmon_1"
    basedir = os.path.join(root_fp, subject_id)

    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    with open(os.path.join(basedir, f"images_x{factor}_list.json")) as jf:
        manifest = json.load(jf)
    first = manifest["videos"][0]["images"][0]
    r_w, r_h = first["weight"], first["height"]  # (sic) 'weight' == width

    poses[:2, 4, :] = np.array([r_h, r_w]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] / factor
    poses = poses.transpose([2, 0, 1])
    bds = bds.transpose([1, 0])
    focal = poses[0, -1, -1]
    height = int(poses[0, 0, -1])
    width = int(poses[0, 1, -1])

    poses, _, bds = correct_poses_bounds(poses, bds)
    render_poses = generate_spiral_path(
        poses[:, :3, :4], bds, n_frames=300, n_rots=2, zrate=0.1, dt=0.7,
        percentile=50,
    )
    # world massaging (dnerf_3d_video.py:132-140)
    poses[:, :, 1:3] *= -1
    render_poses[:, :, 1:3] *= -1
    poses[:, :, 3] *= 0.4
    render_poses[:, :, 3] *= 0.4
    poses[:, :, 3] += np.array([[0, 0, 1.5]])
    render_poses[:, :, 3] += np.array([[0, 0, 1.5]])

    video_list = manifest["videos"]
    if split == "train":
        load_every = 1
        video_list = video_list[1:]
        poses = poses[1:]
    else:
        load_every = 10
        video_list = video_list[:1]
        poses = poses[:1]

    images, timestamps, poses_list = [], [], []
    n_frames = 0
    for i, video in enumerate(video_list):
        vids = video["images"]
        if is_flame_salmon:
            vids = vids[flame_id * 300:(flame_id + 1) * 300]
        n_frames = len(vids)
        for j, im in enumerate(vids):
            if j % load_every == 0:
                if read_img:
                    images.append(
                        read_png(os.path.join(basedir, im["path"])).astype(np.uint8)
                    )
                else:
                    images.append(np.zeros((1,), np.uint8))
                timestamps.append(im["idx"] / (len(vids) - 1))
                poses_list.append(poses[i])
    images = np.stack(images, axis=0)
    return {
        "images": images,
        "poses": np.asarray(poses_list, np.float32),
        "timestamps": np.asarray(timestamps, np.float32),
        "n_frames_per_cam": n_frames,
        "n_cameras": len(video_list),
        "intrinsics": (focal, height, width),
        "render_poses": render_poses.astype(np.float32),
    }


class DyNeRFDataset:
    """Train-batch sampler / eval iterator for DyNeRF scenes.

    sampling='uniform' reproduces dnerf_3d_video.py (independent cam/t/x/y);
    sampling='isg' / 'ist' reproduce the importance-sampled loader. The
    reference switches ISG -> IST mid-training via switch_to_ist()
    (train_real.py:301-309, commented there but wired in the IS loader).

    device: where training runs. "cuda" requires the native C++ (a failed
    build raises); "cpu" uses it when it builds, else the numpy versions.
    """

    def __init__(
        self,
        subject_id: str,
        root_fp: str,
        split: str,
        color_bkgd_aug: str = "random",
        num_rays: Optional[int] = None,
        factor: int = 4,
        sampling: str = "isg",
        read_image: bool = True,
        seed: int = 0,
        device="cuda",
    ):
        assert split in SPLITS
        self._use_native = nat.available(
            required=torch.device(device).type == "cuda")
        data = load_dynerf_scene(root_fp, subject_id, factor, split, read_image)
        self.images = data["images"]
        self.poses = data["poses"]
        self.timestamps = data["timestamps"]
        self.images_per_video = data["n_frames_per_cam"]
        self.num_cameras = data["n_cameras"]
        self.focal, self.height, self.width = data["intrinsics"]
        self.render_poses_arr = data["render_poses"]
        self.K = np.asarray(
            [[self.focal, 0, self.width / 2.0],
             [0, self.focal, self.height / 2.0],
             [0, 0, 1]], np.float32,
        )
        self.split = split
        self.training = (num_rays is not None) and split == "train"
        self.color_bkgd_aug = color_bkgd_aug
        self._rng = np.random.default_rng(seed)
        self._factor = factor
        self.weights_subsampled = int(4 / factor) if factor < 4 else 1
        self.sampling_batch_size = 2_000_000
        self.sampling = "uniform"
        self.sampling_weights = None
        self._weights_dir = os.path.join(root_fp, self._base_subject(subject_id))
        if self.training and sampling in ("isg", "ist"):
            w = self._load_weights(self._weights_dir, sampling)
            if w is None and read_image:
                # self-bootstrap: the reference REQUIRES a notebook
                # precompute pass; here missing weight maps are computed
                # from the loaded frames (native C++ kernels when a
                # toolchain exists) and cached beside the scene
                w = self._compute_weights(sampling)
                if w is not None:
                    self.weights_subsampled = 1  # computed at image res
            if w is not None:
                self.sampling_weights = w.reshape(-1)
                self.sampling_weights /= self.sampling_weights.sum()
                self.sampling = sampling
        self._native = None
        if self.training and read_image:
            self._build_native(seed)

    def _build_native(self, seed: int):
        """Multithreaded C++ batch sampler (csrc/host/raysampler.cpp) — the
        host-side hot path for DyNeRF's multi-GB frame stacks; the numpy
        path when the loader runs without the C++ (see `device`)."""
        if not self._use_native:
            return
        weights = None
        if self.sampling_weights is not None:
            weights = self.sampling_weights
        self._native = nat.NativeRaySampler(
            self.images, self.poses, self.K, self.timestamps,
            opengl_camera=OPENGL_CAMERA, weights=weights,
            subsample=self.weights_subsampled, seed=seed,
        )

    @staticmethod
    def _base_subject(subject_id):
        return "flame_salmon_1" if "flame_salmon" in subject_id else subject_id

    def _compute_weights(self, kind, gamma: float = 2e-2,
                         alpha: float = 0.1, frame_shift: int = 25):
        """Compute ISG/IST weights from the loaded frame stack (the native
        csrc/host/weights.cpp kernels, or their numpy versions when the
        loader runs without the C++) and cache them as
        {kind}_weights_f{factor}.npy in the scene dir (the unsuffixed
        names stay reserved for the reference's factor-4 precompute)."""
        n_cams = self.num_cameras
        imgs = self.images[..., :3]
        n, h, w, _ = imgs.shape
        native = self._use_native
        if kind == "isg":
            if native and n // n_cams <= 4096:
                med = nat.native_median_images(imgs, n_cams)
            else:
                med = np.median(
                    imgs.reshape(n_cams, -1, h, w, 3), axis=1
                ).astype(np.uint8)
            wts = (nat.native_isg_weights(imgs, med, gamma=gamma) if native
                   else isg_weights(imgs, med, gamma=gamma))
        else:
            wts = (nat.native_ist_weights(imgs, n_cams, alpha=alpha,
                                          frame_shift=frame_shift) if native
                   else ist_weights(imgs, n_cams, alpha=alpha,
                                    frame_shift=frame_shift))
        wts = wts.astype(np.float32)
        wts /= wts.sum()
        try:
            np.save(self._weights_cache_path(kind), wts.reshape(-1, h, w))
        except OSError:
            pass  # read-only dataset dir: recompute next run
        return wts

    def _weights_cache_path(self, kind):
        return os.path.join(self._weights_dir,
                            f"{kind}_weights_f{self._factor}.npy")

    def _load_weights(self, basedir, kind):
        """Load a weight map, making self.weights_subsampled authoritative
        for the SOURCE it came from: bootstrap caches are at image
        resolution (1); reference precompute files are at factor-4
        resolution (4/factor for factor < 4)."""
        cache = self._weights_cache_path(kind)
        if basedir == self._weights_dir and os.path.exists(cache):
            self.weights_subsampled = 1
            return np.load(cache).astype(np.float32)
        self.weights_subsampled = (int(4 / self._factor)
                                   if self._factor < 4 else 1)
        npy = os.path.join(basedir, f"{kind}_weights.npy")
        pt = os.path.join(basedir, f"{kind}_weights.pt")
        if os.path.exists(npy):
            return np.load(npy).astype(np.float32)
        if os.path.exists(pt):
            return torch.load(pt, map_location="cpu").numpy().astype(np.float32)
        return None

    def switch_to_ist(self, weights_or_dir=None):
        """Swap the sampling distribution to IST (dnerf_3d_video_IS.py:308).

        weights_or_dir: explicit weight array, a directory holding
        ist_weights.npy/.pt, or None to use the scene's own weights dir.
        Missing maps self-bootstrap from the loaded frames (like __init__);
        an explicit array is assumed to be at image resolution."""
        if isinstance(weights_or_dir, np.ndarray):
            w = weights_or_dir
            self.weights_subsampled = 1
        else:
            w = self._load_weights(weights_or_dir or self._weights_dir, "ist")
            if w is None and self.images is not None:
                w = self._compute_weights("ist")
                if w is not None:
                    self.weights_subsampled = 1
        if w is not None:
            self.sampling_weights = w.reshape(-1).astype(np.float32)
            self.sampling_weights /= self.sampling_weights.sum()
            self.sampling = "ist"
            if self._native is not None:
                self._build_native(0)

    def __len__(self):
        return len(self.poses)

    @property
    def timestamps_pool(self):
        return self.timestamps.reshape(-1, 1)

    def _bkgd(self, rng):
        if self.training and self.color_bkgd_aug == "random":
            return rng.random(3).astype(np.float32)
        if self.color_bkgd_aug == "black":
            return np.zeros(3, np.float32)
        return np.ones(3, np.float32)

    def _draw_pixel_ids(self, num_rays, rng):
        """(image_id, x, y) triples — uniform or weight-multinomial."""
        if self.sampling == "uniform" or self.sampling_weights is None:
            t_idx = rng.integers(0, self.images_per_video, num_rays)
            cam = rng.integers(0, self.num_cameras, num_rays)
            image_id = cam * self.images_per_video + t_idx
            x = rng.integers(0, self.width, num_rays)
            y = rng.integers(0, self.height, num_rays)
            return image_id, x, y
        # importance sampling over (possibly coarser) weight maps
        sub = self.weights_subsampled
        batch = num_rays // (sub * sub)
        n_weights = len(self.sampling_weights)
        if n_weights > self.sampling_batch_size:
            subset = rng.integers(0, n_weights, self.sampling_batch_size)
            p = self.sampling_weights[subset]
            idx = subset[rng.choice(len(subset), size=batch, p=p / p.sum())]
        else:
            idx = rng.choice(n_weights, size=batch, p=self.sampling_weights)
        hsub, wsub = self.height // sub, self.width // sub
        image_id = idx // (hsub * wsub)
        ysub = (idx % (hsub * wsub)) // wsub
        xsub = (idx % (hsub * wsub)) % wsub
        xs, ys = [], []
        for ah in range(sub):
            for aw in range(sub):
                xs.append(xsub * sub + aw)
                ys.append(ysub * sub + ah)
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        image_id = np.tile(image_id, sub * sub)
        return image_id, x, y

    def sample(self, num_rays: int, key=None) -> dict:
        rng = self._rng
        if self._native is not None:
            origins, viewdirs, pixels, ts = self._native.sample(num_rays)
            return {
                "origins": origins,
                "viewdirs": viewdirs,
                "pixels": pixels,
                "timestamps": ts.reshape(-1, 1),
                "color_bkgd": self._bkgd(rng),
            }
        image_id, x, y = self._draw_pixel_ids(num_rays, rng)
        pixels = self.images[image_id, y, x].astype(np.float32) / 255.0
        c2w = self.poses[image_id]
        origins, viewdirs, _ = pinhole_rays(
            x.astype(np.float32), y.astype(np.float32), self.K, c2w, OPENGL_CAMERA
        )
        return {
            "origins": origins,
            "viewdirs": viewdirs,
            "pixels": pixels,
            "timestamps": self.timestamps[image_id].reshape(-1, 1),
            "color_bkgd": self._bkgd(rng),
        }

    def image_rays(self, index: int) -> dict:
        x, y = np.meshgrid(np.arange(self.width, dtype=np.float32),
                           np.arange(self.height, dtype=np.float32), indexing="xy")
        x, y = x.reshape(-1), y.reshape(-1)
        c2w = np.broadcast_to(self.poses[index], (x.shape[0], 3, 4))
        origins, viewdirs, _ = pinhole_rays(x, y, self.K, c2w, OPENGL_CAMERA)
        hw = (self.height, self.width)
        return {
            "origins": origins.reshape(*hw, 3),
            "viewdirs": viewdirs.reshape(*hw, 3),
            "pixels": self.images[index].astype(np.float32) / 255.0,
            "timestamp": float(self.timestamps[index]),
            "color_bkgd": self._bkgd(self._rng),
        }

    # --- spiral-path video rendering (dnerf_3d_video.py:301-344) --- #

    def render_poses(self) -> dict:
        return {"c2w": self.render_poses_arr}

    def pose_rays(self, poses: dict, index: int) -> dict:
        c2w_one = poses["c2w"][index]
        x, y = np.meshgrid(np.arange(self.width, dtype=np.float32),
                           np.arange(self.height, dtype=np.float32), indexing="xy")
        x, y = x.reshape(-1), y.reshape(-1)
        c2w = np.broadcast_to(c2w_one, (x.shape[0], 3, 4))
        origins, viewdirs, _ = pinhole_rays(x, y, self.K, c2w, OPENGL_CAMERA)
        hw = (self.height, self.width)
        return {
            "origins": origins.reshape(*hw, 3),
            "viewdirs": viewdirs.reshape(*hw, 3),
            "timestamp": index / len(poses["c2w"]),
        }
