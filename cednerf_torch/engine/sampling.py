"""Ray-batch samplers of the scanned train path — port of
cednerf_tpu/engine/sampling.py (`pinhole_rays_device`,
`make_stacked_sampler`, `dnerf_device_data`, `hypernerf_device_data`; the
JAX `make_image_stack_sampler` and `make_hyper_sampler` are the classes
`ImageStackSampler` and `HyperSampler`).

A device sampler is a pair (data, sample_fn): `data` a dict of tensors on
the Trainer's device, `sample_fn(data, generator, n_rays, i) -> batch`
with origins/viewdirs/pixels [R, 3], timestamps [R, 1] and color_bkgd [3]
on that device. A true device sampler draws with `generator` (the
Trainer's) and ignores `i`; the stacked sampler slices row `i` of K
host-assembled batches and draws nothing. The image-stack and HyperNeRF
samplers split into the draws (`__call__`) and `_assemble(data, img_id, x,
y, bkgd)`, a function of the draws alone, so a test can hand the JAX
package's own draws to the assembly. Datasets that fit the card live there
as uint8 image stacks (converted to float per drawn pixel) beside their
poses.
"""

from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device


def pinhole_rays_device(x: torch.Tensor, y: torch.Tensor, K: torch.Tensor,
                        c2w: torch.Tensor, opengl_camera: bool):
    """Tensor version of datasets.rays.pinhole_rays: x, y float [N], K
    [3, 3], c2w [N, 3, 4] -> (origins, viewdirs) [N, 3]."""
    sign = -1.0 if opengl_camera else 1.0
    camera_dirs = torch.stack([(x - K[0, 2] + 0.5) / K[0, 0],
                               (y - K[1, 2] + 0.5) / K[1, 1] * sign,
                               torch.full_like(x, sign)], dim=-1)
    directions = (camera_dirs[:, None, :] * c2w[:, :3, :3]).sum(-1)
    origins = c2w[:, :3, -1].expand(directions.shape)
    viewdirs = directions / torch.linalg.norm(directions, dim=-1,
                                              keepdim=True)
    return origins, viewdirs


def make_stacked_sampler() -> Callable:
    """Sampler over host-assembled stacked batches: `data` holds each batch
    field with a leading steps-per-call dim ([K, R, ...] per ray, [K, 3]
    backgrounds), and step `i` of the chunk takes row i."""

    def sample(data, generator, n_rays: int, i: int):
        del generator, n_rays
        return {k: v[i] for k, v in data.items()}

    return sample


def upload_stacked(host: Mapping[str, np.ndarray],
                   device: torch.device) -> dict:
    """K stacked host batches -> the same dict as float32 tensors on
    `device`, through one host buffer (pinned when the device is CUDA) and
    one non_blocking copy. The caching host allocator keeps the pinned
    buffer until the copy has run, so the caller may drop it."""
    arrs = {k: np.ascontiguousarray(v, dtype=np.float32)
            for k, v in host.items()}
    total = sum(a.size for a in arrs.values())
    buf = torch.empty(total, dtype=torch.float32,
                      pin_memory=device.type == "cuda")
    layout, off = {}, 0
    for k, a in arrs.items():
        buf[off:off + a.size] = torch.from_numpy(a.reshape(-1))
        layout[k] = (off, a.shape)
        off += a.size
    dev = buf.to(device, non_blocking=True)
    return {k: dev[o:o + int(np.prod(shape))].view(shape)
            for k, (o, shape) in layout.items()}


def _draw_bkgd(aug: str, generator: torch.Generator, device) -> torch.Tensor:
    if aug == "random":
        return torch.rand(3, device=device, generator=generator)
    if aug == "black":
        return torch.zeros(3, device=device)
    return torch.ones(3, device=device)


class ImageStackSampler:
    """Sampler over data = {images [N, H, W, C] uint8, camtoworlds [N, 3, 4],
    K [3, 3], timestamps [N]} (pinhole cameras): (image, x, y) drawn
    independently per ray, alpha composited over the background
    (dnerf_synthetic.py:169-242). Draws img_id, x, y, then the background
    (random augmentation only), from the Trainer's generator."""

    def __init__(self, opengl_camera: bool, bkgd_aug: str, has_alpha: bool):
        self.opengl_camera = opengl_camera
        self.bkgd_aug = bkgd_aug
        self.has_alpha = has_alpha

    def __call__(self, data, generator, n_rays: int, i=None):
        images = data["images"]
        n, h, w = images.shape[:3]
        dev = images.device

        def draw(high):
            return torch.randint(0, high, (n_rays,), device=dev,
                                 generator=generator)

        img_id, x, y = draw(n), draw(w), draw(h)
        bkgd = _draw_bkgd(self.bkgd_aug, generator, dev)
        return self._assemble(data, img_id, x, y, bkgd)

    def _assemble(self, data, img_id, x, y, bkgd) -> dict:
        """The batch of the draws img_id, x, y [R] (int) and bkgd [3]."""
        rgba = data["images"][img_id, y, x].float() / 255.0
        origins, viewdirs = pinhole_rays_device(
            x.float(), y.float(), data["K"], data["camtoworlds"][img_id],
            self.opengl_camera)
        if self.has_alpha:
            pixels = rgba[:, :3] * rgba[:, 3:] + bkgd * (1.0 - rgba[:, 3:])
        else:
            pixels = rgba[:, :3]
        return {"origins": origins, "viewdirs": viewdirs, "pixels": pixels,
                "timestamps": data["timestamps"][img_id].reshape(-1, 1),
                "color_bkgd": bkgd}


class HyperSampler:
    """Sampler over data = {images [N, H, W, 3] uint8, local_dirs [C, H, W,
    3] f32, orientations [N, 3, 3], positions [N, 3], timestamps [N],
    cam_group [N] int}: ONE random image per batch and n_rays random pixels
    of it (hypernerf.py:456-461), with the distortion camera's pixel ->
    local-ray map precomputed per physical camera (camera.py
    pixels_to_rays: world dirs are local @ orientation). Draws the image,
    x, y, then the background (random augmentation only)."""

    def __init__(self, bkgd_aug: str):
        self.bkgd_aug = bkgd_aug

    def __call__(self, data, generator, n_rays: int, i=None):
        images = data["images"]
        n, h, w = images.shape[:3]
        dev = images.device
        img = torch.randint(0, n, (), device=dev, generator=generator)
        x = torch.randint(0, w, (n_rays,), device=dev, generator=generator)
        y = torch.randint(0, h, (n_rays,), device=dev, generator=generator)
        bkgd = _draw_bkgd(self.bkgd_aug, generator, dev)
        return self._assemble(data, img, x, y, bkgd)

    def _assemble(self, data, img, x, y, bkgd) -> dict:
        """The batch of the draws img (0-d int), x, y [R] (int) and bkgd."""
        g = data["cam_group"][img]
        local = data["local_dirs"][g, y, x]
        world = local @ data["orientations"][img]
        viewdirs = world / torch.linalg.norm(world, dim=-1, keepdim=True)
        origins = data["positions"][img].expand(viewdirs.shape)
        pixels = data["images"][img, y, x].float() / 255.0
        t = data["timestamps"][img].expand(x.shape[0]).reshape(-1, 1)
        return {"origins": origins, "viewdirs": viewdirs, "pixels": pixels,
                "timestamps": t, "color_bkgd": bkgd}


def hypernerf_device_data(dataset, device="cuda") -> Optional[Tuple[dict,
                                                                    Callable]]:
    """A HyperNeRFDataset's arrays on `device` and its sampler.

    Cameras are grouped by intrinsics signature; each group shares one
    precomputed [H, W, 3] local-ray map (vrig scenes have 2 rig cameras,
    others 1). Returns None when there are more than 16 groups (per-image
    calibration: the local-dir stack would not pay; the host path
    instead), the JAX package's rule."""
    groups = {}
    cam_group = []
    for cam in dataset.cameras:
        sig = (
            round(float(cam.focal_length), 6),
            tuple(np.round(cam.principal_point, 6).tolist()),
            round(float(cam.skew), 9),
            round(float(cam.pixel_aspect_ratio), 9),
            tuple(np.round(cam.radial_distortion, 9).tolist()),
            tuple(np.round(cam.tangential_distortion, 9).tolist()),
            tuple(int(v) for v in cam.image_size),
        )
        if sig not in groups:
            groups[sig] = (len(groups), cam)
        cam_group.append(groups[sig][0])
    if len(groups) > 16:
        return None
    dev = resolve_device(device)
    cams = sorted(groups.values(), key=lambda gc: gc[0])
    local_dirs = np.stack(
        [cam.pixel_to_local_rays(cam.get_pixel_centers()) for _, cam in cams]
    ).astype(np.float32)

    def put(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=dev)

    data = {
        "images": put(dataset.images, np.uint8),
        "local_dirs": put(local_dirs),
        "orientations": put(np.stack([c.orientation
                                      for c in dataset.cameras]), np.float32),
        "positions": put(np.stack([c.position for c in dataset.cameras]),
                         np.float32),
        "timestamps": put(dataset.timestamps, np.float32),
        "cam_group": put(cam_group, np.int64),
    }
    return data, HyperSampler(dataset.color_bkgd_aug)


def dnerf_device_data(dataset, device="cuda") -> Tuple[dict, Callable]:
    """A DNeRFSyntheticDataset's arrays on `device` and its sampler."""
    dev = resolve_device(device)
    data = {
        "images": torch.as_tensor(dataset.images, device=dev),
        "camtoworlds": torch.as_tensor(dataset.camtoworlds, device=dev),
        "K": torch.as_tensor(dataset.K, device=dev),
        "timestamps": torch.as_tensor(dataset.timestamps, device=dev),
    }
    return data, ImageStackSampler(
        opengl_camera=True, bkgd_aug=dataset.color_bkgd_aug, has_alpha=True)
