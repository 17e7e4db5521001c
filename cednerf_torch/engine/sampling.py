"""Ray-batch samplers of the scanned train path — port of
cednerf_tpu/engine/sampling.py (`pinhole_rays_device`,
`make_stacked_sampler`).

A device sampler is a pair (data, sample_fn): `data` a dict of tensors on
the Trainer's device, `sample_fn(data, generator, n_rays, i) -> batch`
with origins/viewdirs/pixels [R, 3], timestamps [R, 1] and color_bkgd [3]
on that device. A true device sampler draws with `generator` (the
Trainer's) and ignores `i`; the stacked sampler slices row `i` of K
host-assembled batches and draws nothing. The image-stack and HyperNeRF
samplers come with the real-data loaders.
"""

from typing import Callable, Mapping

import numpy as np
import torch


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
