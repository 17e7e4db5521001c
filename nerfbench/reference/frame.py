"""A viewer frame in plain PyTorch: the reference that a served frame is
held to.

Each pixel's ray (OpenGL pinhole camera, +0.5 pixel centres) marches the
uniform lattice of `max_march_steps` samples from its box entry, with no
jitter; the samples whose midpoint lies in an occupied cell of the grid,
and before the box exit, are kept in t order, the first `max_samples` of
them. Their densities and colours composite front to back over the
background; the frame is the colour clipped to [0, 1] and truncated to 8
bits, as the viewer sends it. The renderer under test may stop a ray once
its transmittance falls below 1e-4, which moves a colour by at most that
much.
"""

import torch

from .field import field_forward


def _ray_box(origins, dirs, aabb):
    """Slab test: (t_min clamped at 0, t_max)."""
    inv = 1.0 / torch.where(dirs.abs() < 1e-10, torch.full_like(dirs, 1e-10),
                            dirs)
    t0 = (aabb[:3] - origins) * inv
    t1 = (aabb[3:] - origins) * inv
    return (torch.clamp(torch.minimum(t0, t1).amax(-1), min=0.0),
            torch.maximum(t0, t1).amin(-1))


def occupied(bins: torch.Tensor, aabb: torch.Tensor, pos: torch.Tensor):
    """The cell of a one-level grid bins [r, r, r] at positions [..., 3],
    False outside the box (its faces count as inside)."""
    res = bins.shape[-1]
    inside = torch.all((pos >= aabb[:3]) & (pos <= aabb[3:]), -1)
    u = (pos - aabb[:3]) / (aabb[3:] - aabb[:3])
    ic = torch.clamp(torch.floor(u * res).long(), 0, res - 1)
    return bins[ic[..., 0], ic[..., 1], ic[..., 2]] & inside


def pinhole_rays(c2w: torch.Tensor, K: torch.Tensor, width: int,
                 height: int):
    """Rays [H W, 3] of every pixel, row-major from the top left."""
    dev = c2w.device
    y, x = torch.meshgrid(torch.arange(height, dtype=torch.float32,
                                       device=dev),
                          torch.arange(width, dtype=torch.float32,
                                       device=dev), indexing="ij")
    x, y = x.reshape(-1), y.reshape(-1)
    cam = torch.stack([(x - K[0, 2] + 0.5) / K[0, 0],
                       -((y - K[1, 2] + 0.5) / K[1, 1]),
                       torch.full_like(x, -1.0)], -1)
    dirs = (cam[:, None, :] * c2w[None, :3, :3]).sum(-1)
    origins = c2w[:3, 3].expand(dirs.shape)
    return origins, dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)


@torch.no_grad()
def render_frame(params: dict, cfg: dict, bins: torch.Tensor,
                 c2w: torch.Tensor, K: torch.Tensor, t: float, width: int,
                 max_samples: int, bkgd: torch.Tensor, precision="bf16",
                 ray_chunk: int = 8192) -> torch.Tensor:
    """uint8 [width, width, 3] frame at camera c2w [3, 4] and time t."""
    sc = cfg["scene"]
    dev = c2w.device
    aabb = torch.tensor(sc["aabb"], dtype=torch.float32, device=dev)
    step = sc["render_step_size"]
    m = sc["max_march_steps"]
    origins, dirs = pinhole_rays(c2w, K, width, width)
    lattice = torch.arange(m, dtype=torch.float32, device=dev)[None] * step
    out = []
    for i in range(0, origins.shape[0], ray_chunk):
        o, d = origins[i:i + ray_chunk], dirs[i:i + ray_chunk]
        t_min, t_max = _ray_box(o, d, aabb)
        t_min = torch.clamp(t_min, min=sc["near_plane"])
        t_max = torch.clamp(t_max, max=sc["far_plane"])
        t0 = t_min[:, None] + lattice
        pos = o[:, None] + d[:, None] * (t0 + 0.5 * step)[..., None]
        valid = (t0 < t_max[:, None]) & occupied(bins, aabb, pos)
        keep = valid & (torch.cumsum(valid.to(torch.int32), -1)
                        <= max_samples)
        r_idx, s_idx = torch.nonzero(keep, as_tuple=True)
        if r_idx.numel() == 0:      # no ray of the chunk meets the grid
            out.append(bkgd.expand(o.shape[0], 3))
            continue
        dens, rgb = field_forward(
            params, cfg, pos[r_idx, s_idx],
            torch.full((r_idx.shape[0], 1), float(t), device=dev),
            d[r_idx], precision=precision)
        sdelta = torch.zeros(keep.shape, device=dev).index_put(
            (r_idx, s_idx), dens * step)
        colors = torch.zeros(keep.shape + (3,), device=dev).index_put(
            (r_idx, s_idx), rgb)
        trans = torch.exp(-(torch.cumsum(sdelta, -1) - sdelta))
        w = trans * (1.0 - torch.exp(-sdelta))
        color = (w[..., None] * colors).sum(1) \
            + bkgd * (1.0 - w.sum(-1, keepdim=True))
        out.append(color)
    rgb = torch.cat(out).reshape(width, width, 3)
    return (torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)
