"""A carved occupancy grid for the viewer cell: the cells of a spherical
shell about the box centre, plus a share of cells drawn from the seed (the
idea of the program's own shell grids, written again here)."""

import torch


def shell(p: dict, aabb, seed: int, device) -> torch.Tensor:
    """bool [res, res, res]: |r - radius| < width, or a draw below noise."""
    res = p["grid_resolution"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    lo, hi = aabb[0], aabb[3]
    c = (torch.arange(res, device=device) + 0.5) / res * (hi - lo) + lo
    r = torch.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2
                   + c[None, None, :] ** 2)
    noise = torch.rand((res, res, res), device=device, generator=gen)
    return ((r - p["shell_radius"]).abs() < p["shell_width"]) | (
        noise < p["noise"])
