"""Dense (padded) volume-rendering primitives — port of
cednerf_tpu/ops/render.py.

Samples live in padded [n_rays, s_max] buffers with a validity mask
(nerfacc's packed `render_weight_from_density` and `accumulate_along_rays`,
reference cednerf/render.py:81-87, :158-169), so the per-ray transmittance
scan is a masked cumulative sum along the sample axis and accumulation
along rays a masked sum. The lattice eval marcher and the dense-lattice
train renderer (engine/renderer.py) composite with these.
"""

from typing import Optional

import torch

from ..utils.math import exclusive_cumsum


def render_weights_from_density(t_starts, t_ends, sigmas, mask,
                                prefix_trans: Optional[torch.Tensor] = None):
    """Per-ray transmittance scan: T_i = prod_{j<i}(1 - alpha_j),
    w_i = T_i alpha_i.

    t_starts, t_ends, sigmas, mask: [n_rays, s_max]; prefix_trans: optional
    [n_rays] transmittance carried in from earlier samples (the chunked
    inference mode of cednerf/render.py:42-56). Returns (weights, trans,
    alphas), all [n_rays, s_max] f32, weights zeroed at invalid slots."""
    sigmas = sigmas.float()
    mask = mask.to(sigmas.dtype)
    sdelta = sigmas * (t_ends - t_starts) * mask
    alphas = 1.0 - torch.exp(-sdelta)
    trans = torch.exp(-exclusive_cumsum(sdelta, dim=-1))
    if prefix_trans is not None:
        trans = trans * prefix_trans[:, None]
    weights = trans * alphas
    return weights * mask, trans, alphas


def accumulate_along_rays(weights, values=None, mask=None):
    """sum_i w_i * v_i over the sample axis (nerfacc accumulate_along_rays).

    weights [n_rays, s_max]; values [n_rays, s_max, C] or None (opacity).
    Returns [n_rays, C] (C = 1 when values is None)."""
    if mask is not None:
        weights = weights * mask
    if values is None:
        return weights.sum(dim=-1, keepdim=True)
    return (weights[..., None] * values).sum(dim=-2)


def reduce_along_rays(values, mask, weights=None, reduce: str = "mean"):
    """Per-ray reduction of per-sample values (cednerf/render.py:8-39).

    values [n_rays, s_max, C]; weights: optional [n_rays, s_max] multiplier.
    "mean" averages over the ray's valid samples, "sum" sums them."""
    mask = mask.to(values.dtype)
    src = values * mask[..., None]
    if weights is not None:
        src = src * weights[..., None]
    total = src.sum(dim=-2)
    if reduce == "sum":
        return total
    count = torch.clamp(mask.sum(dim=-1, keepdim=True), min=1)
    return total / count


def composite(weights, rgbs, t_starts, t_ends, mask, render_bkgd=None,
              eps: float = 1.1920929e-07):
    """Colour, opacity and depth, with the background composited
    (cednerf/render.py:158-175): depth is the weight-average of segment
    midpoints, normalized by opacity; the background fills 1 - opacity.
    Returns (colors [R, 3], opacities [R, 1], depths [R, 1])."""
    mask = mask.to(weights.dtype)
    colors = accumulate_along_rays(weights, rgbs, mask)
    opacities = accumulate_along_rays(weights, None, mask)
    t_mid = ((t_starts + t_ends) / 2.0)[..., None]
    depths = accumulate_along_rays(weights, t_mid, mask)
    depths = depths / torch.clamp(opacities, min=eps)
    if render_bkgd is not None:
        colors = colors + render_bkgd * (1.0 - opacities)
    return colors, opacities, depths
