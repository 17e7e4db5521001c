"""Training losses (port of cednerf_tpu/ops/losses.py; reference
train_real.py:369-409).

The dense-lattice forms (distortion_loss, rgbper_loss) reduce along the
sample axis of padded [R, S] buffers (the packed_render=False train step).
The packed forms take per-slot arrays [B] over the compacted budget
buffer, with per-ray segments [starts, starts + counts); every per-ray
reduction there goes through ops/segments.py.
"""

import torch

from ..utils.math import exclusive_cumsum, row_cumsum
from .segments import segment_broadcast, segment_sum


def ray_mean(per_ray: torch.Tensor, ray_weights=None,
             denom=None) -> torch.Tensor:
    """Mean over rays, optionally restricted to ray_weights (0/1 mask).
    denom: the divisor in place of the local count (max(sum of the
    weights, 1), or the ray count): a mesh's global one, so that the ranks'
    partial means sum to the mean over every ray."""
    if ray_weights is None:
        return per_ray.mean() if denom is None else per_ray.sum() / denom
    w = ray_weights.reshape(per_ray.shape)
    if denom is None:
        denom = torch.clamp(w.sum(), min=1.0)
    return (per_ray * w).sum() / denom


def distortion_loss(weights, t_starts, t_ends, mask=None, ray_weights=None,
                    denom=None):
    """Mip-NeRF 360 distortion loss in its O(N) prefix-sum form, mean over
    rays (flatten_eff_distloss's normalization, cednerf/losses.py:4-11):

      L(ray) = 2 sum_i w_i (m_i sum_{j<i} w_j - sum_{j<i} w_j m_j)
               + 1/3 sum_i w_i^2 (t1_i - t0_i)

    for samples sorted by t along each ray. ray_weights: optional [R] 0/1
    mask (budget-truncated rays excluded)."""
    if mask is not None:
        weights = weights * mask
    mid = (t_starts + t_ends) / 2.0
    interval = t_ends - t_starts
    wm = weights * mid
    w_prefix = exclusive_cumsum(weights, dim=-1)
    wm_prefix = exclusive_cumsum(wm, dim=-1)
    loss_bi = 2.0 * torch.sum(weights * (mid * w_prefix - wm_prefix), dim=-1)
    loss_uni = (1.0 / 3.0) * torch.sum(weights ** 2 * interval, dim=-1)
    return ray_mean(loss_bi + loss_uni, ray_weights, denom)


def rgbper_loss(rgbs, pixels, weights, mask, ray_weights=None, denom=None):
    """Per-sample colour-to-pixel penalty (train_real.py:394-396):
    sum_i |rgb_i - pixel|^2 w_i per ray, mean over rays. rgbs [R, S, 3],
    pixels [R, 3]; the caller detaches the weights."""
    per = torch.sum((rgbs - pixels[:, None, :]) ** 2, dim=-1)
    per_ray = torch.sum(per * weights * mask, dim=-1)
    return ray_mean(per_ray, ray_weights, denom)


def opacity_loss(opacities, eps: float = 1e-6, ray_weights=None,
                 denom=None):
    """-acc * log(acc), mean over rays (train_real.py:374), clamped for log
    stability."""
    acc = torch.clamp(opacities, eps, 1.0)
    return ray_mean(-acc * torch.log(acc), ray_weights, denom)


def acc_entropy_loss(opacities, eps: float = 1e-6, ray_weights=None,
                     denom=None):
    """Binary entropy of the residual transmittance (train_real.py:388-392)."""
    t_last = torch.clamp(1.0 - opacities, eps, 1.0 - eps)
    ent = -(t_last * torch.log(t_last)
            + (1.0 - t_last) * torch.log(1.0 - t_last))
    return ray_mean(ent, ray_weights, denom)


def _ray_base(prefix: torch.Tensor, starts: torch.Tensor,
              total: torch.Tensor) -> torch.Tensor:
    """[R] segment-base values of a [B] exclusive prefix; the grand total is
    appended so that starts == B (an overflow-clamped start) stays legal."""
    return torch.cat([prefix, total.reshape(1)])[starts.long()]


def packed_ray_sum_mean(per_slot, starts, counts, budget: int, ray_weights,
                        denom=None):
    """ray_mean of per-ray sums of `per_slot` (zero at invalid slots)."""
    return ray_mean(segment_sum(per_slot, starts, counts, budget),
                    ray_weights, denom)


def packed_distortion_loss(weights_p, t_starts_p, dts_p, starts, counts,
                           budget: int, ray_weights, n_blocks: int = 1,
                           denom=None):
    """Mip-NeRF 360 distortion loss on the packed buffer, in the
    pre-subtracted per-slot form

      per_slot = 2 w (mid * (cw - bw) - (cwm - bwm)) + w^2 dt / 3

    (per-ray prefixes = global prefixes minus the segment-broadcast ray
    bases), so that every per-slot term stays O(1). The expanded form (segment
    sums of w*mid*cw etc.) cancels catastrophically in f32: its cumsums grow
    ~quadratically with the slot index (the JAX package measured 71% loss
    error at 262k slots), so it must not be used."""
    mid = t_starts_p + 0.5 * dts_p
    w = weights_p
    wm = w * mid
    both = torch.stack([w, wm])
    cw, cwm = row_cumsum(both) - both      # exclusive, one fixed-order scan
    bases = torch.stack([_ray_base(cw, starts, w.sum()),
                         _ray_base(cwm, starts, wm.sum())], dim=-1)
    bases_b = segment_broadcast(bases, starts, budget, n_blocks)   # [B, 2]
    pref_w = cw - bases_b[:, 0]
    pref_wm = cwm - bases_b[:, 1]
    per_slot = 2.0 * w * (mid * pref_w - pref_wm) + w ** 2 * dts_p / 3.0
    return packed_ray_sum_mean(per_slot, starts, counts, budget, ray_weights,
                               denom)


def packed_rgbper_loss(rgbs_p, pixels, weights_p, starts, counts,
                       budget: int, ray_weights, denom=None):
    """rgbper_loss on the packed buffer (weights detached by the caller):
    S[w*|rgb|^2] - 2 pix . S[w*rgb] + |pix|^2 S[w] per ray, one [B, 5]
    segment_sum."""
    w = weights_p[:, None]
    chans = torch.cat([(rgbs_p ** 2).sum(-1, keepdim=True) * w,
                       rgbs_p * w, w], dim=-1)                    # [B, 5]
    s = segment_sum(chans, starts, counts, budget)                # [R, 5]
    per_ray = (s[:, 0] - 2.0 * (pixels * s[:, 1:4]).sum(-1)
               + (pixels ** 2).sum(-1) * s[:, 4])
    return ray_mean(per_ray, ray_weights, denom)


def packed_per_ray_mean(per_slot, valid_p, starts, counts, budget: int,
                        ray_weights, denom=None):
    """ray_mean of per-ray MEANS over valid slots."""
    s = segment_sum(torch.stack([per_slot, valid_p], dim=-1), starts,
                    counts, budget)                               # [R, 2]
    return ray_mean(s[:, 0] / torch.clamp(s[:, 1], min=1.0), ray_weights,
                    denom)
