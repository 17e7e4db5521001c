"""Proposal-network sampler — port of cednerf_tpu/ops/proposal.py.

nerfacc's PropNetEstimator / mip-NeRF 360 semantics on dense
[n_rays, n_samples] buffers, as in the JAX package:

  * initial interval edges uniform in s-space, s -> t linear ("uniform")
    or linear in disparity ("lindisp");
  * per proposal level: the density field at interval midpoints, weights by
    the transmittance scan, then the next level's edges by inverse-CDF
    resampling (piecewise uniform within bins, mip-NeRF 360 weight
    padding);
  * the proposal loss, mip-NeRF 360's outer-measure bound against the
    stop-gradiented final weights;
  * loss annealing over the first `anneal_steps` steps.

Random draws are explicit. A jittering function takes either a
torch.Generator or the jitter itself: [R, n + 1] values in [-0.5, 0.5)
with the two end columns zero, as JAX forms them from `jax.random`, so a
test can feed JAX's draws in. Jittered edges are monotone by construction
(each interior edge moves inside its own half-cell window) and no sort is
taken. The index searches are torch.searchsorted, whose left / right
binary search gives JAX's compare-all count on these monotone edges and
CDFs. A scan whose length is its tensor's numel goes through
utils/math.py::row_cumsum (cub's single-pass scan is not reproducible on
the card).
"""

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.math import row_cumsum
from .render import render_weights_from_density


def _cumsum_last(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along the last dim."""
    if x.numel() == x.shape[-1]:
        return row_cumsum(x.reshape(-1)).reshape(x.shape)
    return torch.cumsum(x, dim=-1)


def _grid(n: int, like: torch.Tensor) -> torch.Tensor:
    """[n + 1] f32 values i / n with jnp.linspace(0, 1, n + 1)'s bits: XLA
    forms i * (1 / n) with the f32 reciprocal, and the last value is 1."""
    i = torch.arange(n, dtype=torch.float32, device=like.device)
    return torch.cat([i * float(np.float32(1.0 / n)), i.new_ones(1)])


def draw_jitter(n_rays: int, n: int, generator: torch.Generator,
                device) -> torch.Tensor:
    """[n_rays, n + 1] uniform draws in [-0.5, 0.5), end columns zero."""
    u = torch.rand((n_rays, n + 1), device=device, generator=generator) - 0.5
    return F.pad(u[:, 1:-1], (1, 1))


def _jitter_of(n_rays: int, n: int, device, jitter=None,
               generator: Optional[torch.Generator] = None):
    if jitter is not None:
        return jitter.to(device=device, dtype=torch.float32)
    if generator is not None:
        return draw_jitter(n_rays, n, generator, device)
    return None


def s_to_t(s, near, far, sampling_type: str = "lindisp"):
    """Normalized s in [0, 1] -> metric t (nerfacc construct_ray_warps).
    near / far: numbers (taken as f32, as JAX does) or per-ray [R] (or
    [R, 1]) tensors."""
    def col(v):
        if not isinstance(v, torch.Tensor):
            return np.float32(v)
        return v[:, None] if v.ndim == 1 else v

    near, far = col(near), col(far)
    if sampling_type == "uniform":
        return near + s * (far - near)
    return 1.0 / (1.0 / near * (1.0 - s) + 1.0 / far * s)


def uniform_edges(n_rays: int, n_samples: int, generator=None, jitter=None,
                  device="cpu"):
    """[n_rays, n_samples + 1] monotone edges in [0, 1]; stratified when a
    generator or a jitter is given (interior edges moved inside their
    half-cells)."""
    dev = torch.device(device)
    edges = _grid(n_samples, torch.empty(0, device=dev)).expand(
        n_rays, n_samples + 1)
    u = _jitter_of(n_rays, n_samples, dev, jitter, generator)
    if u is not None:
        edges = torch.clamp(edges + u * (1.0 / n_samples), 0.0, 1.0)
    return edges


def sample_from_weights(edges, weights, n_new: int, generator=None,
                        jitter=None, padding: float = 0.01):
    """Inverse-CDF resampling of interval edges (nerfacc importance
    sampling): edges [R, N + 1] and weights [R, N] (>= 0) -> [R, n_new + 1]
    ordered edges within [edges[:, 0], edges[:, -1]]."""
    r, n = weights.shape
    cdf = padded_cdf(weights, padding)
    u = _grid(n_new, edges).expand(r, n_new + 1)
    ju = _jitter_of(r, n_new, edges.device, jitter, generator)
    if ju is not None:
        u = torch.clamp(u + ju * (1.0 / n_new), 0.0, 1.0)
    return invert_cdf(edges, cdf, u.contiguous())


def padded_cdf(weights, padding: float = 0.01):
    """[R, N + 1] CDF of weights [R, N] with mip-NeRF 360's padding (every
    bin keeps padding / N), 0 first and exactly 1 last."""
    r, n = weights.shape
    weights = weights + padding / n
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    return torch.cat([pdf.new_zeros((r, 1)), _cumsum_last(pdf)[:, :-1],
                      pdf.new_ones((r, 1))], dim=-1)


def invert_cdf(edges, cdf, u):
    """Edges at the queries u [R, M] (non-decreasing in [0, 1]) through the
    piecewise-linear inverse of cdf [R, N + 1] over edges [R, N + 1]: the
    bin index and the linear position inside the bin."""
    n = cdf.shape[-1] - 1
    idx = torch.clamp(torch.searchsorted(cdf, u) - 1, 0, n - 1)
    cdf_lo = torch.gather(cdf, 1, idx)
    cdf_hi = torch.gather(cdf, 1, idx + 1)
    e_lo = torch.gather(edges, 1, idx)
    e_hi = torch.gather(edges, 1, idx + 1)
    denom = torch.clamp(cdf_hi - cdf_lo, min=1e-10)
    frac = torch.clamp((u - cdf_lo) / denom, 0.0, 1.0)
    return e_lo + frac * (e_hi - e_lo)


class PropSamples(NamedTuple):
    """Per-level records of the proposal loss."""

    s_edges: torch.Tensor  # [R, N + 1] s-space edges
    weights: torch.Tensor  # [R, N] rendering weights of the proposal field


def proposal_sampling(prop_density_fns: Sequence[Callable],
                      prop_samples: Sequence[int], n_final: int, origins,
                      viewdirs, near, far, *,
                      sampling_type: str = "lindisp",
                      generator: Optional[torch.Generator] = None,
                      jitters: Optional[Sequence[torch.Tensor]] = None,
                      anneal=1.0) -> Tuple[torch.Tensor, torch.Tensor,
                                           List[PropSamples]]:
    """Hierarchical PDF sampling through the proposal density fields
    (callables x [M, 3] -> density [M, 1], queried at interval midpoints).

    The jitter of level l's edges (l = 0: the initial uniform edges, then
    each resampling) is jitters[l] when given, else drawn from `generator`
    in that order; with neither the edges are deterministic (eval).
    `anneal` (a number or a 0-d tensor) is the exponent of the resampling
    weights. Returns (t_starts [R, n_final], t_ends [R, n_final],
    per-level records)."""
    n_rays = origins.shape[0]
    dev = origins.device
    jit = list(jitters) if jitters is not None else \
        [None] * (len(prop_samples) + 1)

    s_edges = uniform_edges(n_rays, prop_samples[0], generator, jit[0],
                            device=dev)
    records: List[PropSamples] = []
    for level, (density_fn, n_samples) in enumerate(zip(prop_density_fns,
                                                        prop_samples)):
        t_edges = s_to_t(s_edges, near, far, sampling_type)
        t0, t1 = t_edges[:, :-1], t_edges[:, 1:]
        mid = (t0 + t1) / 2.0
        pos = origins[:, None, :] + viewdirs[:, None, :] * mid[..., None]
        sigmas = density_fn(pos.reshape(-1, 3)).reshape(n_rays, n_samples)
        weights, _, _ = render_weights_from_density(
            t0, t1, sigmas, torch.ones_like(sigmas, dtype=torch.bool))
        records.append(PropSamples(s_edges=s_edges, weights=weights))
        n_next = (prop_samples[level + 1] if level + 1 < len(prop_samples)
                  else n_final)
        # annealing biases the resampling toward uniform early in training
        resample_w = weights.detach()
        if not (isinstance(anneal, (int, float)) and anneal == 1.0):
            resample_w = resample_w ** anneal
        s_edges = sample_from_weights(s_edges, resample_w, n_next, generator,
                                      jit[level + 1])

    t_edges = s_to_t(s_edges, near, far, sampling_type)
    return t_edges[:, :-1], t_edges[:, 1:], records


def _outer_measure(t_env, w_env, t_query):
    """Sum of envelope weights over each query interval (mip-NeRF 360
    outer measure): t_env [R, N + 1], w_env [R, N], t_query [R, M + 1] ->
    [R, M], the total weight of the envelope intervals that overlap
    [t_query[i], t_query[i + 1]]."""
    n = w_env.shape[-1]
    cw = torch.cat([torch.zeros_like(w_env[:, :1]), _cumsum_last(w_env)],
                   dim=-1)
    t_env = t_env.contiguous()
    idx_lo = torch.clamp(torch.searchsorted(
        t_env, t_query[:, :-1].contiguous(), right=True) - 1, 0, n)
    idx_hi = torch.clamp(torch.searchsorted(
        t_env, t_query[:, 1:].contiguous()), 0, n)
    w_outer = torch.gather(cw, 1, idx_hi) - torch.gather(cw, 1, idx_lo)
    return torch.clamp(w_outer, min=0.0)


def proposal_loss(records: List[PropSamples], final_s_edges, final_weights):
    """mip-NeRF 360 proposal loss, summed over levels, mean over rays:
    mean(clip(w_final - w_outer, 0)^2 / (w_final + 1e-7)), the final
    weights and edges stop-gradiented."""
    w = final_weights.detach()
    sq = final_s_edges.detach()
    total = 0.0
    for rec in records:
        w_outer = _outer_measure(rec.s_edges, rec.weights, sq)
        total = total + torch.mean(
            torch.clamp(w - w_outer, min=0.0) ** 2 / (w + 1e-7))
    return total


def anneal_factor(step, anneal_steps: int = 1000, slope: float = 10.0):
    """Proposal-weight annealing (nerfacc prop_net anneal), an f32 0-d
    tensor on `step`'s device (a number gives a CPU tensor)."""
    step = torch.as_tensor(step)
    frac = torch.clamp(step.to(torch.float32) / anneal_steps, 0.0, 1.0)
    return (slope * frac) / (1.0 + (slope - 1.0) * frac)
