"""Multi-level occupancy grid — port of cednerf_tpu/ops/occupancy.py.

This slice holds what serving needs: the grid state, its EMA update (run
once over all cells to fill a grid for a field), the ray/AABB slab test and
the fine and pooled-coarse occupancy lookups of the segment eval renderer.
Semantics are nerfacc's, as in the JAX package: nested AABB levels (level i
is the ROI scaled by 2^i), occs[cell] <- max(occs * ema_decay, new) with
binaries = occs > min(mean(occs), occ_thre), lookups against the finest
level containing the point. The marching and training-side functions come
with the training slice.
"""

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device


class OccGridState(NamedTuple):
    """occs [levels, res^3] (EMA density*step; -1 marks invisible cells),
    binaries [levels, res, res, res] bool, aabbs [levels, 6]."""

    occs: torch.Tensor
    binaries: torch.Tensor
    aabbs: torch.Tensor

    @property
    def resolution(self) -> int:
        return self.binaries.shape[-1]

    @property
    def levels(self) -> int:
        return self.binaries.shape[0]


def create_occ_grid(roi_aabb, resolution: int = 128, levels: int = 1,
                    device="cuda") -> OccGridState:
    """All-unoccupied grid with nested 2x AABB levels (nerfacc N1), on
    CUDA unless device="cpu" is asked for."""
    device = resolve_device(device)
    roi = np.asarray(roi_aabb, np.float32)
    center = (roi[:3] + roi[3:]) / 2.0
    half = (roi[3:] - roi[:3]) / 2.0
    aabbs = np.stack([np.concatenate([center - half * 2.0 ** l,
                                      center + half * 2.0 ** l])
                      for l in range(levels)])
    return OccGridState(
        occs=torch.zeros((levels, resolution ** 3), dtype=torch.float32,
                         device=device),
        binaries=torch.zeros((levels, resolution, resolution, resolution),
                             dtype=torch.bool, device=device),
        aabbs=torch.as_tensor(aabbs, dtype=torch.float32, device=device))


def _cell_coords(flat_idx: torch.Tensor, res: int) -> torch.Tensor:
    """flat -> (ix, iy, iz) with x slowest: flat = (ix*res + iy)*res + iz."""
    iz = flat_idx % res
    iy = (flat_idx // res) % res
    ix = flat_idx // (res * res)
    return torch.stack([ix, iy, iz], dim=-1)


def update_occ_grid(state: OccGridState,
                    density_fn: Callable[[torch.Tensor], torch.Tensor], *,
                    jitter: Optional[torch.Tensor] = None,
                    cells: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    occ_thre: float = 1e-2, ema_decay: float = 0.95,
                    sample_fraction: float = 0.25, all_cells: bool = False,
                    chunk: int = 2 ** 16) -> OccGridState:
    """One EMA occupancy update, forward only (no gradient flows here).

    density_fn: world positions [M, 3] -> [M, 1] density * render_step_size;
    a caller that probes at random times draws them inside density_fn.
    The random draws are injectable: `cells` [levels, M] int (ignored with
    all_cells=True, the warmup mode) and `jitter` [levels, M, 3] in [0, 1);
    whatever is not given is drawn from `generator` (on the state's device).
    """
    levels, n_cells = state.occs.shape
    res = state.resolution
    dev = state.occs.device
    aabb_min = state.aabbs[:, :3]
    aabb_size = state.aabbs[:, 3:] - state.aabbs[:, :3]

    if all_cells:
        cells = torch.arange(n_cells, device=dev).expand(levels, n_cells)
    elif cells is None:
        n_sample = int(n_cells * sample_fraction)
        cells = torch.randint(0, n_cells, (levels, n_sample), device=dev,
                              generator=generator)
    cells = cells.to(device=dev, dtype=torch.int64)
    if jitter is None:
        jitter = torch.rand((*cells.shape, 3), device=dev,
                            generator=generator)
    coords = _cell_coords(cells, res).float()                  # [levels, M, 3]
    x = aabb_min[:, None, :] + (coords + jitter.to(dev)) / res \
        * aabb_size[:, None, :]

    flat_x = x.reshape(-1, 3)
    occ = torch.cat([density_fn(flat_x[i:i + chunk]).reshape(-1)
                     for i in range(0, flat_x.shape[0], chunk)])
    occ = occ.float()

    # duplicate-safe EMA max-update: scatter-max the candidates, then combine
    # with the decayed old values only where a cell was actually sampled
    lvl_ids = torch.arange(levels, device=dev)[:, None].expand_as(cells)
    flat_idx = (lvl_ids * n_cells + cells).reshape(-1)
    cand = torch.full((levels * n_cells,), -torch.inf, device=dev)
    cand = cand.scatter_reduce(0, flat_idx, occ, reduce="amax")
    cand = cand.reshape(levels, n_cells)
    sampled = cand > -torch.inf
    occs = torch.where(sampled & (state.occs >= 0.0),
                       torch.maximum(state.occs * ema_decay,
                                     torch.clamp(cand, min=0.0)),
                       state.occs)
    visible = occs >= 0.0
    mean_occ = torch.where(visible, occs, 0.0).sum() \
        / torch.clamp(visible.sum(), min=1)
    thre = torch.clamp(mean_occ, max=occ_thre)
    binaries = (occs > thre).reshape(state.binaries.shape)
    return OccGridState(occs=occs, binaries=binaries, aabbs=state.aabbs)


def ray_aabb_intersect(origins: torch.Tensor, viewdirs: torch.Tensor,
                       aabb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab-test ray/AABB intersection: (t_min, t_max); t_min > t_max is a
    miss."""
    inv_d = 1.0 / torch.where(viewdirs.abs() < 1e-10,
                              torch.full_like(viewdirs, 1e-10), viewdirs)
    t0 = (aabb[:3] - origins) * inv_d
    t1 = (aabb[3:] - origins) * inv_d
    t_min = torch.minimum(t0, t1).amax(dim=-1)
    t_max = torch.maximum(t0, t1).amin(dim=-1)
    return torch.clamp(t_min, min=0.0), t_max


def _lookup(state: OccGridState, bits: torch.Tensor, pos: torch.Tensor):
    """bits[level, cell(pos)] at the finest level containing pos, False
    outside every level. bits: [levels, r, r, r] bool."""
    res = bits.shape[-1]
    amin = state.aabbs[:, :3]
    amax = state.aabbs[:, 3:]
    inside = torch.all((pos[..., None, :] >= amin)
                       & (pos[..., None, :] <= amax), dim=-1)   # [..., L]
    any_inside = inside.any(dim=-1)
    level = torch.argmax(inside.to(torch.uint8), dim=-1)   # first = finest
    lmin = amin[level]
    lsize = amax[level] - amin[level]
    u = (pos - lmin) / lsize
    ic = torch.clamp(torch.floor(u * res).to(torch.int64), 0, res - 1)
    hit = bits[level, ic[..., 0], ic[..., 1], ic[..., 2]]
    return hit & any_inside


def occupancy_lookup(state: OccGridState, pos: torch.Tensor) -> torch.Tensor:
    """Occupancy of positions [..., 3] -> bool [...] (nerfacc's multi-grid
    test against the smallest enclosing level)."""
    return _lookup(state, state.binaries, pos)


def _or_pool(bits: torch.Tensor, kernel: int, stride: int, padding: int = 0):
    """Boolean OR over 3D windows of [B, r, r, r] (max-pool of 0/1)."""
    out = F.max_pool3d(bits[:, None].float(), kernel, stride, padding)
    return out[:, 0] > 0


def pooled_binaries(state: OccGridState, pool: int = 4,
                    dilate: int = 1) -> torch.Tensor:
    """Conservative coarse occupancy for segment-level marching:
    [levels, res/pool, res/pool, res/pool] bool, set iff any fine cell in
    its pool^3 block -- or within `dilate` coarse cells -- is occupied at
    this level or any finer one (finer levels 2x-pooled into the centre
    half of the next). See the JAX docstring for the superset scope."""
    L, res = state.binaries.shape[0], state.resolution
    if res % pool or res % 4:
        raise ValueError(f"pooled_binaries: res {res} vs pool {pool}")
    combined = []
    prev = None
    for l in range(L):
        bits = state.binaries[l]
        if prev is not None:
            p2 = _or_pool(prev[None], 2, 2)[0]
            q = res // 4
            bits = bits | F.pad(p2, (q, q, q, q, q, q), value=False)
        combined.append(bits)
        prev = bits
    comb = torch.stack(combined)
    coarse = _or_pool(comb, pool, pool)
    if dilate:
        coarse = _or_pool(coarse, 2 * dilate + 1, 1, dilate)
    return coarse


def coarse_lookup(state: OccGridState, coarse: torch.Tensor,
                  pos: torch.Tensor) -> torch.Tensor:
    """occupancy_lookup against a pooled_binaries grid: [..., 3] -> bool."""
    return _lookup(state, coarse, pos)
