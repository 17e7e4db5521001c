"""Rendering — port of cednerf_tpu/engine/renderer.py: the packed, budgeted
train renderer (`compact_select`, `pack_candidates`, `pack_budget_samples`,
`march_segments`, `render_packed`, `render_rays_budget_packed`), the
dense-lattice renderers (`render_rays`, `render_rays_budget`), the
segment-compacted eval renderer (`make_eval_render_fn_seg`), the lattice
eval marcher (`LatticeEvalRenderer`: cone-angle configs and
budgeted=False), the `make_eval_render_fn` dispatch and the `render_image`
host loop.

Train path: the [R, M] candidate lattice is compacted to a fixed budget of
sample slots (kernel K4 on CUDA, ops/compact_kernels.py), each ray's
samples forming one contiguous segment; the field runs on the budget and
the compositing scans run on the packed buffer (ops/segments.py). Channel
scans are laid out [C, B] and run along the contiguous dim.

The JAX eval renderers are jitted programs whose pass loops are
`lax.while_loop`s. Here each loop is a Python loop on the host: each pass is
a run of eager PyTorch ops (a lattice pass also one K4 compaction, and each
pass one field forward through the brick-encoder kernel), and each loop
test reads its condition back with `.item()`, one device->host sync per
pass. The renderer counts its passes (`pass_log`) so
that the cost is visible; removing the syncs is later work.

Index semantics: every `jnp.take` of the JAX loop reads in-range indices
(checked against the index arithmetic), so plain indexing reproduces it; the
one out-of-range update, `.at[starts_c].add(1, mode="drop")`, where
starts_c may equal b_seg_p, is written as an index_add into one spare slot
that is then dropped.
"""

import math
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..ops import compact_kernels as ck
from ..ops.compact_kernels import compact_select_rayfold  # noqa: F401
from ..ops.occupancy import (OccGridState, RayCandidates, RaySamples,
                             coarse_lookup, march_candidates, march_rays,
                             march_t_lattice, occupancy_lookup,
                             pooled_binaries, ray_aabb_intersect,
                             stable_valid_order)
from ..ops.render import (composite, reduce_along_rays,
                          render_weights_from_density)
from ..ops.segments import segment_broadcast
from ..utils.math import exclusive_cumsum, row_cumsum
from .config import SceneConfig


class PackedSamples(NamedTuple):
    """A budgeted, ray-major packed sample batch ready for the field.

    Per slot ([budget]): pos [B, 3], dirs [B, 3], ts [B], t_starts [B],
    dts [B], valid [B] bool (False: padding), ray [B] (owning ray). Per ray
    ([R]): starts/counts (each ray's contiguous segment), complete (no valid
    sample of the ray was dropped). n_valid: the valid-sample demand before
    the budget cut."""

    pos: torch.Tensor
    dirs: torch.Tensor
    ts: torch.Tensor
    t_starts: torch.Tensor
    dts: torch.Tensor
    valid: torch.Tensor
    ray: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor
    complete: torch.Tensor
    n_valid: torch.Tensor


class RenderResult(NamedTuple):
    rgb: torch.Tensor        # [R, 3]
    opacity: torch.Tensor    # [R, 1]
    depth: torch.Tensor      # [R, 1]
    n_samples: torch.Tensor  # scalar: valid rendered samples
    extras: dict


def compact_select(valid: torch.Tensor, budget: int, n_blocks: int = 1):
    """Select up to `budget` valid candidates in flat (ray-major) order, in
    `n_blocks` contiguous ray blocks compacted to budget / n_blocks each.

    valid [R, M] bool -> (sel [budget] int32, ascending per block, R*M in
    unused slots; kept [R, M] bool; rank [R, M] int32, each kept
    candidate's slot). The plain form of the JAX function (one cumsum per
    block and a scatter of the unique destinations); the multi-block
    layout serves the CPU. Slots past a block's budget are written into a
    dropped spare column (JAX's mode="drop")."""
    r, m = valid.shape
    n = r * m
    if r % n_blocks or budget % n_blocks:
        raise ValueError(f"compact_select: {r} rays / budget {budget} do not "
                         f"split into {n_blocks} blocks")
    nb, bb = n // n_blocks, budget // n_blocks
    flat = valid.reshape(n_blocks, nb)
    dest = torch.cumsum(flat.to(torch.int64), dim=1) - 1
    write = flat & (dest < bb)
    col = torch.where(write, dest, torch.full_like(dest, bb))
    src = torch.arange(nb, device=valid.device).expand(n_blocks, nb)
    sel_b = torch.full((n_blocks, bb + 1), nb, dtype=torch.int64,
                       device=valid.device).scatter_(1, col, src)[:, :bb]
    blk = torch.arange(n_blocks, device=valid.device)[:, None]
    sel = torch.where(sel_b < nb, sel_b + blk * nb, torch.full_like(sel_b, n))
    rank = dest + blk * bb
    return (sel.reshape(-1).to(torch.int32), write.reshape(r, m),
            rank.reshape(r, m).to(torch.int32))


def _compact_sel_kept(valid: torch.Tensor, budget: int, n_blocks: int,
                      impl: str):
    """compact_select minus its rank output. Every single-block impl of the
    JAX dispatch ("rayfold", "xla", "pallas") returns the same bits, so one
    block always takes K4 (ops/compact_kernels.py): the kernel on CUDA, its
    plain version on the CPU; `impl` is kept for the JAX signature. Several
    blocks (the ray-parallel layout) run the plain compact_select on the CPU
    and raise on CUDA until the ray-parallel slice of the port."""
    if n_blocks == 1:
        return ck.compact_select_kernel(valid, budget)
    if valid.is_cuda:
        raise NotImplementedError(
            "compact_blocks > 1 (the multi-device compaction layout) comes "
            "with the ray-parallel slice of the port")
    sel, kept, _ = compact_select(valid, budget, n_blocks=n_blocks)
    return sel, kept


def pack_candidates(cand: RayCandidates, s_cap: int):
    """Per-ray compaction of the valid candidates into the first `s_cap`
    slots: (packed RayCandidates [R, s_cap], fits [R] bool, False where a
    ray had more than s_cap valid candidates and was cut). The slots hold
    what JAX's stable argsort of ~valid puts first (stable_valid_order)."""
    order = stable_valid_order(cand.valid, s_cap)

    def take(a):
        return torch.gather(a, 1, order)

    packed = RayCandidates(t_starts=take(cand.t_starts), dts=take(cand.dts),
                           valid=take(cand.valid), covered=cand.covered)
    return packed, cand.valid.sum(dim=-1) <= order.shape[1]


def _ray_info(origins, viewdirs, timestamps):
    """[R, 7] per-ray slot-gather source: origin | viewdir | timestamp."""
    r = origins.shape[0]
    ts = timestamps.reshape(-1)[:r].expand(r)
    return torch.cat([origins, viewdirs, ts[:, None]], dim=-1)


def _block_starts(counts, budget: int, n_blocks: int):
    """Per-ray packed-buffer segment starts from per-ray counts [R]: an
    exclusive cumsum per block plus the block's base, clamped to the budget
    (block overflow can push starts past the block; those rays are
    incomplete)."""
    r = counts.shape[0]
    rb, bb = r // n_blocks, budget // n_blocks
    cb = counts.reshape(n_blocks, rb).to(torch.int64)
    base = torch.arange(n_blocks, device=counts.device)[:, None] * bb
    starts = (torch.cumsum(cb, dim=1) - cb + base).reshape(-1)
    return torch.clamp(starts, max=budget)


def pack_budget_samples(origins, viewdirs, cand: RayCandidates, timestamps,
                        *, budget: int, n_blocks: int = 1,
                        ray_complete: Optional[torch.Tensor] = None,
                        compact_impl: str = "xla",
                        assembly_impl: str = "gather",
                        uniform_dt: Optional[float] = None) -> PackedSamples:
    """Cross-ray compaction of a dense candidate lattice into PackedSamples.

    assembly_impl "cumsum" broadcasts the per-ray columns to their slots
    with segment_broadcast, "gather" takes them by the owning ray. With
    uniform_dt (cone_angle == 0, unpacked lattice) a slot's t comes from
    its ray's broadcast t_min plus its lattice column times dt; rays with no
    kept sample get t_min 0, so that an AABB-miss ray's huge slab t_min
    cannot shift the telescoped values of later rays."""
    r, m = cand.valid.shape
    n = r * m
    sel, kept = _compact_sel_kept(cand.valid, budget, n_blocks, compact_impl)
    sel = sel.to(torch.int64)
    sel_valid = sel < n
    sel_c = torch.clamp(sel, max=n - 1)
    ray = sel_c // m
    counts = kept.sum(dim=-1).to(torch.int32)                      # [R]
    starts = _block_starts(counts, budget, n_blocks)
    cols = _ray_info(origins, viewdirs, timestamps)
    if assembly_impl == "cumsum":
        if uniform_dt is not None:
            tmin = torch.where(counts > 0, cand.t_starts[:, 0],
                               torch.zeros_like(cand.t_starts[:, 0]))
            cols = torch.cat([cols, tmin[:, None]], dim=-1)
        ri = segment_broadcast(cols, starts, budget, n_blocks)
    else:
        ri = cols[ray]
    o, d, ts = ri[:, 0:3], ri[:, 3:6], ri[:, 6]
    if assembly_impl == "cumsum" and uniform_dt is not None:
        j = (sel_c % m).to(torch.float32)
        t0s_p = ri[:, 7] + j * uniform_dt
        dts_p = torch.full((budget,), uniform_dt, dtype=torch.float32,
                           device=origins.device)
    else:
        t0s_p = cand.t_starts.reshape(-1)[sel_c]
        dts_p = cand.dts.reshape(-1)[sel_c]
    pos = o + d * (t0s_p + 0.5 * dts_p)[:, None]
    complete = torch.logical_not(
        torch.any(cand.valid & torch.logical_not(kept), dim=-1))
    if ray_complete is not None:
        complete = complete & ray_complete
    if cand.covered is not None:
        complete = complete & cand.covered
    return PackedSamples(pos=pos, dirs=d, ts=ts, t_starts=t0s_p, dts=dts_p,
                         valid=sel_valid, ray=ray, starts=starts,
                         counts=counts, complete=complete,
                         n_valid=cand.valid.sum())


def march_segments(occ_state: OccGridState, origins, viewdirs, timestamps,
                   *, budget: int, near_plane: float, far_plane: float,
                   render_step_size: float, cone_angle: float = 0.0,
                   max_march_steps: int = 1024, seg: int = 8,
                   overcommit: float = 1.5, pool: int = 4, n_blocks: int = 1,
                   jitter: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   compact_impl: str = "xla") -> PackedSamples:
    """Two-stage (segment -> sample) budgeted marching into PackedSamples.

    Stage A tests each `seg`-step segment once against the pooled, dilated
    coarse grid (a conservative superset) at the midpoint of its t-range
    clipped to t_max, and compacts the occupied segments into
    budget * overcommit / seg slots; stage B tests the fine samples inside
    the selected segments and compacts them into the budget. Both
    compactions are K4 on CUDA (_compact_sel_kept), so a step launches it
    twice. Slots stay ray-major and t-ascending, as on the dense path.
    The march jitter is `jitter` [R] in [0, 1) if given, else drawn from
    `generator` (march_t_lattice). n_valid extrapolates the fine-valid
    count over the segments that stage A cut. Single-level grids and
    uniform steps only, as in the JAX package."""
    if occ_state.levels != 1 or max_march_steps % seg:
        raise ValueError("march_segments: single-level grids and "
                         "max_march_steps % seg == 0 only")
    r = origins.shape[0]
    dev = origins.device
    m = max_march_steps
    ms = m // seg
    nseg = r * ms
    # segment-slot budget: a multiple of 8 * n_blocks
    sb = max(int(budget * overcommit) // seg, n_blocks * 8)
    sb = -(-sb // (8 * n_blocks)) * (8 * n_blocks)

    t0, dt, t_max = march_t_lattice(
        occ_state, origins, viewdirs, near_plane=near_plane,
        far_plane=far_plane, render_step_size=render_step_size,
        cone_angle=cone_angle, max_march_steps=max_march_steps,
        jitter=jitter, generator=generator)

    # stage A: coarse segment test + segment compaction
    coarse = pooled_binaries(occ_state, pool=pool, dilate=1)
    t_lo = t0[:, ::seg]                                            # [R, Ms]
    t_hi = t0[:, seg - 1::seg] + dt[:, seg - 1::seg]
    t_hi = torch.maximum(torch.minimum(t_hi, t_max[:, None]), t_lo)
    tm_seg = 0.5 * (t_lo + t_hi)
    pos_seg = origins[:, None, :] + viewdirs[:, None, :] * tm_seg[..., None]
    seg_valid = ((t_lo < t_max[:, None])
                 & coarse_lookup(occ_state, coarse, pos_seg))      # [R, Ms]
    seg_sel, seg_kept = _compact_sel_kept(seg_valid, sb, n_blocks,
                                          compact_impl)
    seg_sel = seg_sel.to(torch.int64)
    seg_ok = seg_sel < nseg
    seg_c = torch.clamp(seg_sel, max=nseg - 1)
    seg_ray = seg_c // ms                                          # [SB]
    ri = _ray_info(origins, viewdirs, timestamps)[seg_ray]         # [SB, 7]
    tl = torch.cat([t0.reshape(nseg, seg), dt.reshape(nseg, seg)], dim=-1)
    tv = tl[seg_c]
    t0_s, dt_s = tv[:, :seg], tv[:, seg:]                          # [SB, seg]

    # stage B: fine per-sample test + sample compaction
    pos_s = (ri[:, None, 0:3]
             + ri[:, None, 3:6] * (t0_s + 0.5 * dt_s)[..., None])  # [SB,seg,3]
    tmax_s = t_max[seg_ray]
    fine_valid = (occupancy_lookup(occ_state, pos_s)
                  & (t0_s < tmax_s[:, None]) & seg_ok[:, None])    # [SB, seg]
    n2 = sb * seg
    sel2, kept2 = _compact_sel_kept(fine_valid, budget, n_blocks,
                                    compact_impl)
    sel2 = sel2.to(torch.int64)
    ok2 = sel2 < n2
    c2 = torch.clamp(sel2, max=n2 - 1)
    sidx = c2 // seg                                               # [B] -> SB
    spack = torch.cat([pos_s.reshape(n2, 3), t0_s.reshape(n2, 1),
                       dt_s.reshape(n2, 1)], dim=-1)               # [n2, 5]
    sv = spack[c2]
    pos_p, t0_p, dt_p = sv[:, 0:3], sv[:, 3], sv[:, 4]
    d_p, ts_p = ri[sidx, 3:6], ri[sidx, 6]
    ray_p = seg_ray[sidx]

    # per-ray layout and accounting
    cnt_seg = kept2.sum(dim=-1)                                    # [SB]
    counts = torch.zeros(r, dtype=torch.int64, device=dev).index_add_(
        0, seg_ray, cnt_seg).to(torch.int32)
    starts = _block_starts(counts, budget, n_blocks)
    drop_a = torch.any(seg_valid & torch.logical_not(seg_kept), dim=-1)
    drop_b_seg = torch.any(fine_valid & torch.logical_not(kept2), dim=-1)
    drop_b = torch.zeros(r, dtype=torch.int64, device=dev).scatter_reduce(
        0, seg_ray, drop_b_seg.to(torch.int64), reduce="amax") > 0
    complete = torch.logical_not(drop_a | drop_b)
    # demand feedback: fine-valid density extrapolated over cut segments
    nv_fine = fine_valid.sum().float()
    segs_valid = seg_valid.sum().float()
    segs_kept = (seg_valid & seg_kept).sum().float()
    n_valid = (nv_fine * segs_valid
               / torch.clamp(segs_kept, min=1.0)).to(torch.int32)
    return PackedSamples(pos=pos_p, dirs=d_p, ts=ts_p, t_starts=t0_p,
                         dts=dt_p, valid=ok2, ray=ray_p, starts=starts,
                         counts=counts, complete=complete, n_valid=n_valid)


def render_packed(field, ps: PackedSamples, render_bkgd,
                  occ_mean: Optional[torch.Tensor] = None, *, budget: int,
                  alpha_thre: float = 0.0, train: bool = True,
                  n_blocks: int = 1,
                  assembly_impl: str = "gather") -> RenderResult:
    """Field evaluation + packed compositing on a PackedSamples batch.

    Per-ray exclusive transmittance prefixes are the global exclusive
    cumsum minus each ray's base prefix (a gather at segment starts,
    broadcast to the slots); per-ray sums are boundary differences of one
    exclusive cumsum of the [5, B] channels (w*rgb, w, w*t_mid). The
    exponent is clamped at 0 so that a block's invalid tail slots, whose
    base lies after them, cannot produce inf * 0. extras carries the
    per-slot fields (suffix _p) and ray/starts/counts for ops/losses.py.
    The field's parameters are the module's own (`field` is a
    DNGPRadianceField), where the JAX function takes a params tree."""
    ray, starts, counts = ps.ray, ps.starts, ps.counts
    t0s_p, dts_p = ps.t_starts, ps.dts
    rgb_c, res_c = field(ps.pos, ps.ts[:, None], ps.dirs,
                         return_internal=train)
    sigmas_p = res_c["density"].float().reshape(-1)
    rgbs_p = rgb_c.float()
    valid_p = ps.valid
    if alpha_thre > 0:
        thre = alpha_thre if occ_mean is None else torch.clamp(
            occ_mean, max=alpha_thre)
        alpha_raw = 1.0 - torch.exp(-sigmas_p.detach() * dts_p)
        valid_p = valid_p & (alpha_raw > thre)
    vf = valid_p.float()

    sdelta_p = sigmas_p * dts_p * vf
    excl_sd = exclusive_cumsum(sdelta_p, dim=0)                   # [B]
    base_sd = torch.cat([excl_sd, sdelta_p.sum().reshape(1)])[starts]
    if assembly_impl == "cumsum":
        base_b = segment_broadcast(base_sd, starts, budget, n_blocks)
    else:
        base_b = base_sd[ray]
    trans_p = torch.exp(-torch.clamp(excl_sd - base_b, min=0.0))
    alphas_p = 1.0 - torch.exp(-sdelta_p)
    weights_p = trans_p * alphas_p * vf

    t_mid_p = t0s_p + 0.5 * dts_p
    chans = torch.cat([(weights_p[:, None] * rgbs_p).t(), weights_p[None],
                       (weights_p * t_mid_p)[None]], dim=0)       # [5, B]
    zx = torch.cat([chans.new_zeros(5, 1), torch.cumsum(chans, dim=1)],
                   dim=1)
    lo = zx[:, starts]
    hi = zx[:, torch.clamp(starts + counts, max=budget)]
    sums = (hi - lo).t()                                          # [R, 5]
    rgb = sums[:, 0:3]
    opacity = sums[:, 3:4]
    depth = sums[:, 4:5] / torch.clamp(opacity, min=1.1920929e-07)
    if render_bkgd is not None:
        rgb = rgb + render_bkgd * (1.0 - opacity)

    extras = {
        "packed": True, "weights_p": weights_p, "trans_p": trans_p,
        "sigmas_p": sigmas_p, "rgbs_p": rgbs_p, "t_starts_p": t0s_p,
        "dts_p": dts_p, "valid_p": vf, "ray": ray, "starts": starts,
        "counts": counts, "complete": ps.complete.float(),
        "n_valid": ps.n_valid,
    }
    internal = res_c.get("internal") if train else None
    if internal is not None:
        if "latent_losses" in internal:
            extras["latent_p"] = internal["latent_losses"].mean(-1).float()
        if "weight_losses" in internal:
            from ..models.field import huber
            wl = huber(internal["weight_losses"].float()[:, 0], trans_p)
            extras["weight_loss_p"] = wl * internal["selector"].float()
    return RenderResult(rgb=rgb, opacity=opacity, depth=depth,
                        n_samples=vf.sum(), extras=extras)


def render_rays_budget_packed(field, origins, viewdirs, cand: RayCandidates,
                              timestamps, render_bkgd,
                              occ_mean: Optional[torch.Tensor] = None, *,
                              budget: int, alpha_thre: float = 0.0,
                              train: bool = True, n_blocks: int = 1,
                              ray_complete: Optional[torch.Tensor] = None,
                              compact_impl: str = "xla",
                              assembly_impl: str = "gather",
                              uniform_dt: Optional[float] = None
                              ) -> RenderResult:
    """pack_budget_samples + render_packed on a dense candidate lattice (the
    budgeted packed-compositing train path)."""
    ps = pack_budget_samples(
        origins, viewdirs, cand, timestamps, budget=budget,
        n_blocks=n_blocks, ray_complete=ray_complete,
        compact_impl=compact_impl, assembly_impl=assembly_impl,
        uniform_dt=uniform_dt)
    return render_packed(field, ps, render_bkgd, occ_mean, budget=budget,
                         alpha_thre=alpha_thre, train=train,
                         n_blocks=n_blocks, assembly_impl=assembly_impl)


def _field_on_selected(field, valid, t_starts, dts, ray_info, *, budget: int,
                       n_blocks: int = 1, compact_impl: str = "xla",
                       train: bool = False):
    """The cross-ray compaction of a dense [R, M] lattice (K4 on CUDA) and
    the field on the selected slots: (sel [budget] int64, kept [R, M],
    rgb [budget, 3], the field's result dict). Slots the budget leaves
    unused have sel >= R*M and evaluate the lattice's last slot."""
    r, m = valid.shape
    n = r * m
    sel, kept = _compact_sel_kept(valid, budget, n_blocks, compact_impl)
    sel = sel.to(torch.int64)
    sel_c = torch.clamp(sel, max=n - 1)
    ri = ray_info[sel_c // m]
    d = ri[:, 3:6]
    pos = ri[:, 0:3] + d * (t_starts.reshape(-1)[sel_c]
                            + 0.5 * dts.reshape(-1)[sel_c])[:, None]
    rgb_c, res_c = field(pos, ri[:, 6:7], d, return_internal=train)
    return sel, kept, rgb_c, res_c


def _scatter_selected(rows, sel, n: int):
    """Rows of the selected slots [budget, K] back into the dense [n, K]
    lattice; the rows of unused slots are zeroed and land in a spare row
    that is dropped (JAX's .at[].set(mode="drop"))."""
    sel_valid = sel < n
    scat = torch.where(sel_valid, sel, torch.full_like(sel, n))
    return rows.new_zeros((n + 1, rows.shape[-1])).index_copy(
        0, scat, rows * sel_valid[:, None])[:n]


def _composite_lattice(sigmas, rgbs, t_starts, t_ends, dts, mask,
                       render_bkgd, occ_mean=None, *, alpha_thre: float = 0.0,
                       latent=None, weight_pred=None, selector=None
                       ) -> RenderResult:
    """Compositing of the field's outputs on a dense [R, S] lattice: the
    alpha_thre pruning on the slot dts (nerfacc prunes samples whose
    standalone alpha <= alpha_thre before the transmittance scan,
    cednerf/utils.py:115-125; occ_mean clamps the threshold during
    training), the weights and the composite. latent [R, S, K] gives
    extras["latent_losses"], the weight-scaled per-ray sums
    (cednerf/render.py:105-113); weight_pred and selector [R, S] give
    extras["weight_losses"], huber(predicted weight, transmittance) *
    selector as weight-scaled per-ray means (cednerf/render.py:114-124)."""
    if alpha_thre > 0:
        thre = alpha_thre if occ_mean is None else torch.clamp(
            occ_mean, max=alpha_thre)
        alpha_raw = 1.0 - torch.exp(-sigmas.detach() * dts)
        mask = mask & (alpha_raw > thre)
    weights, trans, alphas = render_weights_from_density(t_starts, t_ends,
                                                         sigmas, mask)
    rgb, opacity, depth = composite(weights, rgbs, t_starts, t_ends, mask,
                                    render_bkgd)
    extras = {"weights": weights, "trans": trans, "alphas": alphas,
              "sigmas": sigmas, "rgbs": rgbs, "mask": mask,
              "t_starts": t_starts, "t_ends": t_ends}
    if latent is not None:
        extras["latent_losses"] = reduce_along_rays(
            latent, mask, weights=weights.detach(), reduce="sum")
    if weight_pred is not None:
        from ..models.field import huber
        wl = huber(weight_pred, trans) * selector
        extras["weight_losses"] = reduce_along_rays(
            wl[..., None], mask, weights=weights, reduce="mean")
    return RenderResult(rgb=rgb, opacity=opacity, depth=depth,
                        n_samples=mask.sum(), extras=extras)


def render_rays_budget(field, origins, viewdirs, cand: RayCandidates,
                       timestamps, render_bkgd,
                       occ_mean: Optional[torch.Tensor] = None, *,
                       budget: int, alpha_thre: float = 0.0,
                       train: bool = True, n_blocks: int = 1,
                       ray_complete: Optional[torch.Tensor] = None,
                       compact_impl: str = "xla") -> RenderResult:
    """The dense-lattice train renderer (cfg.packed_render=False): the field
    runs on at most `budget` valid candidates (_field_on_selected), its
    outputs are scattered back into the dense [R*M] lattice and the
    compositing runs there (_composite_lattice). extras["complete"] is 1.0
    for rays none of whose valid samples the budget dropped (ANDed with
    ray_complete and cand.covered), as on the packed path."""
    r, m = cand.valid.shape
    sel, kept, rgb_c, res_c = _field_on_selected(
        field, cand.valid, cand.t_starts, cand.dts,
        _ray_info(origins, viewdirs, timestamps), budget=budget,
        n_blocks=n_blocks, compact_impl=compact_impl, train=train)

    # the per-sample outputs packed into one row and scattered back once
    cols = [res_c["density"].float().reshape(-1, 1), rgb_c.float()]
    internal = res_c.get("internal") if train else None
    has_latent = internal is not None and "latent_losses" in internal
    has_weight = internal is not None and "weight_losses" in internal
    if has_latent:
        # channel mean first: the mean over rays and channels of
        # sum_s w * h[s, c] is the mean over rays of sum_s w * mean_c h
        cols.append(internal["latent_losses"].float().mean(-1, keepdim=True))
    if has_weight:
        cols += [internal["weight_losses"].float(),
                 internal["selector"].float()[:, None]]
    dense = _scatter_selected(torch.cat(cols, dim=-1), sel, r * m)
    out = _composite_lattice(
        dense[:, 0].reshape(r, m), dense[:, 1:4].reshape(r, m, 3),
        cand.t_starts, cand.t_ends, cand.dts, kept, render_bkgd, occ_mean,
        alpha_thre=alpha_thre,
        latent=dense[:, 4:5].reshape(r, m, 1) if has_latent else None,
        weight_pred=dense[:, -2].reshape(r, m) if has_weight else None,
        selector=dense[:, -1].reshape(r, m) if has_weight else None)
    complete = torch.logical_not(
        torch.any(cand.valid & torch.logical_not(kept), dim=-1))
    if ray_complete is not None:
        complete = complete & ray_complete
    if cand.covered is not None:
        complete = complete & cand.covered
    out.extras.update(complete=complete.float(), n_valid=cand.valid.sum())
    return out


def render_rays(field, origins, viewdirs, samples: RaySamples, timestamps,
                render_bkgd, occ_mean: Optional[torch.Tensor] = None, *,
                alpha_thre: float = 0.0, train: bool = False) -> RenderResult:
    """The field on padded [R, S] samples, composited along rays
    (_composite_lattice). timestamps: [R, 1] per-ray times or anything that
    broadcasts (a scalar). train=True adds the latent and weight losses of
    the field's internals to extras, as the JAX proposal trainer
    (engine/train_prop.py) reads them. The JAX compact_budget truncation
    is left out: no caller in either package sets it."""
    r, s = samples.t_starts.shape
    t_mid = (samples.t_starts + samples.t_ends) / 2.0
    pos = origins[:, None, :] + viewdirs[:, None, :] * t_mid[..., None]
    dirs = viewdirs[:, None, :].expand(r, s, 3)
    t = torch.as_tensor(timestamps, dtype=torch.float32,
                        device=origins.device).reshape(-1, 1, 1).expand(
        r, s, 1)
    rgbs, res = field(pos.reshape(-1, 3), t.reshape(-1, 1),
                      dirs.reshape(-1, 3), return_internal=train)
    internal = (res.get("internal") or {}) if train else {}
    has_weight = "weight_losses" in internal
    return _composite_lattice(
        res["density"].reshape(r, s).float(), rgbs.reshape(r, s, 3),
        samples.t_starts, samples.t_ends, samples.t_ends - samples.t_starts,
        samples.mask, render_bkgd, occ_mean, alpha_thre=alpha_thre,
        latent=(internal["latent_losses"].reshape(r, s, -1)
                if "latent_losses" in internal else None),
        weight_pred=(internal["weight_losses"].reshape(r, s).float()
                     if has_weight else None),
        selector=(internal["selector"].reshape(r, s) if has_weight
                  else None))


def _seg_dilate(cfg: SceneConfig, seg: int, pool: int) -> int:
    """Coarse-grid dilation that makes one segment-midpoint probe a superset
    test (see the JAX docstring)."""
    aabb = cfg.aabb
    size = min(aabb[3] - aabb[0], aabb[4] - aabb[1], aabb[5] - aabb[2])
    cell = size / cfg.grid_resolution
    coarse_cell = cell * pool
    reach = seg * cfg.render_step_size / 2.0 + math.sqrt(3.0) * cell
    return max(1, int(math.ceil(reach / coarse_cell)))


class SegEvalRenderer:
    """Segment-compacted eval renderer: fn(occ_state, origins [C,3],
    viewdirs [C,3], timestamp, render_bkgd [3]) -> (rgb, opacity, depth).

    Same algorithm as the JAX make_eval_render_fn_seg: occupancy probed per
    `seg`-step segment on a pooled, dilated coarse grid; each ray's occupied
    segments packed once; per pass an adaptive per-ray cursor window of
    segments is assigned to a fixed budget of slots, the field runs on them,
    and packed compositing carries each ray's transmittance across passes;
    the budget cascades full -> /4 -> /16 while the remaining demand exceeds
    the next phase's budget; rays stop at transmittance < early_stop_eps or
    after their first s_max valid samples.

    pass_log: per rendered chunk, the number of passes of each cascade phase.
    """

    def __init__(self, field, cfg: SceneConfig, s_max: Optional[int] = None,
                 budget_per_ray: int = 64, early_stop_eps: float = 1e-4,
                 seg: int = 8, pool: int = 4):
        if cfg.cone_angle != 0.0:
            raise NotImplementedError(
                "seg eval path: uniform steps only (cone_angle == 0); "
                "cone-angle configs take the lattice marcher "
                "(make_eval_render_fn impl='lattice')")
        self.field = field
        self.cfg = cfg
        self.s_max = s_max or cfg.eval_s_max
        self.budget_per_ray = budget_per_ray
        self.early_stop_eps = early_stop_eps
        self.seg = seg
        self.pool = pool
        self.ms = -(-cfg.max_march_steps // seg)
        self.dilate = _seg_dilate(cfg, seg, pool)
        self.pass_log: List[List[int]] = []

    @torch.inference_mode()
    def __call__(self, occ_state: OccGridState, origins, viewdirs, timestamp,
                 render_bkgd):
        cfg, seg, ms, s_max = self.cfg, self.seg, self.ms, self.s_max
        step = cfg.render_step_size
        seg_len = seg * step
        dev = origins.device
        c = origins.shape[0]
        nseg = c * ms
        b_seg = max((self.budget_per_ray * c) // seg, 8)
        b_seg = min(-(-b_seg // 8) * 8, -(-nseg // 8) * 8)

        coarse = pooled_binaries(occ_state, pool=self.pool,
                                 dilate=self.dilate)
        t_min, t_max = ray_aabb_intersect(origins, viewdirs,
                                          occ_state.aabbs[-1])
        t_min = torch.clamp(t_min, min=cfg.near_plane)
        t_max = torch.clamp(t_max, max=cfg.far_plane)

        # coarse segment probes (once per chunk)
        s = torch.arange(ms, dtype=torch.float32, device=dev)
        t_lo = t_min[:, None] + s[None, :] * seg_len                 # [C, Ms]
        t_hi = torch.maximum(torch.minimum(t_lo + seg_len, t_max[:, None]),
                             t_lo)
        fracs = (0.25, 0.5, 0.75) if occ_state.levels > 1 else (0.5,)
        hit = None
        for f in fracs:
            tm = t_lo + f * (t_hi - t_lo)
            pos = origins[:, None, :] + viewdirs[:, None, :] * tm[..., None]
            h = coarse_lookup(occ_state, coarse, pos)
            hit = h if hit is None else (hit | h)
        seg_valid = (t_lo < t_max[:, None]) & hit                    # [C, Ms]

        # each ray's occupied segment indices, occupied first, t-ascending
        order_flat = torch.argsort(
            torch.logical_not(seg_valid).to(torch.uint8), dim=-1,
            stable=True).reshape(-1)
        n_segs = seg_valid.sum(dim=-1)                               # [C]

        ray_info = torch.cat([origins, viewdirs, t_min[:, None],
                              t_max[:, None]], dim=-1)
        k_off = torch.arange(seg, device=dev)[None, :]               # [1, seg]
        ts = float(timestamp)

        def rem_total_of(cursor, emitted, alive):
            rem = torch.clamp(n_segs - cursor, min=0) * alive
            segcap = torch.clamp((s_max - emitted + seg - 1) // seg, min=0)
            return torch.minimum(rem, segcap).sum()

        def one_pass(b_seg_p, carry):
            cursor, trans, emitted, acc, alive = carry
            b_p = b_seg_p * seg
            slot_i = torch.arange(b_seg_p, device=dev)
            rem = torch.clamp(n_segs - cursor, min=0) * alive
            n_alive = torch.clamp((rem > 0).sum(), min=1)
            k_seg = torch.clamp(b_seg_p // n_alive, min=1)
            take = torch.minimum(rem, k_seg)                          # [C]
            start = torch.cumsum(take, 0) - take
            consumed = torch.minimum(torch.clamp(b_seg_p - start, min=0),
                                     take)
            total = torch.clamp(take.sum(), max=b_seg_p)
            starts_c = torch.clamp(start, max=b_seg_p)
            end_row = torch.clamp(start + consumed, max=b_seg_p)

            # slot -> owning ray; a start at b_seg_p is dropped (JAX
            # .at[].add(mode="drop")) by landing in the spare last slot
            counts = torch.zeros(b_seg_p + 1, dtype=torch.int64, device=dev)
            counts.index_add_(0, starts_c, torch.ones_like(starts_c))
            ray = torch.clamp(torch.cumsum(counts[:b_seg_p], 0) - 1, 0, c - 1)
            off = slot_i - starts_c[ray]
            slot_used = slot_i < total
            cur_r = cursor[ray]
            sidx = order_flat[ray * ms + torch.clamp(cur_r + off, max=ms - 1)]

            ri = ray_info[ray]
            o, d = ri[:, 0:3], ri[:, 3:6]
            tmin_r, tmax_r = ri[:, 6], ri[:, 7]
            jj = sidx[:, None] * seg + k_off                         # [SB, seg]
            t0_s = tmin_r[:, None] + jj.float() * step
            t_pos = torch.minimum(t0_s, tmax_r[:, None])
            pos = o[:, None, :] + d[:, None, :] * (t_pos + 0.5 * step)[..., None]
            fine_valid = (occupancy_lookup(occ_state, pos)
                          & (t0_s < tmax_r[:, None]) & slot_used[:, None])

            # exact per-ray s_max cap: rank of each fine-valid sample in its ray
            fvi = fine_valid.to(torch.int64)
            lane_fv = torch.cumsum(fvi, 1)
            row_fv = lane_fv[:, -1]
            row_fv_cum = torch.cumsum(row_fv, 0)
            row_fv_ext = torch.cat([row_fv_cum.new_zeros(1), row_fv_cum])
            base_rank = row_fv_ext[starts_c]
            rank = ((row_fv_cum - row_fv) - base_rank[ray])[:, None] \
                + (lane_fv - fvi)
            em_slot = emitted[ray]
            keep_cap = fine_valid & ((em_slot[:, None] + rank) < s_max)

            tq = torch.full((b_p, 1), ts, dtype=torch.float32, device=dev)
            dirs = d[:, None, :].expand(b_seg_p, seg, 3).reshape(b_p, 3)
            rgb_c, res_c = self.field(pos.reshape(b_p, 3), tq, dirs)
            sig = res_c["density"].float().reshape(-1, seg)
            keep = keep_cap
            if cfg.alpha_thre > 0:
                alpha_raw = 1.0 - torch.exp(-sig * step)
                keep = keep & (alpha_raw > cfg.alpha_thre)
            keep_f = keep.float()

            # optical depth, NaN-scrubbed and capped at 80 (exp(-80) == 0)
            sdelta = torch.clamp(torch.nan_to_num(sig * step), max=80.0) \
                * keep_f
            lane_sd = torch.cumsum(sdelta, 1)
            row_sd = lane_sd[:, -1]
            row_sd_cum = row_cumsum(row_sd)
            row_sd_ext = torch.cat([row_sd_cum.new_zeros(1), row_sd_cum])
            base_sd = row_sd_ext[starts_c]
            ex_sd = (row_sd_cum - row_sd)[:, None] + (lane_sd - sdelta)
            t_slot = trans[ray][:, None] * torch.exp(
                -torch.clamp(ex_sd - base_sd[ray][:, None], min=0.0))
            alphas = 1.0 - torch.exp(-sdelta)
            w = t_slot * alphas

            # composite channels + the emit count in ONE row scan; per-ray
            # sums are boundary differences at row level. The channels are
            # laid out [6, SB] so the scan runs along the contiguous dim: a
            # dim-0 cumsum of [SB, 6] takes PyTorch's outer-dim scan kernel,
            # which took ~28 ms of a ~52 ms pass on an H100 at 262144 rows
            # (profile_serving.py).
            t_mid = t0_s + 0.5 * step
            # NaN-scrubbed like the optical depth: one NaN colour would
            # poison the shared scan for every later ray of the chunk
            rgbs = torch.nan_to_num(rgb_c.float()).reshape(-1, seg, 3)
            chans = torch.cat(
                [torch.sum(w[..., None] * rgbs, dim=1).t(),
                 torch.sum(w, dim=1)[None],
                 torch.sum(w * t_mid, dim=1)[None],
                 torch.sum(keep_cap, dim=1)[None].float()],
                dim=0)                                               # [6, SB]
            z = torch.cumsum(chans, 1)
            z_ext = torch.cat([z.new_zeros(6, 1), z], dim=1)
            sums = (z_ext[:, end_row] - z_ext[:, starts_c]).t()      # [C, 6]
            acc = acc + sums[:, :5]
            emitted = emitted + sums[:, 5].to(torch.int64)
            od = row_sd_ext[end_row] - row_sd_ext[starts_c]
            trans = trans * torch.exp(-od)
            cursor = cursor + consumed
            alive = alive & (trans > self.early_stop_eps) & (emitted < s_max)
            return cursor, trans, emitted, acc, alive

        ladder = []
        for div in (1, 4, 16):
            bs = -(-max(b_seg // div, 8) // 8) * 8
            if not ladder or bs < ladder[-1]:
                ladder.append(bs)
        carry = (torch.zeros(c, dtype=torch.int64, device=dev),
                 torch.ones(c, dtype=torch.float32, device=dev),
                 torch.zeros(c, dtype=torch.int64, device=dev),
                 torch.zeros((c, 5), dtype=torch.float32, device=dev),
                 n_segs > 0)
        passes = []
        for i, bs in enumerate(ladder):
            nxt = ladder[i + 1] if i + 1 < len(ladder) else 0
            n_pass = 0
            # one device->host sync per loop test (the JAX while_loop's
            # condition, read back to drive the Python loop)
            while bool((torch.any(carry[4] & (carry[0] < n_segs))
                        & (rem_total_of(carry[0], carry[2], carry[4]) > nxt))
                       .item()):
                carry = one_pass(bs, carry)
                n_pass += 1
            passes.append(n_pass)
        self.pass_log.append(passes)
        acc = carry[3]
        opacity = acc[:, 3:4]
        depth = acc[:, 4:5] / torch.clamp(opacity, min=1.1920929e-07)
        bkgd = torch.as_tensor(render_bkgd, dtype=torch.float32, device=dev)
        rgb = acc[:, 0:3] + bkgd * (1.0 - opacity)
        return rgb, opacity, depth


def make_eval_render_fn_seg(field, cfg: SceneConfig,
                            s_max: Optional[int] = None,
                            budget_per_ray: int = 64,
                            early_stop_eps: float = 1e-4,
                            seg: int = 8, pool: int = 4) -> SegEvalRenderer:
    """Segment-compacted eval renderer (the fast inference path)."""
    return SegEvalRenderer(field, cfg, s_max=s_max,
                           budget_per_ray=budget_per_ray,
                           early_stop_eps=early_stop_eps, seg=seg, pool=pool)


class LatticeEvalRenderer:
    """The lattice eval marcher: fn(occ_state, origins [C,3], viewdirs [C,3],
    timestamp, render_bkgd [3]) -> (rgb, opacity, depth). The JAX
    make_eval_render_fn's lattice branch, its path for cone-angle configs
    (the HyperNeRF and DyNeRF presets) and for budgeted=False.

    The full [C, max_march_steps] candidate lattice is marched
    (march_candidates, geometric steps under cone_angle) and each ray keeps
    its first s_max valid candidates (the per-ray max_samples contract).

    budgeted=True packs those into a [C, m] lattice once (m = min(s_max,
    max_march_steps), slot = the candidate's valid rank), then runs passes
    until no candidate remains: each pass compacts the remaining candidates
    to budget = min(budget_per_ray * C, C * m) slots (K4 on CUDA), runs the
    field on them, scatters density and rgb back into the dense [C*m, 4]
    buffer (unused slots into a spare row that is dropped), applies the
    alpha_thre mask on the packed dts, composites with the transmittance
    carried from earlier passes (render_weights_from_density's
    prefix_trans) and drops the rays whose transmittance fell to
    early_stop_eps. The results are exact up to the s_max cap and the early
    stop, for any budget. budgeted=False is one dense pass of render_rays
    over each ray's first s_max candidates.

    pass_log: per rendered chunk, [passes] (budgeted=False logs [1])."""

    def __init__(self, field, cfg: SceneConfig, s_max: Optional[int] = None,
                 budgeted: bool = True, budget_per_ray: int = 64,
                 early_stop_eps: float = 1e-4):
        self.field = field
        self.cfg = cfg
        self.s_max = s_max or cfg.eval_s_max
        self.budgeted = budgeted
        self.budget_per_ray = budget_per_ray
        self.early_stop_eps = early_stop_eps
        self.pass_log: List[List[int]] = []

    @torch.inference_mode()
    def __call__(self, occ_state: OccGridState, origins, viewdirs, timestamp,
                 render_bkgd):
        cfg, s_max = self.cfg, self.s_max
        dev = origins.device
        r = origins.shape[0]
        t = torch.as_tensor(timestamp, dtype=torch.float32,
                            device=dev).reshape(1, 1).expand(r, 1)
        bkgd = torch.as_tensor(render_bkgd, dtype=torch.float32, device=dev)
        march = dict(near_plane=cfg.near_plane, far_plane=cfg.far_plane,
                     render_step_size=cfg.render_step_size,
                     cone_angle=cfg.cone_angle,
                     max_march_steps=cfg.max_march_steps)
        if not self.budgeted:
            # each ray's first s_max valid candidates, in one dense pass
            samples = march_rays(occ_state, origins, viewdirs, s_max=s_max,
                                 **march)
            out = render_rays(self.field, origins, viewdirs, samples, t,
                              bkgd, alpha_thre=cfg.alpha_thre)
            self.pass_log.append([1])
            return out.rgb, out.opacity, out.depth

        cand = march_candidates(occ_state, origins, viewdirs, **march)
        # per-ray max_samples cap: only the first s_max valid candidates
        vcum = torch.cumsum(cand.valid.to(torch.int32), dim=-1)
        valid = cand.valid & (vcum <= s_max)

        # each ray's first s_max valid candidates packed into [C, m] once
        # (slot = valid rank, order kept): every per-pass op then runs at
        # m slots instead of max_march_steps
        m = min(s_max, valid.shape[1])
        n = r * m
        ray_idx = torch.arange(r, device=dev)[:, None]
        dst = torch.where(valid, ray_idx * m + (vcum - 1).to(torch.int64),
                          torch.full_like(ray_idx, n)).reshape(-1)
        lat = torch.stack([cand.t_starts, cand.t_ends, cand.dts],
                          dim=-1).reshape(-1, 3)
        packed = lat.new_zeros((n + 1, 3)).index_copy_(0, dst, lat)[:n]
        p_t0, p_t1, p_dts = (packed[:, i].reshape(r, m) for i in range(3))
        p_valid = (torch.arange(m, device=dev)[None, :]
                   < vcum[:, -1:].clamp(max=m))
        t_mid = (p_t0 + p_t1) / 2.0

        budget = min(self.budget_per_ray * r, n)
        ray_info = _ray_info(origins, viewdirs, t)
        remaining = p_valid
        trans = torch.ones(r, dtype=torch.float32, device=dev)
        rgb_acc = torch.zeros((r, 3), dtype=torch.float32, device=dev)
        opac_acc = torch.zeros(r, dtype=torch.float32, device=dev)
        depth_acc = torch.zeros(r, dtype=torch.float32, device=dev)
        n_pass = 0
        # one device->host sync per loop test (the JAX while_loop's
        # condition, read back to drive the Python loop)
        while bool(remaining.any().item()):
            sel, kept, rgb_c, res_c = _field_on_selected(
                self.field, remaining, p_t0, p_dts, ray_info, budget=budget,
                compact_impl=cfg.compact_impl)
            dense = _scatter_selected(
                torch.cat([res_c["density"].float().reshape(-1, 1),
                           rgb_c.float()], dim=-1), sel, n)
            sigmas = dense[:, 0].reshape(r, m)
            rgbs = dense[:, 1:4].reshape(r, m, 3)
            mask = kept
            if cfg.alpha_thre > 0:
                alpha_raw = 1.0 - torch.exp(-sigmas * p_dts)
                mask = mask & (alpha_raw > cfg.alpha_thre)
            weights, _, _ = render_weights_from_density(
                p_t0, p_t1, sigmas, mask, prefix_trans=trans)
            rgb_acc = rgb_acc + torch.sum(weights[..., None] * rgbs, dim=-2)
            opac_acc = opac_acc + torch.sum(weights, dim=-1)
            depth_acc = depth_acc + torch.sum(weights * t_mid, dim=-1)
            sdelta = sigmas * p_dts * mask
            trans = trans * torch.exp(-torch.sum(sdelta, dim=-1))
            remaining = (remaining & torch.logical_not(kept)
                         & (trans > self.early_stop_eps)[:, None])
            n_pass += 1
        self.pass_log.append([n_pass])
        opacity = opac_acc[:, None]
        depth = depth_acc[:, None] / torch.clamp(opacity, min=1.1920929e-07)
        rgb = rgb_acc + bkgd * (1.0 - opacity)
        return rgb, opacity, depth


def eval_chunk_for(cfg: SceneConfig) -> int:
    """Rays per eval chunk matching make_eval_render_fn's impl="auto" pick."""
    return cfg.eval_chunk_seg if cfg.cone_angle == 0.0 else cfg.eval_chunk


def make_eval_render_fn(field, cfg: SceneConfig, s_max: Optional[int] = None,
                        budgeted: bool = True, budget_per_ray: int = 64,
                        early_stop_eps: float = 1e-4, impl: str = "auto"):
    """Chunk renderer for full-image evaluation: fn(occ_state, origins [C,3],
    viewdirs [C,3], timestamp, render_bkgd [3]) -> (rgb, opacity, depth).

    impl "auto" picks the segment path (SegEvalRenderer) for budgeted
    uniform-step configs (cone_angle == 0) and the lattice marcher
    (LatticeEvalRenderer) otherwise, as in the JAX package; "seg" forces
    the segment path (budgeted only), any other value the lattice."""
    s_max = s_max or cfg.eval_s_max
    if impl == "auto":
        impl = "seg" if (budgeted and cfg.cone_angle == 0.0) else "lattice"
    if impl == "seg":
        if not budgeted:
            raise ValueError(
                "impl='seg' requires budgeted=True (the segment marcher is "
                "a multi-pass budgeted loop); use impl='lattice' for the "
                "single-pass dense reference path")
        return make_eval_render_fn_seg(field, cfg, s_max=s_max,
                                       budget_per_ray=budget_per_ray,
                                       early_stop_eps=early_stop_eps)
    return LatticeEvalRenderer(field, cfg, s_max=s_max, budgeted=budgeted,
                               budget_per_ray=budget_per_ray,
                               early_stop_eps=early_stop_eps)


def render_image(field, occ_state, render_chunk_fn, origins, viewdirs,
                 timestamp, render_bkgd, chunk: int = 4096):
    """Host loop: render a full [H, W] image chunk by chunk.

    origins/viewdirs: numpy or tensors [..., 3]. The last chunk is padded
    (origins with 0, viewdirs with 1.0) to the chunk size, and a small frame
    is never padded past its own 8-aligned ray count. Returns numpy
    (rgb [..., 3], opacity [..., 1], depth [..., 1])."""
    dev = next(field.parameters()).device
    shape = tuple(origins.shape[:-1])
    o = torch.as_tensor(np.asarray(origins, np.float32).reshape(-1, 3))
    d = torch.as_tensor(np.asarray(viewdirs, np.float32).reshape(-1, 3))
    n = o.shape[0]
    chunk = min(chunk, -(-n // 8) * 8)
    rgbs, opacs, depths = [], [], []
    for i in range(0, n, chunk):
        co, cd = o[i:i + chunk], d[i:i + chunk]
        pad = chunk - co.shape[0]
        if pad:
            co = torch.cat([co, torch.zeros(pad, 3)])
            cd = torch.cat([cd, torch.ones(pad, 3)])
        rgb, opac, depth = render_chunk_fn(occ_state, co.to(dev), cd.to(dev),
                                           timestamp, render_bkgd)
        keep = chunk - pad
        rgbs.append(rgb[:keep])
        opacs.append(opac[:keep])
        depths.append(depth[:keep])
    rgb = torch.cat(rgbs).cpu().numpy().reshape(*shape, 3)
    opac = torch.cat(opacs).cpu().numpy().reshape(*shape, 1)
    depth = torch.cat(depths).cpu().numpy().reshape(*shape, 1)
    return rgb, opac, depth
