"""Evaluation rendering — port of the serving half of
cednerf_tpu/engine/renderer.py: the segment-compacted eval renderer
(`make_eval_render_fn_seg`), the `make_eval_render_fn` dispatch and the
`render_image` host loop.

The JAX renderer is one jitted program whose pass loop is a
`lax.while_loop`. Here the loop is a Python loop on the host: each pass is a
run of eager PyTorch ops (and one field forward through the brick-encoder
kernel), and each loop test reads its condition back with `.item()`, one
device->host sync per pass. The renderer counts its passes (`pass_log`) so
that the cost is visible; removing the syncs is later work.

Index semantics: every `jnp.take` of the JAX loop reads in-range indices
(checked against the index arithmetic), so plain indexing reproduces it; the
one out-of-range update, `.at[starts_c].add(1, mode="drop")`, where
starts_c may equal b_seg_p, is written as an index_add into one spare slot
that is then dropped.
"""

import math
from typing import List, Optional

import numpy as np
import torch

from ..ops.occupancy import (OccGridState, coarse_lookup, occupancy_lookup,
                             pooled_binaries, ray_aabb_intersect)
from .config import SceneConfig


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
                "seg eval path: uniform steps only (cone_angle == 0); the "
                "lattice fallback comes with a later slice of the port")
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
            row_sd_cum = torch.cumsum(row_sd, 0)
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


def eval_chunk_for(cfg: SceneConfig) -> int:
    """Rays per eval chunk matching make_eval_render_fn's impl="auto" pick."""
    return cfg.eval_chunk_seg if cfg.cone_angle == 0.0 else cfg.eval_chunk


def make_eval_render_fn(field, cfg: SceneConfig, s_max: Optional[int] = None,
                        budgeted: bool = True, budget_per_ray: int = 64,
                        early_stop_eps: float = 1e-4, impl: str = "auto"):
    """Chunk renderer for full-image evaluation: fn(occ_state, origins [C,3],
    viewdirs [C,3], timestamp, render_bkgd [3]) -> (rgb, opacity, depth).

    impl "auto" picks the segment path for uniform-step configs
    (cone_angle == 0), as in the JAX package; "seg" forces it. The lattice
    marcher (cone-angle configs, budgeted=False) comes with a later slice."""
    s_max = s_max or cfg.eval_s_max
    if impl == "auto":
        impl = "seg" if (budgeted and cfg.cone_angle == 0.0) else "lattice"
    if impl != "seg":
        raise NotImplementedError(
            "make_eval_render_fn: the lattice marcher (cone_angle > 0 or "
            "budgeted=False) comes with a later slice of the port")
    if not budgeted:
        raise ValueError("impl='seg' requires budgeted=True")
    return make_eval_render_fn_seg(field, cfg, s_max=s_max,
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
