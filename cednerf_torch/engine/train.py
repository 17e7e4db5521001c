"""Training engine — port of cednerf_tpu/engine/train.py: the LR schedule
and Adam, the train state, occupancy updates, the packed budgeted train step
with its steady-state branches, the K-step train loop and the Trainer with
its scanned path (`run_chunk`), lattice adaptation and checkpoints.

Parity targets in the reference (as in the JAX package): Adam(lr=1e-2,
eps=1e-15); LinearLR warmup (factor 0.01 -> 1 over 100 steps) times
0.33 per milestone passed; MSE plus the opt-in regularizers; occupancy
updates every 16 steps on random scene times (all cells during warmup, a
sampled quarter after); a fixed sample budget per step with a ladder of ray
buckets that track the valid-sample demand.

The step is eager PyTorch: march the [R, M] candidate lattice (after the
occupancy warmup: from each ray's first occupied segment, advance_t_min, or
through the two-stage segment compaction, march_segments), compact it to
the budget (K4; twice with segments), run the field (K5 forward), composite
on the packed buffer, backward (K6 for the encoder), Adam. `run_step` reads
its metrics back once a step (the JAX Trainer's `int(metrics["n_valid"])`);
`run_chunk` runs K steps with device sampling and occupancy updates inside
and reads the chunk's stacked metrics back once.

With cfg.packed_render=False the step composites on the dense [R, M]
lattice instead (render_rays_budget, the unpacked losses).

With a mesh (parallel/mesh.py) each rank runs block `rank` of the
one-process program with cfg.compact_blocks = mesh.size: it draws the
global batch and jitter, keeps its rows, compacts them to budget / size,
divides its losses by the global counts, and sums the gradients over the
ranks before Adam; the metrics and so the host's decisions are global.
"""

import dataclasses
import math
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..ops import losses as L
from ..parallel import mesh as pm
from ..ops.occupancy import (SKIP_DILATE, SKIP_POOL_DEFAULT, SKIP_SEG_DEFAULT,
                             OccGridState, create_occ_grid, march_candidates,
                             update_occ_grid)
from ..utils.device import resolve_device
from .checkpoint import load_checkpoint_full, save_checkpoint
from .config import ModelFlags, SceneConfig
from .renderer import (march_segments, pack_candidates, render_packed,
                       render_rays_budget, render_rays_budget_packed,
                       seg_slot_budget)
from .sampling import make_stacked_sampler, upload_stacked

# the step's metrics, in the column order of make_train_loop's [K, M] stack
METRICS = ("loss", "mse", "n_samples", "n_valid", "max_depth",
           "complete_frac", "span_slots", "psnr")


@dataclasses.dataclass
class TrainState:
    """The field (its parameters are the trained state), Adam and its LR
    schedule, and the occupancy grid."""

    field: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    occ: OccGridState


def make_lr_schedule(cfg: SceneConfig):
    """lr(step) = base * linear_warmup(step) * 0.33^(milestones passed)."""
    milestones = tuple(cfg.milestones)

    def schedule(count) -> float:
        count = float(count)
        warm = min(max(0.01 + (1.0 - 0.01) * count / 100.0, 0.01), 1.0)
        decay = 0.33 ** sum(count >= m for m in milestones)
        return cfg.lr * warm * decay

    return schedule


def make_optimizer(params, cfg: SceneConfig):
    """torch Adam(eps=1e-15) + LambdaLR on make_lr_schedule: the first update
    uses schedule(0), as optax's adam(learning_rate=schedule) does."""
    schedule = make_lr_schedule(cfg)
    opt = torch.optim.Adam(params, lr=cfg.lr, eps=1e-15)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: schedule(count) / cfg.lr)
    return opt, sched


def create_train_state(field, cfg: SceneConfig, device="cuda") -> TrainState:
    """Move `field` (already initialised, as build_field does) to `device`
    (CUDA unless device="cpu") and build Adam and an empty occupancy grid
    beside it."""
    dev = resolve_device(device)
    field.to(dev)
    opt, sched = make_optimizer(field.parameters(), cfg)
    occ = create_occ_grid(cfg.aabb, cfg.grid_resolution, cfg.grid_nlvl,
                          device=dev)
    return TrainState(field=field, optimizer=opt, scheduler=sched, occ=occ)


def make_occ_update_fn(field, cfg: SceneConfig, all_cells: bool):
    """Occupancy EMA update: fn(occ, timestamps_pool [P, 1], generator) ->
    occ. Each probed position gets a random time from the pool (the
    occ_eval_fn contract, train_real.py:324-328); every draw comes from
    `generator`, on the grid's device. Runs under torch.no_grad()."""

    @torch.no_grad()
    def occ_update(occ: OccGridState, timestamps_pool: torch.Tensor,
                   generator: torch.Generator) -> OccGridState:
        def density_fn(x):
            ti = torch.randint(0, timestamps_pool.shape[0], (x.shape[0],),
                               device=x.device, generator=generator)
            t = timestamps_pool[ti].reshape(-1, 1)
            return field.query_density(x, t)["density"] \
                * cfg.render_step_size

        return update_occ_grid(occ, density_fn, generator=generator,
                               occ_thre=cfg.occ_thre,
                               ema_decay=cfg.occ_ema_decay,
                               all_cells=all_cells)

    return occ_update


def occ_mean_value(occ: OccGridState) -> torch.Tensor:
    visible = occ.occs >= 0.0
    return torch.where(visible, occ.occs, 0.0).sum() / torch.clamp(
        visible.sum(), min=1)


def _span_slots(valid: torch.Tensor) -> torch.Tensor:
    """Occupied-span telemetry of the shrink-from-full adaptation: the most
    lattice slots any ray needs, from its first occupied SKIP_SEG_DEFAULT-
    slot segment (advance_t_min skips whole segments) to its last valid
    slot."""
    v = valid.to(torch.uint8)
    m = v.shape[1]
    any_v = valid.any(dim=-1)
    last_v = (m - 1) - torch.argmax(v.flip(-1), dim=-1)
    first_v = torch.argmax(v, dim=-1)
    seg = SKIP_SEG_DEFAULT
    span = torch.where(any_v, last_v + 1 - (first_v // seg) * seg,
                       torch.zeros_like(first_v))
    return span.max().float()


def _packed_regularizers(loss, extras: dict, batch: dict, flags: ModelFlags,
                         budget: int, complete, n_blocks: int, denom=None):
    """`loss` plus the opt-in ray regularizers on the packed buffer
    (render_rays_budget_packed / render_packed extras), complete-masked;
    denom: a mesh's global count of complete rays."""
    starts, counts = extras["starts"], extras["counts"]
    if flags.distortion_loss:
        loss = loss + L.packed_distortion_loss(
            extras["weights_p"], extras["t_starts_p"], extras["dts_p"],
            starts, counts, budget, complete, n_blocks=n_blocks,
            denom=denom) * 1e-3
    if flags.weight_rgbper:
        loss = loss + L.packed_rgbper_loss(
            extras["rgbs_p"], batch["pixels"], extras["weights_p"].detach(),
            starts, counts, budget, complete, denom) * 1e-3
    if flags.use_feat_predict:
        loss = loss + L.packed_ray_sum_mean(
            extras["latent_p"] * extras["weights_p"].detach(), starts,
            counts, budget, complete, denom)
    if flags.use_weight_predict:
        loss = loss + L.packed_per_ray_mean(
            extras["weight_loss_p"] * extras["weights_p"], extras["valid_p"],
            starts, counts, budget, complete, denom)
    return loss


def _dense_regularizers(loss, extras: dict, batch: dict, flags: ModelFlags,
                        complete, denom=None):
    """`loss` plus the same regularizers on the dense [R, M] lattice
    (render_rays_budget extras), complete-masked."""
    if flags.distortion_loss:
        loss = loss + L.distortion_loss(
            extras["weights"], extras["t_starts"], extras["t_ends"],
            extras["mask"], ray_weights=complete, denom=denom) * 1e-3
    if flags.weight_rgbper:
        loss = loss + L.rgbper_loss(
            extras["rgbs"], batch["pixels"], extras["weights"].detach(),
            extras["mask"], ray_weights=complete, denom=denom) * 1e-3
    if flags.use_feat_predict:
        loss = loss + L.ray_mean(extras["latent_losses"].reshape(-1),
                                 complete, denom)
    if flags.use_weight_predict:
        loss = loss + L.ray_mean(extras["weight_losses"].reshape(-1),
                                 complete, denom)
    return loss


def _rank_blocks(cfg: SceneConfig, budget: int, mesh):
    """(this rank's budget, its compaction blocks): the whole budget and
    cfg.compact_blocks without a mesh; with one, the rank's share of both
    (block `rank` of the one-process program)."""
    if mesh is None:
        return budget, cfg.compact_blocks
    if cfg.compact_blocks % mesh.size:
        raise ValueError(
            f"a mesh of {mesh.size} ranks needs cfg.compact_blocks to be a "
            f"multiple of it (got {cfg.compact_blocks}): each rank compacts "
            "its own rays, as JAX's blocks aligned to the mesh")
    return budget // mesh.size, cfg.compact_blocks // mesh.size


def _make_loss_fn(cfg: SceneConfig, flags: ModelFlags, budget: int,
                  s_cap: int = 0, use_seg: bool = False,
                  steady_march: bool = False, mesh=None):
    """loss_and_grads(state, batch, jitter=None, generator=None) ->
    (loss, aux): march, budgeted render (packed; on the dense lattice with
    cfg.packed_render=False), losses, and backward into
    the field's .grad (zeroed first). Gradients land in every parameter
    (zeros where none flows), as optax's update sees them. The march
    jitter is `jitter` [R] in [0, 1) if given, else drawn from `generator`.

    The steady-state branches of the JAX step (after the occupancy warmup;
    a dense warmup grid would truncate every ray):
      * s_cap < max_march_steps packs each ray's valid candidates into
        s_cap slots (pack_candidates); rays with more are incomplete;
      * use_seg (cfg.march_seg, one grid level, uniform steps) marches by
        segments (march_segments, K4 twice);
      * steady_march with 0 < cfg.steady_march_steps < max_march_steps
        (uniform steps, not use_seg) skips leading empty space and marches
        a steady_march_steps lattice from each ray's first occupied
        segment, probing max_march_steps slots; rays whose span outruns it
        are incomplete.
    aux["span_slots"] is the occupied-span telemetry (0 under use_seg).

    mesh: the batch and jitter are the global ones; the rank keeps its rows
    (the jitter, when not given, drawn for every ray from `generator`, as
    the one-process step draws it), compacts them as its share of the
    budget, divides its losses by the global count of complete rays and
    sums the gradients over the ranks. aux["n_valid"] is then global, the
    other aux values the rank's own."""
    use_seg = bool(use_seg and cfg.march_seg and cfg.packed_render
                   and cfg.grid_nlvl == 1 and cfg.cone_angle == 0.0)
    skip_empty = bool(steady_march and cfg.steady_march_steps
                      and cfg.steady_march_steps < cfg.max_march_steps
                      and cfg.cone_angle == 0.0 and not use_seg)
    march_steps = (cfg.steady_march_steps if skip_empty
                   else cfg.max_march_steps)
    capped = bool(s_cap and s_cap < cfg.max_march_steps)
    budget_r, n_blocks = _rank_blocks(cfg, budget, mesh)
    reduce = None
    seg_budget = None
    if mesh is not None:
        def reduce(t):
            return pm.global_sum(t, mesh)
    if mesh is not None and use_seg:
        seg_budget = seg_slot_budget(budget, cfg.seg_overcommit,
                                     cfg.march_seg, cfg.compact_blocks
                                     ) // mesh.size

    def loss_and_grads(state: TrainState, batch: dict, jitter=None,
                       generator: Optional[torch.Generator] = None):
        field = state.field
        occ_mean = occ_mean_value(state.occ)
        if mesh is not None:
            n = batch["origins"].shape[0]
            if jitter is None and generator is not None:
                jitter = torch.rand(n, device=batch["origins"].device,
                                    generator=generator)
            batch = pm.shard_batch(batch, mesh, n_rows=n)
            if jitter is not None:
                jitter = jitter[mesh.rows(n)]
        with torch.no_grad():
            if use_seg:
                ps = march_segments(
                    state.occ, batch["origins"], batch["viewdirs"],
                    batch["timestamps"], budget=budget_r,
                    near_plane=cfg.near_plane, far_plane=cfg.far_plane,
                    render_step_size=cfg.render_step_size,
                    cone_angle=cfg.cone_angle,
                    max_march_steps=cfg.max_march_steps, seg=cfg.march_seg,
                    overcommit=cfg.seg_overcommit, pool=cfg.seg_pool,
                    n_blocks=n_blocks, jitter=jitter,
                    generator=generator, compact_impl=cfg.compact_impl,
                    seg_budget=seg_budget, reduce=reduce)
                n_valid_full = ps.n_valid
                span_slots = torch.zeros((), device=occ_mean.device)
            else:
                cand = march_candidates(
                    state.occ, batch["origins"], batch["viewdirs"],
                    near_plane=cfg.near_plane, far_plane=cfg.far_plane,
                    render_step_size=cfg.render_step_size,
                    cone_angle=cfg.cone_angle, max_march_steps=march_steps,
                    jitter=jitter, generator=generator,
                    probe_steps=cfg.max_march_steps if skip_empty else 0)
                n_valid_full = cand.valid.sum()
                span_slots = _span_slots(cand.valid)
                fits = None
                if capped:
                    cand, fits = pack_candidates(cand, s_cap)

        field.zero_grad(set_to_none=False)
        if use_seg:
            out = render_packed(
                field, ps, batch["color_bkgd"], occ_mean, budget=budget_r,
                alpha_thre=cfg.alpha_thre, train=True,
                n_blocks=n_blocks, assembly_impl=cfg.assembly_impl)
        elif cfg.packed_render:
            # uniform steps on the unpacked lattice: a slot's t is its
            # ray's t_min plus its column times dt (packing reorders the
            # columns, so s_cap turns this off)
            out = render_rays_budget_packed(
                field, batch["origins"], batch["viewdirs"], cand,
                batch["timestamps"], batch["color_bkgd"], occ_mean,
                budget=budget_r, alpha_thre=cfg.alpha_thre, train=True,
                n_blocks=n_blocks, ray_complete=fits,
                compact_impl=cfg.compact_impl,
                assembly_impl=cfg.assembly_impl,
                uniform_dt=(cfg.render_step_size
                            if cfg.cone_angle == 0.0 and not capped
                            else None))
        else:
            out = render_rays_budget(
                field, batch["origins"], batch["viewdirs"], cand,
                batch["timestamps"], batch["color_bkgd"], occ_mean,
                budget=budget_r, alpha_thre=cfg.alpha_thre, train=True,
                n_blocks=n_blocks, ray_complete=fits,
                compact_impl=cfg.compact_impl)
        extras = out.extras
        complete = extras["complete"]
        n_complete = complete.sum()
        if mesh is not None:
            # the global counts: the loss denominators and the demand
            if use_seg:         # march_segments reduced n_valid already
                n_complete = reduce(n_complete)
            else:
                n_complete, n_valid_full = reduce(
                    torch.stack([n_complete, n_valid_full])).unbind()
        denom = torch.clamp(n_complete, min=1.0)
        rd = None if mesh is None else denom
        sq = ((out.rgb - batch["pixels"]) ** 2).sum(-1)
        mse = (complete * sq).sum() / (3.0 * denom)
        loss = mse
        if flags.use_opacity_loss:
            loss = loss + L.opacity_loss(out.opacity, ray_weights=complete,
                                         denom=rd) * 1e-3
        if flags.acc_entropy_loss:
            loss = loss + L.acc_entropy_loss(
                out.opacity, ray_weights=complete, denom=rd) * 1e-3
        if extras.get("packed"):
            loss = _packed_regularizers(loss, extras, batch, flags, budget_r,
                                        complete, n_blocks, rd)
        else:
            loss = _dense_regularizers(loss, extras, batch, flags, complete,
                                       rd)
        loss.backward()
        for p in field.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if mesh is not None:
            pm.all_reduce_grads(field.parameters(), mesh)
        aux = {"mse": mse.detach(), "n_samples": out.n_samples,
               "n_valid": n_valid_full, "max_depth": out.depth.max().detach(),
               "complete_frac": complete.mean(), "span_slots": span_slots}
        return loss.detach(), aux

    return loss_and_grads


def _global_metrics(metrics: dict, mesh) -> dict:
    """A mesh step's metrics over every ray: the partial losses and the
    sample counts summed, the maxima taken, complete_frac averaged over the
    (equal) shards, n_valid global already; one all-gather, reduced alike
    on every rank."""
    keys = ("loss", "mse", "n_samples", "max_depth", "complete_frac",
            "span_slots")
    rows = pm.all_gather_rows(
        torch.stack([metrics[k].float() for k in keys])[None], mesh)
    tot, top = rows.sum(0), rows.max(0).values
    return dict(metrics, loss=tot[0], mse=tot[1], n_samples=tot[2],
                max_depth=top[3], complete_frac=tot[4] / mesh.size,
                span_slots=top[5])


def _make_one_step(field, cfg: SceneConfig, flags: ModelFlags, budget: int,
                   s_cap: int = 0, use_seg: bool = False,
                   steady_march: bool = False, mesh=None):
    """The train step: loss and gradients (with the steady-state branches
    of _make_loss_fn), then one Adam update and one LR schedule step.
    one_step(state, batch, jitter=None, generator=None) -> (state, metrics
    of 0-d tensors on the device; over every rank's rays with a mesh)."""
    loss_and_grads = _make_loss_fn(cfg, flags, budget, s_cap=s_cap,
                                   use_seg=use_seg, steady_march=steady_march,
                                   mesh=mesh)

    def one_step(state: TrainState, batch: dict, jitter=None,
                 generator: Optional[torch.Generator] = None):
        loss, aux = loss_and_grads(state, batch, jitter, generator)
        state.optimizer.step()
        state.scheduler.step()
        metrics = {"loss": loss, "mse": aux["mse"],
                   "n_samples": aux["n_samples"].float(),
                   "n_valid": aux["n_valid"].float(),
                   "max_depth": aux["max_depth"],
                   "complete_frac": aux["complete_frac"],
                   "span_slots": aux["span_slots"]}
        if mesh is not None:
            metrics = _global_metrics(metrics, mesh)
        metrics["psnr"] = -10.0 * torch.log(metrics["mse"]) / math.log(10.0)
        return state, metrics

    return one_step


def make_train_step(field, cfg: SceneConfig, flags: ModelFlags,
                    budget: Optional[int] = None, s_cap: int = 0,
                    use_seg: bool = False, mesh=None):
    """train_step(state, batch, jitter=None, generator=None) -> (state,
    metrics): one step of the packed budgeted path, uncapped and without
    segment marching by default (the JAX package's step "safe in any
    phase"). batch: origins/viewdirs/pixels [R, 3], timestamps [R, 1],
    color_bkgd [3] tensors on the field's device (with a mesh the global
    batch: each rank keeps its rows). metrics are 0-d tensors on the
    device, psnr included."""
    return _make_one_step(field, cfg, flags, budget or cfg.sample_budget,
                          s_cap=s_cap, use_seg=use_seg, mesh=mesh)


def make_train_loop(field, cfg: SceneConfig, flags: ModelFlags, n_rays: int,
                    sample_fn, k_steps: int, warmup_phase: bool = False,
                    budget: Optional[int] = None, mesh=None):
    """K train steps per call: the JAX package's lax.scan as a Python loop.

    Returns fn(state, data, timestamps_pool, generator, step0) -> (state,
    metrics [K, len(METRICS)] on the device). Step i (global step step0 +
    i) draws from `generator` in a fixed order: the occupancy update's
    cells, jitter and probe times when step % occ_update_interval == 0
    (all cells while warmup_phase and step < occ_warmup_steps, a sampled
    quarter otherwise; the host knows the step, so no cond is needed), then
    the batch (sample_fn(data, generator, n_rays, i)), then the march
    jitter. A warmup-phase loop keeps s_cap 0, no segment marching and no
    empty-space skipping for all its K steps, as in JAX; otherwise it runs
    cfg.steady_s_cap, use_seg and steady_march. Nothing is read back to the
    host inside the loop, and every step has the shapes of its key (n_rays,
    the budget, the lattice), so the loop can be captured as it is.

    JAX donates the state and returns a new one; here the field's
    parameters and Adam's moments are updated in place, the occupancy grid
    is replaced, and the same TrainState comes back.

    mesh: every rank runs the same loop on the same draws (the occupancy
    updates replicated, the sampled batch global); each step keeps the
    rank's rows, sums the gradients over the ranks and returns global
    metrics (collectives only, no host read)."""
    one_step = _make_one_step(
        field, cfg, flags, budget or cfg.sample_budget,
        s_cap=0 if warmup_phase else cfg.steady_s_cap,
        use_seg=not warmup_phase, steady_march=not warmup_phase, mesh=mesh)
    occ_warm = make_occ_update_fn(field, cfg, all_cells=True)
    occ_sampled = make_occ_update_fn(field, cfg, all_cells=False)

    def train_loop(state: TrainState, data, timestamps_pool: torch.Tensor,
                   generator: torch.Generator, step0: int):
        rows = []
        for i in range(k_steps):
            step = step0 + i
            if step % cfg.occ_update_interval == 0:
                warm = warmup_phase and step < cfg.occ_warmup_steps
                state.occ = (occ_warm if warm else occ_sampled)(
                    state.occ, timestamps_pool, generator)
            batch = sample_fn(data, generator, n_rays, i)
            state, metrics = one_step(state, batch, generator=generator)
            rows.append(torch.stack([metrics[k].float() for k in METRICS]))
        return state, torch.stack(rows)

    return train_loop


def _on_device(tensors: dict, device: torch.device) -> bool:
    want = device
    if want.type == "cuda" and want.index is None:
        want = torch.device("cuda", torch.cuda.current_device())
    return all(t.device == want for t in tensors.values()
               if isinstance(t, torch.Tensor))


class Trainer:
    """Host-side training loop: occupancy cadence, bucketed ray counts and,
    on the scanned path, the steady-lattice adaptation and checkpoints.

    The dataset exposes `sample(num_rays) -> dict of numpy arrays` and a
    fixed `timestamps_pool` [N, 1]. Every random draw of the loop (occupancy
    cells, probe jitter and times, device-sampled batches, march jitter)
    comes from one torch.Generator seeded with `seed`, on `device` (CUDA
    unless device="cpu"); host batches come from the dataset's own RNG.

    device_sampler: a (data, sample_fn) pair (engine/sampling.py) whose
    tensors lie on `device` (another device raises); it enables run_chunk,
    `steps_per_call` steps per call. stacked_host=True runs the same path
    on the dataset's host batches: each chunk's K batches are stacked,
    uploaded in one non_blocking copy from pinned memory, and the next
    chunk's are assembled while the card runs the current one; the host RNG
    then lives in the dataset, so `resume` restores the step and bucket but
    not the sample sequence. adapt_bucket=False freezes the ray bucket,
    adapt_steady=False the steady lattice.

    mesh (parallel/mesh.py, axis "data"): ray-sharded data parallelism on
    the mesh's device, with cfg.compact_blocks a multiple of mesh.size
    (train_real --dp sets it to mesh.size). The field and the grid are
    broadcast from rank 0; every rank draws from the same seed (host
    datasets must draw alike on every rank too) and keeps its rows of
    each batch; the gradient is summed over the ranks and the host reads
    global metrics, so every rank takes the same bucket and lattice. Only
    rank 0 writes checkpoints; every rank resumes.

    chunk_log holds one record a run_chunk (the step after it, loss, psnr,
    complete_frac, bucket, steady lattice, the grid's occupied share and
    the steps whose loss was not finite), read in the chunk's one host
    read."""

    def __init__(self, field, cfg: SceneConfig, flags: ModelFlags, dataset,
                 seed: int = 42, device="cuda", device_sampler=None,
                 steps_per_call: int = 16, adapt_bucket: bool = True,
                 stacked_host: bool = False, mesh=None,
                 adapt_steady: bool = True):
        self.field = field
        self.cfg = cfg
        self.flags = flags
        self.dataset = dataset
        self.mesh = mesh
        if mesh is not None:
            _rank_blocks(cfg, cfg.sample_budget, mesh)     # checks the blocks
            device = mesh.device
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state = create_train_state(field, cfg, device=self.device)
        if mesh is not None:
            pm.replicate([field, self.state.occ], mesh)
        self.step = 0
        # the smallest bucket first: the warmup grid is dense, so demand
        # per ray ~ max_march_steps and the budget fits few rays
        self.bucket = cfg.ray_buckets()[0]
        self.adapt_bucket = adapt_bucket
        # the empty-space-skip lattice: the configured steady_march_steps
        # (0: the full lattice), doubled when steady chunks stay incomplete
        # and, under cfg.steady_march_auto, shrunk from full to the measured
        # occupied span plus the probe's margin
        self.steady_march = cfg.steady_march_steps
        self.adapt_steady = adapt_steady
        self._incomplete_chunks = 0
        self._complete_chunks = 0
        self._shrink_cooldown = 0
        self._incomplete_warns = 0
        self.chunk_log = []
        self._loop_fns = {}
        self._stacked = bool(stacked_host) and device_sampler is None
        self._prefetched = None
        if self._stacked:
            device_sampler = (None, make_stacked_sampler())
        elif device_sampler is not None and not _on_device(
                device_sampler[0], self.device):
            raise ValueError(
                f"device_sampler data must lie on the Trainer's device "
                f"{self.device}: " + ", ".join(
                    f"{k} on {v.device}" for k, v in device_sampler[0].items()
                    if isinstance(v, torch.Tensor)))
        self.device_sampler = device_sampler
        self.steps_per_call = steps_per_call
        self._occ_warm = make_occ_update_fn(field, cfg, all_cells=True)
        self._occ_sampled = make_occ_update_fn(field, cfg, all_cells=False)
        self._train_step = make_train_step(field, cfg, flags, mesh=mesh)
        self.timestamps_pool = torch.as_tensor(
            np.asarray(dataset.timestamps_pool, np.float32).reshape(-1, 1),
            device=self.device)

    def _warmup_now(self) -> bool:
        return self.step < self.cfg.occ_warmup_steps

    def _steady_margin(self) -> int:
        """Lattice slots by which advance_t_min's coarse probe can fire
        early: its probe is occupied within (dilate + 1) * pool fine cells
        (diagonal) of real occupancy, plus one skip-segment quantum."""
        cfg = self.cfg
        a = cfg.aabb
        cells = [(a[3] - a[0]) / cfg.grid_resolution,
                 (a[4] - a[1]) / cfg.grid_resolution,
                 (a[5] - a[2]) / cfg.grid_resolution]
        diag = float(np.sqrt(sum(c * c for c in cells)))
        reach = (SKIP_DILATE + 1) * SKIP_POOL_DEFAULT * diag
        return int(np.ceil(reach / cfg.render_step_size)) + SKIP_SEG_DEFAULT

    def run_step(self) -> dict:
        """One occupancy update when the cadence says so, one batch of the
        current bucket, one train step; then the ray-count feedback from
        the step's valid-sample demand. Returns the metrics as floats."""
        cfg = self.cfg
        if self.step % cfg.occ_update_interval == 0:
            occ_fn = self._occ_warm if self._warmup_now() \
                else self._occ_sampled
            self.state.occ = occ_fn(self.state.occ, self.timestamps_pool,
                                    self.generator)
        n_rays = self.bucket
        batch = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                 for k, v in self.dataset.sample(n_rays).items()}
        self.state, metrics = self._train_step(self.state, batch,
                                               generator=self.generator)
        # the step's one device->host read
        vals = torch.stack([metrics[k].float() for k in METRICS]).tolist()
        out = dict(zip(METRICS, vals))
        n_valid = int(out["n_valid"])
        if n_valid > 0 and self.adapt_bucket and not self._warmup_now():
            self.bucket = cfg.pick_ray_bucket(n_valid / n_rays)
        self.step += 1
        return out | {"num_rays": n_rays}

    # ---------------- the scanned multi-step path ---------------- #

    def _assemble_stacked(self, n_rays: int) -> dict:
        """K host batches of the dataset, stacked and uploaded."""
        batches = [self.dataset.sample(n_rays)
                   for _ in range(self.steps_per_call)]
        return upload_stacked({k: np.stack([np.asarray(b[k]) for b in batches])
                               for k in batches[0]}, self.device)

    def _loop_fn(self, n_rays: int):
        warmup = self._warmup_now()
        keyed = (n_rays, warmup, self.steady_march)
        if keyed not in self._loop_fns:
            cfg = self.cfg
            if self.steady_march != cfg.steady_march_steps:
                cfg = dataclasses.replace(
                    cfg, steady_march_steps=self.steady_march)
            self._loop_fns[keyed] = make_train_loop(
                self.field, cfg, self.flags, n_rays, self.device_sampler[1],
                self.steps_per_call, warmup_phase=warmup, mesh=self.mesh)
        return self._loop_fns[keyed]

    def dispatch_chunk(self) -> torch.Tensor:
        """Enqueue the chunk's steps_per_call steps at the current bucket
        and advance self.step; returns their metrics [K, len(METRICS)] on
        the device, with no host read. On the stacked path the next chunk's
        batches are assembled and uploaded after the dispatch, while the
        card runs this one (dropped if the bucket then changes)."""
        if self.device_sampler is None:
            raise RuntimeError("run_chunk needs a device_sampler or "
                               "stacked_host=True")
        n_rays = self.bucket
        if self._stacked:
            if self._prefetched is not None and self._prefetched[0] == n_rays:
                data = self._prefetched[1]
            else:
                data = self._assemble_stacked(n_rays)
            self._prefetched = None
        else:
            data = self.device_sampler[0]
        self.state, metrics = self._loop_fn(n_rays)(
            self.state, data, self.timestamps_pool, self.generator, self.step)
        if self._stacked:
            self._prefetched = (n_rays, self._assemble_stacked(n_rays))
        self.step += self.steps_per_call
        return metrics

    def run_chunk(self) -> dict:
        """steps_per_call steps in one dispatch, then the chunk's one
        device->host read and the host's adaptation: the ray bucket from
        the chunk's mean demand, the steady lattice (doubled after 3
        incomplete chunks; under steady_march_auto shrunk from full after 3
        complete ones to the occupied span plus margin, rounded up to 64
        slots, at least 128, then a 64-chunk cooldown), and a warning when
        most rays were masked out of the loss."""
        n_rays, steady = self.bucket, self.steady_march
        metrics = self.dispatch_chunk()
        occ_share = self.state.occ.binaries.float().mean()
        vals = torch.cat([metrics.reshape(-1), occ_share.reshape(1)]
                         ).tolist()            # the chunk's one host read
        rows = np.asarray(vals[:-1]).reshape(metrics.shape)
        m = {k: tuple(rows[:, i]) for i, k in enumerate(METRICS)}
        out = self._adapt(m, n_rays)
        self.chunk_log.append({
            "step": self.step, "loss": out["loss"], "psnr": out["psnr"],
            "complete_frac": out["complete_frac"], "bucket": n_rays,
            "steady_march": steady, "occ_share": vals[-1],
            "nonfinite_steps": int((~np.isfinite(rows[:, 0])).sum())})
        return out

    def _adapt(self, m: dict, n_rays: int) -> dict:
        cfg = self.cfg
        mean = {k: float(np.mean(v)) for k, v in m.items()}
        mean_valid = mean["n_valid"]
        warm = self._warmup_now()
        if mean_valid > 0 and not warm and self.adapt_bucket:
            self.bucket = cfg.pick_ray_bucket(mean_valid / n_rays)
        cf = mean["complete_frac"]
        # span-truncation repair: rays whose occupied span outruns the
        # steady lattice are masked out of the loss for good, so a lattice
        # that stays incomplete for 3 chunks doubles (toward
        # max_march_steps, where the skip turns off)
        if cf < 0.99 and not warm:
            self._incomplete_chunks += 1
        else:
            self._incomplete_chunks = 0
        if (self._incomplete_chunks >= 3 and self.adapt_steady
                and 0 < self.steady_march < cfg.max_march_steps):
            self.steady_march = min(2 * self.steady_march,
                                    cfg.max_march_steps)
            self._incomplete_chunks = 0
        # shrink-from-full: start at the full lattice and, once
        # complete_frac holds for 3 chunks, shrink to the measured span
        # plus the probe's margin; the repair above recovers if occupancy
        # grows later
        if (self.adapt_steady and cfg.steady_march_auto
                and cfg.steady_march_steps == 0 and cfg.cone_angle == 0.0
                and cfg.max_march_steps >= 256 and not warm):
            self._shrink_cooldown -= 1
            if cf >= 0.995:
                self._complete_chunks += 1
            else:
                self._complete_chunks = 0
            span = max(m["span_slots"])
            cur = self.steady_march or cfg.max_march_steps
            if (self._complete_chunks >= 3 and self._shrink_cooldown <= 0
                    and span > 0):
                target = int(-(-(span + self._steady_margin()) // 64) * 64)
                target = max(target, 128)
                if target < cur * 0.75 and target < cfg.max_march_steps:
                    self.steady_march = target
                    self._complete_chunks = 0
                    self._shrink_cooldown = 64
        if cf < 0.5 and not warm:
            self._incomplete_warns += 1
            if self._incomplete_warns <= 3:
                warnings.warn(
                    f"complete_frac={cf:.2f} at step {self.step}: most rays "
                    "were truncated and masked out of the loss. Likely "
                    "causes: steady_march_steps smaller than the occupied "
                    "span, or sample budget far below demand "
                    f"(n_valid={mean_valid:.0f}).")
        with np.errstate(divide="ignore"):     # mse 0: psnr inf, as in JAX
            psnr = float(-10.0 * np.log10(mean["mse"]))
        return {"loss": mean["loss"], "mse": mean["mse"], "psnr": psnr,
                "n_samples": mean["n_samples"], "n_valid": mean_valid,
                "num_rays": n_rays, "steps": self.steps_per_call,
                "complete_frac": cf}

    def save(self, path: str):
        """A resumable checkpoint of the state, step, generator, bucket and
        steady lattice (engine/checkpoint.py); with a mesh rank 0 writes it
        and every rank waits for it."""
        if self.mesh is None or self.mesh.rank == 0:
            save_checkpoint(path, self.state, self.step,
                            self.generator.get_state(), self.bucket,
                            self.steady_march)
        if self.mesh is not None:
            pm.barrier(self.mesh)

    def resume(self, path: str) -> int:
        """Restore a checkpoint written at a step-loop boundary: the state,
        step, generator state, bucket and steady lattice, so that the run
        repeats the uninterrupted run's steps. Returns the step."""
        self.state, self.step, rng, bucket, steady = load_checkpoint_full(
            path, self.state)
        if rng is not None:
            self.generator.set_state(rng)
        if bucket:
            self.bucket = bucket
        if steady:
            self.steady_march = steady
            self._incomplete_chunks = 0
        self._prefetched = None
        return self.step

    def run(self, total_steps: int, log_every: int = 10000, log_fn=print,
            hooks=(), checkpoint_dir=None, checkpoint_every: int = 0):
        """Train while step <= total_steps: run_chunk when a sampler is set
        (device or stacked), else run_step. hooks: (step, fn) pairs, each
        fn() run once when training first reaches that step (at once if
        already past it). checkpoint_dir / checkpoint_every: a rolling
        resumable checkpoint every N steps; the final save stays the
        caller's."""
        chunked = self.device_sampler is not None
        pending = sorted(hooks, key=lambda h: h[0])
        last_ckpt = self.step
        tic = time.time()
        while self.step <= total_steps:
            while pending and self.step >= pending[0][0]:
                pending.pop(0)[1]()
            m = self.run_chunk() if chunked else self.run_step()
            if (checkpoint_every and checkpoint_dir
                    and self.step - last_ckpt >= checkpoint_every):
                self.save(checkpoint_dir)
                last_ckpt = self.step
            if log_every and (self.step % log_every
                              < (self.steps_per_call if chunked else 1)):
                log_fn(f"elapsed_time={time.time() - tic:.2f}s | "
                       f"step={self.step} | loss={m['loss']:.5f} | "
                       f"psnr={m['psnr']:.2f} | "
                       f"n_rendering_samples={int(m['n_samples'])} | "
                       f"num_rays={int(m['num_rays'])} |")
        return self.state
