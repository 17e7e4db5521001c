"""Training engine — port of the host-sampled path of
cednerf_tpu/engine/train.py: the LR schedule and Adam, the train state,
occupancy updates, the packed budgeted train step and the Trainer's
per-step loop.

Parity targets in the reference (as in the JAX package): Adam(lr=1e-2,
eps=1e-15); LinearLR warmup (factor 0.01 -> 1 over 100 steps) times
0.33 per milestone passed; MSE plus the opt-in regularizers; occupancy
updates every 16 steps on random scene times (all cells during warmup, a
sampled quarter after); a fixed sample budget per step with a ladder of ray
buckets that track the valid-sample demand.

The step is eager PyTorch: march the dense [R, M] candidate lattice, compact
it to the budget (K4), run the field (K5 forward), composite on the packed
buffer, backward (K6 for the encoder), Adam. One device->host read per
step brings the metrics back (the JAX Trainer's `int(metrics["n_valid"])`).

Not ported yet, each raising where it is asked for: the scanned multi-step
path (`run_chunk`, `make_train_loop`, device samplers, stacked host
batches), segment marching (`use_seg`), per-ray candidate caps (`s_cap`),
empty-space skipping (steady-state lattices) with its span telemetry,
checkpoints (`resume`), and the device mesh.
"""

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from ..ops import losses as L
from ..ops.occupancy import (OccGridState, create_occ_grid, march_candidates,
                             update_occ_grid)
from ..utils.device import resolve_device
from .config import ModelFlags, SceneConfig
from .renderer import render_rays_budget_packed

METRICS = ("loss", "mse", "n_samples", "n_valid", "max_depth",
           "complete_frac", "psnr")


def _later(what: str, slice_name: str):
    return NotImplementedError(
        f"{what} comes with the {slice_name} slice of the port")


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


def _make_loss_fn(cfg: SceneConfig, flags: ModelFlags, budget: int):
    """loss_and_grads(state, batch, jitter=None, generator=None) ->
    (loss, aux): march, budgeted packed render, losses, and backward into
    the field's .grad (zeroed first). Gradients land in every parameter
    (zeros where none flows), as optax's update sees them."""

    def loss_and_grads(state: TrainState, batch: dict, jitter=None,
                       generator: Optional[torch.Generator] = None):
        field = state.field
        occ_mean = occ_mean_value(state.occ)
        with torch.no_grad():
            cand = march_candidates(
                state.occ, batch["origins"], batch["viewdirs"],
                near_plane=cfg.near_plane, far_plane=cfg.far_plane,
                render_step_size=cfg.render_step_size,
                cone_angle=cfg.cone_angle,
                max_march_steps=cfg.max_march_steps, jitter=jitter,
                generator=generator)
            n_valid_full = cand.valid.sum()

        field.zero_grad(set_to_none=False)
        out = render_rays_budget_packed(
            field, batch["origins"], batch["viewdirs"], cand,
            batch["timestamps"], batch["color_bkgd"], occ_mean,
            budget=budget, alpha_thre=cfg.alpha_thre, train=True,
            n_blocks=cfg.compact_blocks, compact_impl=cfg.compact_impl,
            assembly_impl=cfg.assembly_impl,
            uniform_dt=(cfg.render_step_size if cfg.cone_angle == 0.0
                        else None))
        extras = out.extras
        complete = extras["complete"]
        denom = torch.clamp(complete.sum(), min=1.0)
        sq = ((out.rgb - batch["pixels"]) ** 2).sum(-1)
        mse = (complete * sq).sum() / (3.0 * denom)
        loss = mse
        if flags.use_opacity_loss:
            loss = loss + L.opacity_loss(out.opacity,
                                         ray_weights=complete) * 1e-3
        if flags.acc_entropy_loss:
            loss = loss + L.acc_entropy_loss(out.opacity,
                                             ray_weights=complete) * 1e-3
        starts, counts = extras["starts"], extras["counts"]
        if flags.distortion_loss:
            loss = loss + L.packed_distortion_loss(
                extras["weights_p"], extras["t_starts_p"], extras["dts_p"],
                starts, counts, budget, complete,
                n_blocks=cfg.compact_blocks) * 1e-3
        if flags.weight_rgbper:
            loss = loss + L.packed_rgbper_loss(
                extras["rgbs_p"], batch["pixels"],
                extras["weights_p"].detach(), starts, counts, budget,
                complete) * 1e-3
        if flags.use_feat_predict:
            loss = loss + L.packed_ray_sum_mean(
                extras["latent_p"] * extras["weights_p"].detach(), starts,
                counts, budget, complete)
        if flags.use_weight_predict:
            loss = loss + L.packed_per_ray_mean(
                extras["weight_loss_p"] * extras["weights_p"],
                extras["valid_p"], starts, counts, budget, complete)
        loss.backward()
        for p in field.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        aux = {"mse": mse.detach(), "n_samples": out.n_samples,
               "n_valid": n_valid_full, "max_depth": out.depth.max().detach(),
               "complete_frac": complete.mean()}
        return loss.detach(), aux

    return loss_and_grads


def _make_one_step(field, cfg: SceneConfig, flags: ModelFlags, budget: int,
                   s_cap: int = 0, use_seg: bool = False,
                   steady_march: bool = False):
    """The train step: loss and gradients, then one Adam update and one LR
    schedule step. The packed branch with the dense lattice only; the
    others raise, naming their slice."""
    if bool(use_seg and cfg.march_seg and cfg.packed_render
            and cfg.grid_nlvl == 1 and cfg.cone_angle == 0.0):
        raise _later("segment marching (use_seg)", "scanned train-path")
    if bool(steady_march and cfg.steady_march_steps
            and cfg.steady_march_steps < cfg.max_march_steps
            and cfg.cone_angle == 0.0):
        raise _later("empty-space skipping", "scanned train-path")
    if s_cap and s_cap < cfg.max_march_steps:
        raise _later("per-ray candidate packing (s_cap)", "scanned train-path")
    if not cfg.packed_render:
        raise _later("the dense-lattice renderer (packed_render=False)",
                     "dense-lattice")
    loss_and_grads = _make_loss_fn(cfg, flags, budget)

    def one_step(state: TrainState, batch: dict, jitter=None,
                 generator: Optional[torch.Generator] = None):
        loss, aux = loss_and_grads(state, batch, jitter, generator)
        state.optimizer.step()
        state.scheduler.step()
        metrics = {"loss": loss, "mse": aux["mse"],
                   "n_samples": aux["n_samples"].float(),
                   "n_valid": aux["n_valid"].float(),
                   "max_depth": aux["max_depth"],
                   "complete_frac": aux["complete_frac"]}
        return state, metrics

    return one_step


def make_train_step(field, cfg: SceneConfig, flags: ModelFlags,
                    budget: Optional[int] = None, s_cap: int = 0,
                    use_seg: bool = False):
    """train_step(state, batch, jitter=None, generator=None) -> (state,
    metrics): one step of the packed budgeted path, uncapped and without
    segment marching (the JAX package's step "safe in any phase"). The march
    jitter is `jitter` [R] in [0, 1) if given, else drawn from `generator`.
    batch: origins/viewdirs/pixels [R, 3], timestamps [R, 1], color_bkgd [3]
    tensors on the field's device. metrics are 0-d tensors on the device."""
    one_step = _make_one_step(field, cfg, flags, budget or cfg.sample_budget,
                              s_cap=s_cap, use_seg=use_seg)

    def train_step(state: TrainState, batch: dict, jitter=None,
                   generator: Optional[torch.Generator] = None):
        state, metrics = one_step(state, batch, jitter, generator)
        metrics["psnr"] = -10.0 * torch.log(metrics["mse"]) / math.log(10.0)
        return state, metrics

    return train_step


class Trainer:
    """Host-side training loop: occupancy cadence and bucketed ray counts.

    The dataset exposes `sample(num_rays) -> dict of numpy arrays` and a
    fixed `timestamps_pool` [N, 1]. Every random draw of the loop (occupancy
    cells, probe jitter and times, march jitter) comes from one
    torch.Generator seeded with `seed`, on `device` (CUDA unless
    device="cpu"); ray batches come from the dataset's own numpy RNG."""

    def __init__(self, field, cfg: SceneConfig, flags: ModelFlags, dataset,
                 seed: int = 42, device="cuda", device_sampler=None,
                 adapt_bucket: bool = True, stacked_host: bool = False,
                 mesh=None):
        if device_sampler is not None or stacked_host:
            raise _later("the scanned multi-step path (device_sampler, "
                         "stacked_host)", "scanned train-path")
        if mesh is not None:
            raise _later("the device mesh", "ray-parallel")
        self.field = field
        self.cfg = cfg
        self.flags = flags
        self.dataset = dataset
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state = create_train_state(field, cfg, device=self.device)
        self.step = 0
        # the smallest bucket first: the warmup grid is dense, so demand
        # per ray ~ max_march_steps and the budget fits few rays
        self.bucket = cfg.ray_buckets()[0]
        self.adapt_bucket = adapt_bucket
        self._occ_warm = make_occ_update_fn(field, cfg, all_cells=True)
        self._occ_sampled = make_occ_update_fn(field, cfg, all_cells=False)
        self._train_step = make_train_step(field, cfg, flags)
        self.timestamps_pool = torch.as_tensor(
            np.asarray(dataset.timestamps_pool, np.float32).reshape(-1, 1),
            device=self.device)

    def _warmup_now(self) -> bool:
        return self.step < self.cfg.occ_warmup_steps

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

    def run_chunk(self) -> dict:
        raise _later("Trainer.run_chunk (the scanned multi-step path)",
                     "scanned train-path")

    def resume(self, path: str) -> int:
        raise _later("Trainer.resume (checkpoints)", "scanned train-path")

    def run(self, total_steps: int, log_every: int = 10000, log_fn=print,
            hooks=(), checkpoint_dir=None, checkpoint_every: int = 0):
        """Step to `total_steps` with run_step. hooks: (step, fn) pairs, each
        fn() run once when training first reaches that step."""
        if checkpoint_dir or checkpoint_every:
            raise _later("checkpointing inside Trainer.run",
                         "scanned train-path")
        pending = sorted(hooks, key=lambda h: h[0])
        tic = time.time()
        while self.step <= total_steps:
            while pending and self.step >= pending[0][0]:
                pending.pop(0)[1]()
            m = self.run_step()
            if log_every and self.step % log_every == 0:
                log_fn(f"elapsed_time={time.time() - tic:.2f}s | "
                       f"step={self.step} | loss={m['loss']:.5f} | "
                       f"psnr={m['psnr']:.2f} | "
                       f"n_rendering_samples={int(m['n_samples'])} | "
                       f"num_rays={int(m['num_rays'])} |")
        return self.state
