"""Proposal-network training engine — port of
cednerf_tpu/engine/train_prop.py.

Proposal PDF-resampling replaces the occupancy grid (ops/proposal.py): the
sample buffers are dense [n_rays, n_samples] from the start, so no
compaction runs, and the proposal density fields (models/field.py
NGPDensityField) train jointly with the radiance field through the
mip-NeRF 360 outer-bound loss, under one optimizer over both, as the JAX
package's joint Adam does.

That optimizer (`PropOptimizer`) is optax's
apply_if_finite(add_decayed_weights -> clip_by_global_norm -> adam with the
LR schedule, max_consecutive_errors=1000) on the device: a step whose
gradients hold a non-finite value leaves the parameters, Adam's moments,
its count and the schedule's count as they were, each update selected by a
device-side flag, and the LR comes from the device count, so that a train
chunk reads nothing back before its metrics. The clip is optax's
(g * max_norm / norm when norm >= max_norm), not clip_grad_norm_'s.

`PropTrainer` runs K steps a call (device sampling, or stacked host batches
for the DyNeRF importance sampler) and keeps an occupancy grid for
eval-time culling only, one update a chunk (all cells through the
occupancy warmup, a sampled quarter after). Every random draw of the loop
comes from one torch.Generator: each step's batch, then its jitters.

With a mesh (parallel/mesh.py) every rank draws the global batch and
jitters and keeps its rows; its losses are means over its rows divided by
the mesh size, the gradients are summed over the ranks before the
optimizer (so its skip-nonfinite flag reads the summed gradients and every
rank skips together), and the metrics are global.
"""

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.field import NGPDensityField
from ..ops import losses as L
from ..ops.occupancy import (RaySamples, create_occ_grid, occupancy_lookup,
                             ray_aabb_intersect)
from ..ops.proposal import (anneal_factor, draw_jitter, proposal_loss,
                            proposal_sampling)
from ..parallel import mesh as pm
from ..utils.device import resolve_device
from .config import ModelFlags, SceneConfig
from .renderer import render_rays
from .sampling import make_stacked_sampler, upload_stacked
from .train import make_occ_update_fn

# the step's metrics, in the column order of make_prop_train_loop's stack;
# PropConfig.debug adds DEBUG_METRICS
PROP_METRICS = ("loss", "mse", "n_samples", "psnr")
DEBUG_METRICS = ("sigma_max", "w_max", "t_finite", "prop_w_max",
                 "grads_finite", "params_finite")


class PropOptimizer:
    """The prop path's optimizer on the device: optax's
    apply_if_finite(chain(add_decayed_weights(weight_decay),
    clip_by_global_norm(grad_clip), adam(make_lr_schedule(cfg),
    eps=1e-15)), max_consecutive_errors), each stage only when its value
    is > 0 (the JAX make_prop_optimizer). `step()` reads the parameters'
    .grad. Its state mirrors optax's: the moments mu / nu, Adam's count,
    the schedule's count and the wrapper's notfinite_count,
    total_notfinite and last_finite, all tensors on the parameters'
    device."""

    B1, B2, EPS = 0.9, 0.999, 1e-15

    def __init__(self, params, cfg: SceneConfig, grad_clip: float = 0.0,
                 weight_decay: float = 0.0,
                 max_consecutive_errors: int = 1000):
        self.params = list(params)
        dev = self.params[0].device
        self.base_lr = float(cfg.lr)
        self.grad_clip, self.weight_decay = grad_clip, weight_decay
        self.max_consecutive_errors = max_consecutive_errors
        f32 = dict(dtype=torch.float32, device=dev)
        self.milestones = torch.tensor(cfg.milestones, **f32)
        # the schedule's and the bias corrections' bases, on the device once
        self._bases = torch.tensor([0.33, self.B1, self.B2], **f32)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        i32 = dict(dtype=torch.int32, device=dev)
        self.count = torch.zeros((), **i32)
        self.schedule_count = torch.zeros((), **i32)
        self.notfinite_count = torch.zeros((), **i32)
        self.total_notfinite = torch.zeros((), **i32)
        self.last_finite = torch.ones((), dtype=torch.bool, device=dev)

    def lr(self, count: torch.Tensor) -> torch.Tensor:
        """make_lr_schedule on a device count: base * linear warmup *
        0.33^(milestones passed), in f32."""
        c = count.to(torch.float32)
        warm = torch.clamp(0.01 + (1.0 - 0.01) * c / 100.0, 0.01, 1.0)
        decay = torch.pow(self._bases[0], (c >= self.milestones).sum())
        return self.base_lr * warm * decay

    @torch.no_grad()
    def step(self):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        notfinite = torch.where(finite, torch.zeros_like(self.notfinite_count),
                                self.notfinite_count + 1)
        ok = finite | (notfinite > self.max_consecutive_errors)
        if self.weight_decay > 0:
            grads = [g + self.weight_decay * p
                     for g, p in zip(grads, self.params)]
        if self.grad_clip > 0:
            norm = torch.sqrt(torch.stack([(g * g).sum() for g in grads])
                              .sum())
            keep = norm < self.grad_clip
            grads = [torch.where(keep, g, (g / norm) * self.grad_clip)
                     for g in grads]
        count_inc = self.count + 1
        c = count_inc.to(torch.float32)
        bc1 = 1.0 - torch.pow(self._bases[1], c)
        bc2 = 1.0 - torch.pow(self._bases[2], c)
        step_size = -self.lr(self.schedule_count)
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m_new = (1 - self.B1) * g + self.B1 * m
            v_new = (1 - self.B2) * (g * g) + self.B2 * v
            upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + self.EPS)
            p.copy_(torch.where(ok, p + step_size * upd, p))
            m.copy_(torch.where(ok, m_new, m))
            v.copy_(torch.where(ok, v_new, v))
        self.count = torch.where(ok, count_inc, self.count)
        self.schedule_count = torch.where(ok, self.schedule_count + 1,
                                          self.schedule_count)
        self.total_notfinite = torch.where(finite, self.total_notfinite,
                                           self.total_notfinite + 1)
        self.notfinite_count = notfinite
        self.last_finite = finite

    _SCALARS = ("count", "schedule_count", "notfinite_count",
                "total_notfinite", "last_finite")

    def state_dict(self) -> dict:
        return {"mu": list(self.mu), "nu": list(self.nu),
                **{k: getattr(self, k) for k in self._SCALARS}}

    def load_state_dict(self, state: dict):
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, state["mu"] + state["nu"]):
                dst.copy_(src)
        for k in self._SCALARS:
            setattr(self, k, state[k].to(getattr(self, k).device))


def make_prop_optimizer(params, cfg: SceneConfig, grad_clip: float = 0.0,
                        weight_decay: float = 0.0) -> PropOptimizer:
    """The prop path's optimizer over `params` (see PropOptimizer)."""
    return PropOptimizer(params, cfg, grad_clip, weight_decay)


@dataclasses.dataclass(frozen=True)
class PropConfig:
    """Sampler shape config per scene family (the JAX PropConfig: same
    fields and defaults)."""

    prop_resolutions: Tuple[int, ...] = (128,)
    prop_samples: Tuple[int, ...] = (128,)
    n_final: int = 64
    unbounded: bool = False
    sampling_type: str = "uniform"  # bounded scenes sample uniformly in t
    anneal_steps: int = 1000
    # global-norm gradient clip (0 = off)
    grad_clip: float = 0.0
    # L2 weight decay toward zero (0 = off)
    weight_decay: float = 0.0
    # pre-activation density cap, applied to the radiance field and the
    # proposal density fields by the prop entry point (train_prop_real)
    density_clamp: float = 20.0
    # NaN-source telemetry in the step metrics (DEBUG_METRICS)
    debug: bool = False

    @classmethod
    def for_family(cls, family: str) -> "PropConfig":
        if family == "dnerf":
            return cls()
        # hypernerf / dynerf: two unbounded levels at 128/256 res
        return cls(prop_resolutions=(128, 256), prop_samples=(256, 96),
                   n_final=48, unbounded=True, sampling_type="lindisp")


@dataclasses.dataclass
class PropTrainState:
    """The radiance field, the proposal density fields and the one
    optimizer over both (JAX: params {'field', 'props'} and opt_state)."""

    field: torch.nn.Module
    props: Tuple[torch.nn.Module, ...]
    optimizer: PropOptimizer

    def modules(self):
        return (self.field,) + tuple(self.props)


def build_prop_networks(cfg: SceneConfig, pcfg: PropConfig, device="cuda",
                        seed: int = 0) -> Tuple[NGPDensityField, ...]:
    """One NGPDensityField (L5, 2^17, max resolution from
    pcfg.prop_resolutions) per proposal level over cfg.aabb, initialised
    from `seed` with a CPU generator and moved to `device` (CUDA unless
    device="cpu")."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return tuple(
        NGPDensityField(aabb=cfg.aabb, unbounded=pcfg.unbounded, n_levels=5,
                        max_resolution=res, log2_hashmap_size=17)
        .reset_parameters(gen).to(dev)
        for res in pcfg.prop_resolutions)


def create_prop_train_state(field, props, cfg: SceneConfig,
                            pcfg: Optional[PropConfig] = None,
                            device="cuda") -> PropTrainState:
    """Move the field and the proposal fields (initialised) to `device` and
    build the optimizer over all of their parameters."""
    dev = resolve_device(device)
    field.to(dev)
    props = tuple(p.to(dev) for p in props)
    params = list(field.parameters()) + [q for p in props
                                         for q in p.parameters()]
    opt = make_prop_optimizer(params, cfg, pcfg.grad_clip if pcfg else 0.0,
                              pcfg.weight_decay if pcfg else 0.0)
    return PropTrainState(field=field, props=props, optimizer=opt)


def _make_near_far(cfg: SceneConfig, pcfg: PropConfig, device):
    """near_far(origins, viewdirs) -> per-ray (near, far) [R]: the planes
    for unbounded scenes (far capped at 1e4 for lindisp), else the
    ray's span in cfg.aabb clamped to them."""
    aabb = torch.tensor(cfg.aabb, dtype=torch.float32, device=device)
    far_cap = min(cfg.far_plane, 1e4)

    def near_far(origins, viewdirs):
        if pcfg.unbounded:
            near = torch.full((origins.shape[0],), cfg.near_plane,
                              device=origins.device)
            return near, torch.full_like(near, far_cap)
        t_min, t_max = ray_aabb_intersect(origins, viewdirs, aabb)
        near = torch.clamp(t_min, min=cfg.near_plane)
        far = torch.maximum(torch.clamp(t_max, max=cfg.far_plane),
                            near + 1e-4)
        return near, far

    return near_far


def _make_prop_loss_fn(field, cfg: SceneConfig, flags: ModelFlags,
                       pcfg: PropConfig, mesh=None):
    """loss_and_grads(state, batch, step, generator=None, jitters=None) ->
    (loss, aux): proposal sampling (jitters as proposal_sampling takes
    them, else drawn from `generator`), the field on the final samples,
    the losses, and backward into every parameter's .grad (zeroed first;
    zeros where no gradient flows, as optax sees them). `step` (a number
    or a 0-d device tensor) sets the anneal factor.

    mesh: the batch and jitters are the global ones (jitters drawn for
    every ray, in proposal_sampling's order); the rank keeps its rows, its
    loss is divided by the mesh size and the gradients are summed over the
    ranks; loss, mse and n_samples in the result are the rank's parts."""
    near_far = _make_near_far(cfg, pcfg, next(field.parameters()).device)
    counts = list(pcfg.prop_samples[1:]) + [pcfg.n_final]

    def loss_and_grads(state: PropTrainState, batch: dict, step,
                       generator: Optional[torch.Generator] = None,
                       jitters: Optional[Sequence[torch.Tensor]] = None):
        if mesh is not None:
            n = batch["origins"].shape[0]
            if jitters is None and generator is not None:
                dev = batch["origins"].device
                jitters = [draw_jitter(n, k, generator, dev)
                           for k in [pcfg.prop_samples[0]] + counts]
            batch = pm.shard_batch(batch, mesh, n_rows=n)
            if jitters is not None:
                jitters = [j[mesh.rows(n)] for j in jitters]
        anneal = anneal_factor(step, pcfg.anneal_steps)
        origins, viewdirs = batch["origins"], batch["viewdirs"]
        near, far = near_far(origins, viewdirs)
        for mod in state.modules():
            mod.zero_grad(set_to_none=False)
        t0, t1, records = proposal_sampling(
            state.props, list(pcfg.prop_samples), pcfg.n_final, origins,
            viewdirs, near, far, sampling_type=pcfg.sampling_type,
            generator=generator, jitters=jitters,
            anneal=anneal.to(origins.device))
        samples = RaySamples(t_starts=t0, t_ends=t1,
                             mask=torch.ones_like(t0, dtype=torch.bool))
        out = render_rays(state.field, origins, viewdirs, samples,
                          batch["timestamps"], batch["color_bkgd"],
                          alpha_thre=0.0, train=True)
        extras = out.extras
        mse = torch.mean((out.rgb - batch["pixels"]) ** 2)
        loss = mse
        # s-space final edges for the outer-bound loss
        n, f = near[:, None], far[:, None]
        if pcfg.sampling_type == "uniform":
            s0, s1 = (t0 - n) / (f - n), (t1 - n) / (f - n)
        else:
            def inv(t):
                return (1.0 / n - 1.0 / t) / (1.0 / n - 1.0 / f)
            s0, s1 = inv(t0), inv(t1)
        s_edges = torch.cat([s0, s1[:, -1:]], dim=-1)
        loss = loss + proposal_loss(records, s_edges, extras["weights"])
        if flags.use_opacity_loss:
            loss = loss + L.opacity_loss(out.opacity) * 1e-3
        if flags.distortion_loss:
            loss = loss + L.distortion_loss(extras["weights"], t0, t1) * 1e-3
        if flags.acc_entropy_loss:
            loss = loss + L.acc_entropy_loss(out.opacity) * 1e-3
        if flags.use_feat_predict:
            loss = loss + torch.mean(extras["latent_losses"])
        if flags.use_weight_predict:
            loss = loss + torch.mean(extras["weight_losses"])
        if mesh is not None:        # equal shards: the mean of the means
            loss, mse = loss / mesh.size, mse / mesh.size
        loss.backward()
        for mod in state.modules():
            for p in mod.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        if mesh is not None:
            pm.all_reduce_grads(state.optimizer.params, mesh)
        aux = {"mse": mse.detach(), "n_samples": out.n_samples}
        if pcfg.debug:
            aux.update(
                sigma_max=extras["sigmas"].detach().max(),
                w_max=extras["weights"].detach().max(),
                t_finite=torch.isfinite(t0).all().float(),
                prop_w_max=records[0].weights.detach().max())
        return loss.detach(), aux

    return loss_and_grads


def _all_finite(tensors) -> torch.Tensor:
    return torch.stack([torch.isfinite(t).all() for t in tensors]
                       ).all().float()


def _global_prop_metrics(m: dict, mesh) -> dict:
    """A mesh step's metrics over every ray (one all-gather): the partial
    loss and mse and the sample counts summed, the debug maxima and finite
    flags reduced by max and min."""
    keys = [k for k in m if k != "psnr"]
    rows = pm.all_gather_rows(torch.stack([m[k].float() for k in keys])[None],
                              mesh)
    tot, top, low = rows.sum(0), rows.max(0).values, rows.min(0).values
    red = {"sigma_max": top, "w_max": top, "prop_w_max": top,
           "t_finite": low, "grads_finite": low, "params_finite": low}
    out = {k: red.get(k, tot)[i] for i, k in enumerate(keys)}
    out["psnr"] = -10.0 * torch.log(out["mse"]) / math.log(10.0)
    return out


def make_prop_train_step(field, props, cfg: SceneConfig, flags: ModelFlags,
                         pcfg: PropConfig, mesh=None):
    """train_step(state, batch, step, generator=None, jitters=None) ->
    (state, metrics of 0-d device tensors): sample -> render -> losses ->
    the optimizer. batch: origins/viewdirs/pixels [R, 3], timestamps
    [R, 1], color_bkgd [3] on the state's device (with a mesh the global
    batch; the metrics are then over every rank's rays)."""
    loss_and_grads = _make_prop_loss_fn(field, cfg, flags, pcfg, mesh)

    def train_step(state: PropTrainState, batch: dict, step,
                   generator: Optional[torch.Generator] = None,
                   jitters: Optional[Sequence[torch.Tensor]] = None):
        loss, aux = loss_and_grads(state, batch, step, generator, jitters)
        state.optimizer.step()
        metrics = {"loss": loss, "mse": aux["mse"],
                   "n_samples": aux["n_samples"].float(),
                   "psnr": -10.0 * torch.log(aux["mse"]) / math.log(10.0)}
        if pcfg.debug:
            params = state.optimizer.params
            metrics.update(
                {k: aux[k] for k in ("sigma_max", "w_max", "t_finite",
                                     "prop_w_max")},
                grads_finite=_all_finite([p.grad for p in params]),
                params_finite=_all_finite(params))
        if mesh is not None:
            metrics = _global_prop_metrics(metrics, mesh)
        return state, metrics

    return train_step


def metric_names(pcfg: PropConfig) -> Tuple[str, ...]:
    return PROP_METRICS + (DEBUG_METRICS if pcfg.debug else ())


def make_prop_train_loop(field, props, cfg: SceneConfig, flags: ModelFlags,
                         pcfg: PropConfig, n_rays: int, sample_fn,
                         k_steps: int, mesh=None):
    """K proposal-path steps per call: the JAX lax.scan as a Python loop.
    Returns fn(state, data, generator, step0) -> (state, metrics
    [K, len(metric_names(pcfg))] on the device). Step i (global step
    step0 + i, a device tensor) draws its batch (sample_fn(data,
    generator, n_rays, i)) and then its jitters from `generator`. Nothing
    is read back to the host inside the loop. mesh: as make_train_loop's
    (each step global batch, the rank's rows, summed gradients)."""
    step_fn = make_prop_train_step(field, props, cfg, flags, pcfg, mesh)
    names = metric_names(pcfg)

    def prop_loop(state: PropTrainState, data, generator: torch.Generator,
                  step0: int):
        dev = state.optimizer.count.device
        steps = torch.arange(step0, step0 + k_steps, dtype=torch.int32,
                             device=dev)
        rows = []
        for i in range(k_steps):
            batch = sample_fn(data, generator, n_rays, i)
            state, m = step_fn(state, batch, steps[i], generator=generator)
            rows.append(torch.stack([m[k].float() for k in names]))
        return state, torch.stack(rows)

    return prop_loop


class PropTrainer:
    """Host-side proposal-path loop (the prop twin of engine/train.py's
    Trainer): K steps a call through make_prop_train_loop, metrics read
    back once a chunk.

    device_sampler: a (data, sample_fn) pair (engine/sampling.py) on
    `device`, or None with a `dataset` exposing sample(n_rays): each
    chunk's K host batches are then stacked, uploaded in one non_blocking
    copy and the next chunk's assembled while the card runs this one (the
    DyNeRF importance-sampling path). occ_eval keeps an occupancy grid on
    the occ path's EMA cadence for eval-time sample culling only (one
    update a chunk: all cells while step <= cfg.occ_warmup_steps, a sampled
    quarter after), probed at the dataset's timestamps_pool (16 times in
    [0, 1] without a dataset). mesh (parallel/mesh.py): ray-sharded data
    parallelism on the mesh's device, as Trainer's: the networks and the
    grid broadcast from rank 0, the same draws on every rank, n_rays the
    global batch (a multiple of mesh.size)."""

    def __init__(self, field, props, cfg: SceneConfig, flags: ModelFlags,
                 pcfg: PropConfig, device_sampler, n_rays: int,
                 seed: int = 42, steps_per_call: int = 16, mesh=None,
                 dataset=None, occ_eval: bool = True, device="cuda"):
        self.mesh = mesh
        if mesh is not None:
            mesh.rows(n_rays)                  # checks the split
            device = mesh.device
        self.device = resolve_device(device)
        self.cfg, self.flags, self.pcfg = cfg, flags, pcfg
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)
        self.state = create_prop_train_state(field, props, cfg, pcfg,
                                             device=self.device)
        self.field, self.props = self.state.field, self.state.props
        if mesh is not None:
            pm.replicate(list(self.state.modules()), mesh)
        self.step = 0
        self.n_rays = n_rays
        self.steps_per_call = steps_per_call
        self.dataset = dataset
        self._prefetched = None
        self._stacked = device_sampler is None
        if self._stacked:
            if dataset is None:
                raise ValueError("stacked-host PropTrainer needs a dataset")
            device_sampler = (None, make_stacked_sampler())
        self.device_sampler = device_sampler
        self.occ = None
        if occ_eval:
            self.occ = create_occ_grid(cfg.aabb, cfg.grid_resolution,
                                       cfg.grid_nlvl, device=self.device)
            self._occ_warm = make_occ_update_fn(self.field, cfg,
                                                all_cells=True)
            self._occ_samp = make_occ_update_fn(self.field, cfg,
                                                all_cells=False)
            tp = getattr(dataset, "timestamps_pool", None)
            pool = (np.asarray(tp, np.float32) if tp is not None
                    else np.linspace(0.0, 1.0, 16, dtype=np.float32))
            self.timestamps_pool = torch.as_tensor(
                pool.reshape(-1, 1), device=self.device)
        self.metric_names = metric_names(pcfg)
        if mesh is not None and self.occ is not None:
            pm.replicate(self.occ, mesh)
        self._loop = make_prop_train_loop(
            self.field, self.props, cfg, flags, pcfg, n_rays,
            device_sampler[1], steps_per_call, mesh=mesh)

    def _assemble_stacked(self) -> dict:
        batches = [self.dataset.sample(self.n_rays)
                   for _ in range(self.steps_per_call)]
        return upload_stacked({k: np.stack([np.asarray(b[k]) for b in batches])
                               for k in batches[0]}, self.device)

    def dispatch_chunk(self) -> torch.Tensor:
        """Enqueue the chunk's steps and its occupancy update and advance
        self.step; returns the metrics [K, len(metric_names)] on the
        device, with no host read."""
        if self._stacked:
            data = (self._prefetched if self._prefetched is not None
                    else self._assemble_stacked())
            self._prefetched = None
        else:
            data = self.device_sampler[0]
        self.state, metrics = self._loop(self.state, data, self.generator,
                                         self.step)
        if self._stacked:
            # assembled while the card runs the chunk above
            self._prefetched = self._assemble_stacked()
        self.step += self.steps_per_call
        if self.occ is not None:
            occ_fn = (self._occ_warm if self.step <= self.cfg.occ_warmup_steps
                      else self._occ_samp)
            self.occ = occ_fn(self.occ, self.timestamps_pool, self.generator)
        return metrics

    def run_chunk(self) -> dict:
        """steps_per_call steps, then the chunk's one device->host read:
        the means of its metrics (the maxima / minima of the debug ones)."""
        rows = self.dispatch_chunk().tolist()     # the chunk's one host read
        cols = dict(zip(self.metric_names, zip(*rows)))
        mse = float(np.mean(cols["mse"]))
        out = {"loss": float(np.mean(cols["loss"])), "mse": mse,
               "psnr": float(-10.0 * np.log(max(mse, 1e-12)) / np.log(10.0)),
               "n_samples": float(np.mean(cols["n_samples"])),
               "num_rays": self.n_rays, "steps": self.steps_per_call}
        if self.pcfg.debug:
            for k in ("sigma_max", "w_max", "prop_w_max"):
                out[k] = float(np.max(cols[k]))
            for k in ("t_finite", "grads_finite", "params_finite"):
                out[k] = float(np.min(cols[k]))
        return out


def make_prop_eval_render_fn(field, props, cfg: SceneConfig,
                             pcfg: PropConfig):
    """Chunk renderer of the proposal path for render_image:
    fn(occ_state, origins [C, 3], viewdirs [C, 3], timestamp, render_bkgd)
    -> (rgb, opacity, depth). Deterministic proposal sampling (no jitter,
    anneal 1); with an occupancy state the final samples in unoccupied
    cells are masked out (PropTrainer.occ's fog filter), with None every
    sample counts."""
    near_far = _make_near_far(cfg, pcfg, next(field.parameters()).device)

    @torch.inference_mode()
    def render_chunk(occ_state, origins, viewdirs, timestamp, render_bkgd):
        near, far = near_far(origins, viewdirs)
        t0, t1, _ = proposal_sampling(
            props, list(pcfg.prop_samples), pcfg.n_final, origins, viewdirs,
            near, far, sampling_type=pcfg.sampling_type)
        mask = torch.ones_like(t0, dtype=torch.bool)
        if occ_state is not None:
            t_mid = (t0 + t1) / 2.0
            pos = origins[:, None, :] + viewdirs[:, None, :] * t_mid[..., None]
            mask = occupancy_lookup(occ_state, pos)
        bkgd = torch.as_tensor(np.asarray(render_bkgd, np.float32),
                               device=origins.device)
        out = render_rays(field, origins, viewdirs,
                          RaySamples(t_starts=t0, t_ends=t1, mask=mask),
                          timestamp, bkgd, train=False)
        return out.rgb, out.opacity, out.depth

    return render_chunk
