"""Per-dataset training/rendering presets + model flags.

The port's own copy of `cednerf_tpu/engine/config.py` (`ModelFlags`,
`SceneConfig`, the presets `dnerf_config`, `hypernerf_config`,
`dynerf_config` and the scene-name dispatch `config_for_scene`), kept
field-for-field identical so that a preset means the same run in both
packages (tests/test_torch_field.py::test_config_copy_matches_jax holds the
two side by side). The fields of paths still to port (the cell layouts,
multi-device compaction) are carried so that presets stay whole.
"""

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelFlags:
    """The opt.py model/loss flags (opt.py:5-87)."""

    use_div_offsets: bool = False      # -df
    use_feat_predict: bool = False     # -f
    use_weight_predict: bool = False   # -w
    use_time_embedding: bool = False   # -te
    use_time_attenuation: bool = False # -ta
    use_opacity_loss: bool = False     # -o
    distortion_loss: bool = False      # -d
    weight_rgbper: bool = False        # -wr
    acc_entropy_loss: bool = False     # -ae  (reference spells it 'entorpy')
    hash4motion: bool = False
    time_inject_before_sigma: bool = True
    grid_type: str = "hash3d"


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Everything static about a training run (shapes, schedules, scene box)."""

    family: str                         # 'dnerf' | 'hypernerf' | 'dynerf'
    max_steps: int
    target_sample_batch_size: int       # valid-sample budget per step
    aabb: Tuple[float, ...]
    near_plane: float
    far_plane: float
    moving_step: float
    hash_dst_resolution: int
    grid_resolution: int
    grid_nlvl: int
    render_step_size: float
    alpha_thre: float
    cone_angle: float
    milestones: Tuple[int, ...]
    lr: float = 1e-2
    log2_hashmap_size: int = 21         # train_real.py:262
    # encoder levels x features per level: 8 x 4, the same 32-dim output as
    # the reference's 16 x 2 (model.py:242-252)
    hash_n_levels: int = 8
    hash_n_features: int = 4
    # Encoder implementation knobs (see BrickGridSpec in ops/brick_grid.py).
    # The 3D encoder reads interp_impl ("interp" takes kernels K1/K2, every
    # other value K5/K6), max_table_rows, fine_table_rows, fine_from_level
    # and row_layout; grad_accum_dtype rounds the f32 table gradient once;
    # the 4D encoder's table gradient takes kernel K3 for every
    # scatter_impl; remat_feats and cell_rows_cap arrive with later slices.
    grad_accum_dtype: str = "bfloat16"  # table-gradient accumulator dtype
    scatter_impl: str = "xla"           # table-gradient scatter route
    interp_impl: str = "xla"
    max_table_rows: int = 16384         # per-level brick-table row cap
    fine_table_rows: int = 0            # cap from fine_from_level; 0 = none
    fine_from_level: int = 5
    cell_rows_cap: int = 524288         # cell layout row guard
    remat_feats: bool = False           # re-gather rows in the backward
    row_layout: str = "brick"           # "brick" | "cell" | "cellz"
    # training-step knobs (budget compaction, per-slot assembly, packed
    # compositing), read by the training slice
    compact_impl: str = "rayfold"
    assembly_impl: str = "cumsum"
    packed_render: bool = True
    init_batch_size: int = 1024
    max_march_steps: int = 1024         # candidate steps per ray
    # steady-state lattice shrinking after occupancy warmup (training only)
    steady_march_steps: int = 0
    steady_march_auto: bool = True
    occ_update_interval: int = 16       # nerfacc update_every_n_steps default
    occ_warmup_steps: int = 256
    occ_thre: float = 1e-2
    occ_ema_decay: float = 0.95
    train_bkgd_aug: str = "white"
    test_bkgd_aug: str = "white"
    dataset_factor: int = 1
    add_cam: bool = False
    eval_s_max: int = 256               # per-ray sample cap for eval rendering
    eval_chunk: int = 4096              # rays per eval chunk (lattice path)
    # rays per chunk for the segment-compacted eval path: its per-chunk
    # fixed costs (coarse probes, pooled grid) amortize over large chunks
    eval_chunk_seg: int = 32768
    # the ray-count feedback targets demand = this fraction of sample_budget
    budget_headroom: float = 0.95
    compact_blocks: int = 1             # ray blocks compacted independently
    # two-stage segment marching and per-ray candidate packing (training)
    march_seg: int = 0
    seg_overcommit: float = 1.5
    seg_pool: int = 4
    steady_s_cap: int = 0

    @property
    def sample_budget(self) -> int:
        """Fixed field-evaluation batch per train step (compacted samples).

        Matches the reference's dynamic-batching sample target
        (train_real.py:354-360); the field always evaluates exactly this many
        sample slots, and the host adapts the *ray count* so the valid-sample
        demand tracks it.
        """
        return self.target_sample_batch_size

    def ray_buckets(self) -> Tuple[int, ...]:
        """Allowed ray counts: a ~2^(1/8) geometric ladder of multiples of 64.

        Bucket utilization of the fixed sample budget is headroom/ratio ..
        headroom, so the ratio directly bounds wasted field-eval slots
        (2^(1/8) => >=87% at headroom 0.95; the earlier 2^(1/4) ladder
        floored at 80%).

        The floor keeps warmup legal: with a fully dense grid every candidate
        is valid, so demand = n_rays * max_march_steps must be able to sit at
        ~the budget. Rounding the floor DOWN (not up) to the 64-multiple
        keeps warmup demand <= budget, so warmup steps never sit in routine
        last-ray truncation (they'd be loss-masked, starving those rays).
        """
        lo = max((self.sample_budget // self.max_march_steps) // 64 * 64, 64)
        hi = self.sample_budget // 16  # cap: >=16 expected samples/ray
        out = [lo]
        while True:
            n = -(-int(out[-1] * 2 ** 0.125) // 64) * 64
            if n > hi:
                break
            out.append(n)
        return tuple(out)

    def pick_ray_bucket(self, mean_samples_per_ray: float) -> int:
        """Largest bucket whose expected demand fits inside the headroom."""
        desired = self.budget_headroom * self.sample_budget / max(
            mean_samples_per_ray, 1.0)
        buckets = self.ray_buckets()
        for n in reversed(buckets):
            if n <= desired:
                return n
        return buckets[0]


def _milestones(max_steps: int, extra_56: bool = False) -> Tuple[int, ...]:
    ms = [max_steps // 2, max_steps * 3 // 4]
    if extra_56:
        ms.append(max_steps * 5 // 6)
    ms.append(max_steps * 9 // 10)
    return tuple(ms)


def dnerf_config(max_steps: int = 20000) -> SceneConfig:
    """D-NeRF synthetic preset (train_real.py:86-117)."""
    return SceneConfig(
        family="dnerf",
        max_steps=max_steps,
        target_sample_batch_size=1 << 18,
        aabb=(-1.5, -1.5, -1.5, 1.5, 1.5, 1.5),
        near_plane=0.0,
        far_plane=1e10,
        moving_step=1e-4,
        hash_dst_resolution=1024,
        grid_resolution=128,
        grid_nlvl=1,
        render_step_size=5e-3,
        alpha_thre=0.0,
        cone_angle=0.0,
        milestones=_milestones(max_steps),
        # aabb diagonal 3*sqrt(3) / 5e-3 ~= 1040 uniform steps
        max_march_steps=1024,
        train_bkgd_aug="white",
        test_bkgd_aug="white",
    )


def hypernerf_config(scene: str, max_steps: int = 20000) -> SceneConfig:
    """HyperNeRF real-capture preset (train_real.py:119-149)."""
    return SceneConfig(
        family="hypernerf",
        max_steps=max_steps,
        target_sample_batch_size=1 << 18,
        aabb=(-1.0, -1.0, -1.0, 1.0, 1.0, 1.0),
        near_plane=0.2,
        far_plane=1e10,
        moving_step=1.0 / 4096,
        hash_dst_resolution=4096,
        grid_resolution=128,
        grid_nlvl=2,
        render_step_size=1e-3,
        alpha_thre=1e-2,
        cone_angle=0.004,
        milestones=_milestones(max_steps),
        max_march_steps=1024,
        train_bkgd_aug="black",
        test_bkgd_aug="black",
        dataset_factor=2,
        add_cam="vrig" in scene,
    )


def dynerf_config(max_steps: int = 40000) -> SceneConfig:
    """DyNeRF multi-camera video preset (train_real.py:151-182)."""
    grid_nlvl = 4
    return SceneConfig(
        family="dynerf",
        max_steps=max_steps,
        target_sample_batch_size=1 << 20,
        aabb=(-1.0, -1.0, -1.0, 1.0, 1.0, 1.0),
        near_plane=0.2,
        far_plane=1e10,
        moving_step=1.0 / (2048 * grid_nlvl),
        hash_dst_resolution=2048 * grid_nlvl,
        grid_resolution=128,
        grid_nlvl=grid_nlvl,
        render_step_size=1e-3,
        alpha_thre=1e-2,
        cone_angle=0.004,
        milestones=_milestones(max_steps, extra_56=True),
        # outer level aabb is +-8; geometric step growth bounds the count
        max_march_steps=1536,
        train_bkgd_aug="random",
        test_bkgd_aug="black",
        dataset_factor=4,
    )


def config_for_scene(scene: str,
                     max_steps: Optional[int] = None) -> SceneConfig:
    """Scene-name -> preset dispatch (train_real.py:86,119,151)."""
    from ..datasets import (DNERF_SYNTHETIC_SCENES, DYNERF_SCENES,
                            HYPERNERF_SCENES)

    if scene.startswith("procedural"):
        # dataset-free analytic scenes (datasets/procedural.py)
        return dnerf_config(max_steps or 2000)
    if scene in DNERF_SYNTHETIC_SCENES:
        return dnerf_config(max_steps or 20000)
    if scene in HYPERNERF_SCENES:
        return hypernerf_config(scene, max_steps or 20000)
    if scene in DYNERF_SCENES:
        return dynerf_config(max_steps or 40000)
    raise ValueError(f"unknown scene: {scene}")
