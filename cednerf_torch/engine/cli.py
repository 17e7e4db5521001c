"""The CLI flag surface and field construction — port of
cednerf_tpu/engine/cli.py (`get_model_args`, `apply_perf_overrides`,
`flags_from_args`, `build_field`): the same flags, short forms, defaults
and choices, so that one command line means the same run in both packages.

Every value of the JAX flag surface has its path in the port; nothing
is ignored. Every
`--scatter_impl`, `--interp_impl` and `--compact_impl` choice computes the
same sums, so each takes the port's kernels (ops/brick_grid.py,
engine/renderer.py).
"""

import argparse
import dataclasses

import numpy as np
import torch

from ..models.field import DNGPRadianceField
from ..utils.device import resolve_device
from .config import ModelFlags, SceneConfig


def get_model_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The exact flag surface of the reference's opt.py (incl. short names)."""
    parser.add_argument("-df", "--use_div_offsets", action="store_true",
                        help="predict offsets with two separated predictions")
    parser.add_argument("-f", "--use_feat_predict", action="store_true",
                        help="use an mlp to predict the hash feature")
    parser.add_argument("-w", "--use_weight_predict", action="store_true",
                        help="use an mlp to predict the weight feature")
    parser.add_argument("-te", "--use_time_embedding", action="store_true",
                        help="predict density with time embedding")
    parser.add_argument("-ta", "--use_time_attenuation", action="store_true",
                        help="use time attenuation in time embedding")
    parser.add_argument("-ms", "--moving_step", type=float, default=1e-4,
                        help="accepted for the reference's command lines; "
                             "runs use the preset's moving_step, as the JAX "
                             "package does")
    parser.add_argument("-o", "--use_opacity_loss", action="store_true",
                        help="use an opacity loss")
    parser.add_argument("-d", "--distortion_loss", action="store_true",
                        help="use a distortion loss")
    parser.add_argument("-wr", "--weight_rgbper", action="store_true",
                        help="use weighted rgbs for rgb")
    # the reference names this flag 'acc_entorpy_loss' (sic); accept both
    parser.add_argument("-ae", "--acc_entropy_loss", "--acc_entorpy_loss",
                        action="store_true", dest="acc_entropy_loss",
                        help="use accumulated opacities as entropy loss")
    parser.add_argument("--render_video", action="store_true", help="render video")
    parser.add_argument("--load_model", action="store_true", help="load model")
    parser.add_argument("--grid_type", type=str, default="hash3d",
                        choices=["hash3d", "hash4d", "triplane"],
                        help="spatial encoder: motion-warped 3D hash grid "
                             "(reference default), 4D xyz+t keyframe grid, "
                             "or factored tri-planes")
    parser.add_argument("--hash4motion", action="store_true",
                        help="hash-grid motion net variant (model.py:165-199)")
    parser.add_argument("--hash_levels", type=int, default=None,
                        help="override encoder level count (preset default 8; "
                             "reference parity: 16)")
    parser.add_argument("--hash_features", type=int, default=None,
                        help="override features per level (preset default 4; "
                             "reference parity: 2)")
    parser.add_argument("--sample_budget", type=int, default=None,
                        help="override target_sample_batch_size (per-step "
                             "valid-sample budget; preset default 2^18)")
    parser.add_argument("--scatter_impl", type=str, default=None,
                        choices=["xla", "fused", "onehot", "auto"],
                        help="encoder table-grad scatter impl "
                             "(engine/config.py; every choice takes the "
                             "port's kernels)")
    parser.add_argument("--interp_impl", type=str, default=None,
                        choices=["xla"],
                        help="encoder interpolation impl (engine/config.py)")
    parser.add_argument("--fine_table_rows", type=int, default=None,
                        help="fine-level (>=5) brick-table rows (e.g. 65536;"
                             " cuts fine-level hash aliasing at HBM cost)")
    parser.add_argument("--compact_impl", type=str, default=None,
                        choices=["xla", "rayfold"],
                        help="budget-compaction impl (engine/config.py; "
                             "both take K4)")
    parser.add_argument("--max_table_rows", type=int, default=None,
                        help="brick-encoder per-level table-row cap "
                             "(default 16384 = 2^20 corner slots/level)")
    parser.add_argument("--remat_feats", action="store_true",
                        help="re-gather encoder rows in the backward instead "
                             "of saving [N, 64F] residuals (the K1/K2 route; "
                             "the K5/K6 route saves none)")
    parser.add_argument("--row_layout", type=str, default=None,
                        choices=["brick", "cell"],
                        help="hashed-level hot-row layout: 'cell' keeps the "
                             "JAX cell levels' bf16 table-gradient rounding "
                             "(ops/brick_grid.py)")
    parser.add_argument("--steady_march_steps", type=int, default=None,
                        help="empty-space-skipping steady-state lattice "
                             "slots (0 = full max_march_steps; "
                             "engine/config.py steady_march_steps)")
    return parser


def apply_perf_overrides(cfg: SceneConfig, args) -> SceneConfig:
    """Apply the optional perf-knob CLI overrides to a SceneConfig."""
    upd = {}
    if getattr(args, "sample_budget", None):
        upd["target_sample_batch_size"] = args.sample_budget
    if getattr(args, "scatter_impl", None):
        upd["scatter_impl"] = args.scatter_impl
    if getattr(args, "interp_impl", None):
        upd["interp_impl"] = args.interp_impl
    if getattr(args, "max_table_rows", None):
        upd["max_table_rows"] = args.max_table_rows
    if getattr(args, "compact_impl", None):
        upd["compact_impl"] = args.compact_impl
    if getattr(args, "fine_table_rows", None):
        upd["fine_table_rows"] = args.fine_table_rows
    if getattr(args, "remat_feats", False):
        upd["remat_feats"] = True
    if getattr(args, "row_layout", None):
        upd["row_layout"] = args.row_layout
    if getattr(args, "steady_march_steps", None) is not None:
        upd["steady_march_steps"] = args.steady_march_steps
    return dataclasses.replace(cfg, **upd) if upd else cfg


def flags_from_args(args) -> ModelFlags:
    return ModelFlags(
        use_div_offsets=args.use_div_offsets,
        use_feat_predict=args.use_feat_predict,
        use_weight_predict=args.use_weight_predict,
        use_time_embedding=args.use_time_embedding,
        use_time_attenuation=args.use_time_attenuation,
        use_opacity_loss=args.use_opacity_loss,
        distortion_loss=args.distortion_loss,
        weight_rgbper=args.weight_rgbper,
        acc_entropy_loss=args.acc_entropy_loss,
        grid_type=getattr(args, "grid_type", "hash3d"),
        hash4motion=getattr(args, "hash4motion", False),
    )


def build_field(cfg: SceneConfig, flags: ModelFlags, device="cuda",
                seed: int = 0, encoder_impl: str = "brick"
                ) -> DNGPRadianceField:
    """Flagship model for a scene preset (train_real.py:253-265: the field's
    aabb is the *outermost* grid level's), initialised from `seed` with a
    CPU torch.Generator (so the weights do not depend on the device) and
    moved to `device`. encoder_impl "gather" takes the exact per-corner
    encoder (the JAX validator's `.clone(encoder_impl=...)`)."""
    dev = resolve_device(device)
    aabb = np.asarray(cfg.aabb, np.float32)
    center = (aabb[:3] + aabb[3:]) / 2
    half = (aabb[3:] - aabb[:3]) / 2 * (2.0 ** (cfg.grid_nlvl - 1))
    outer = tuple(np.concatenate([center - half, center + half]).tolist())
    field = DNGPRadianceField(
        aabb=outer,
        moving_step=cfg.moving_step,
        n_levels=cfg.hash_n_levels,
        n_features_per_level=cfg.hash_n_features,
        dst_resolution=cfg.hash_dst_resolution,
        log2_hashmap_size=cfg.log2_hashmap_size,
        use_div_offsets=flags.use_div_offsets,
        use_time_embedding=flags.use_time_embedding,
        use_time_attenuation=flags.use_time_attenuation,
        use_feat_predict=flags.use_feat_predict,
        use_weight_predict=flags.use_weight_predict,
        hash4motion=flags.hash4motion,
        time_inject_before_sigma=flags.time_inject_before_sigma,
        grid_type=flags.grid_type,
        grad_accum_dtype=cfg.grad_accum_dtype,
        scatter_impl=cfg.scatter_impl,
        interp_impl=cfg.interp_impl,
        max_table_rows=cfg.max_table_rows,
        fine_table_rows=cfg.fine_table_rows,
        fine_from_level=cfg.fine_from_level,
        remat_feats=cfg.remat_feats,
        row_layout=cfg.row_layout,
        cell_rows_cap=cfg.cell_rows_cap,
        encoder_impl=encoder_impl,
    )
    field.reset_parameters(torch.Generator().manual_seed(seed))
    return field.to(dev).eval()
