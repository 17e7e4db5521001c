"""Field construction for a scene preset (port of engine/cli.py::build_field)."""

import numpy as np
import torch

from ..models.field import DNGPRadianceField
from ..utils.device import resolve_device
from .config import ModelFlags, SceneConfig


def build_field(cfg: SceneConfig, flags: ModelFlags, device="cuda",
                seed: int = 0) -> DNGPRadianceField:
    """Flagship model for a scene preset (train_real.py:253-265: the field's
    aabb is the *outermost* grid level's), initialised from `seed` with a
    CPU torch.Generator (so the weights do not depend on the device) and
    moved to `device`."""
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
    )
    field.reset_parameters(torch.Generator().manual_seed(seed))
    return field.to(dev).eval()
