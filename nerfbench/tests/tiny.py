"""Cells of the benchmark cut to a size the CPU runs in seconds, for the
tests: the same drivers, configurations and limits, with small grids,
tables and frames."""

import copy

from nerfbench.core import spec

SMALL_SCENE = dict(grid_resolution=32, max_march_steps=256,
                   hash_dst_resolution=64, log2_hashmap_size=12,
                   max_table_rows=128)
SMALL_ENCODER = dict(max_res=64, log2_hashmap_size=12, max_table_rows=128)

LISTED = [w["name"] for w in spec.load_benchmark()["workloads"]]
VIEW = [n for n in LISTED if "viewer" in n]


def tiny_cell(name: str):
    """The cell `name` of BENCHMARK.json at a tiny size."""
    cell = spec.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    wl = copy.deepcopy(cell.workload)
    p = wl["params"]
    cfg["scene"].update(SMALL_SCENE)
    p.update(width=24, warmup_frames=1, check_frames=2, trace_frames=1)
    p["grid"] = dict(p["grid"], grid_resolution=32)
    p["views"] = dict(p["views"], views=4, time_stride=3)
    cfg["field"]["encoder"].update(SMALL_ENCODER)
    cell.config, cell.workload = cfg, wl
    return cell
