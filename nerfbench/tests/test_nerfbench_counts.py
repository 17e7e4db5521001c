"""The yardstick's counts against hand counts at tiny sizes."""

import copy
import json

import pytest

from nerfbench.core import spec
from nerfbench.counts import bytes as nbytes
from nerfbench.counts import flops, peaks
from nerfbench.reference.field import level_layout, param_specs


def test_encode_fwd_bytes():
    # n=2 samples, L=3 levels, F=4, R=5 rows of 64*4 bf16; bf16 output
    b, f = nbytes.encode_fwd(2, 3, 4, 5)
    assert b == 2 * 12 + 3 * 2 * 4 + 5 * 256 * 2 + 2 * 3 * 4 * 2
    assert f == 2 * 3 * 8 * 4 * 2


def test_least_seconds():
    pk = peaks.peaks("NVIDIA H100 80GB HBM3")
    assert nbytes.least_seconds(3.35e12, 0, pk) == pytest.approx(1.0)
    assert nbytes.least_seconds(0, 67e12, pk) == pytest.approx(1.0)
    with pytest.raises(KeyError):
        peaks.peaks("some other card")


def _config():
    cell = spec.load_cell(spec.load_benchmark()["workloads"][0]["name"])
    return copy.deepcopy(cell.config)


def test_mlp_flops_by_hand():
    cfg = _config()
    # motion: 36->64->64->64->6; base: 41->64->16 (8 levels x 4 features
    # and a 9-wide time embedding); head: 19->64->64->3
    motion = 36 * 64 + 64 * 64 * 2 + 64 * 6
    base = 41 * 64 + 64 * 16
    head = 19 * 64 + 64 * 64 + 64 * 3
    assert flops.row_flops(cfg, "density") == 2 * (motion + base)
    assert flops.row_flops(cfg, "render") == 2 * (motion + base + head)


def test_tiny_layout_by_hand():
    """Two levels from 4 to 8: scales 3 and 7, resolutions 4 and 8, 2 and
    3 bricks an axis; a cap of 10 rows hashes the second (27 > 10)."""
    enc = {"n_levels": 2, "n_features": 2, "base_res": 4, "max_res": 8,
           "log2_hashmap_size": 8, "max_table_rows": 10}
    lay = level_layout(enc)
    assert [round(v["scale"], 6) for v in lay] == [3.0, 7.0]
    assert [(v["nb"], v["hashed"], v["rows"]) for v in lay] == [
        (2, False, 8), (3, True, 10)]


def test_param_specs_match_the_program():
    """Names and shapes of the reference equal the measured field's."""
    from nerfbench.core import program
    from nerfbench.tests.tiny import LISTED, tiny_cell

    for name in LISTED:
        cell = tiny_cell(name)
        scene, flags = program.scene_and_flags(cell.config)
        from cednerf_torch.engine.cli import build_field

        field = build_field(scene, flags, device="cpu")
        want = {k: tuple(v.shape) for k, v in field.named_parameters()}
        assert {n: tuple(s) for n, s, _, _ in param_specs(cell.config)} \
            == want


def test_configs_json_roundtrip():
    for c in spec.load_benchmark()["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]


def test_idle_share_takes_the_unprofiled_frame():
    """Busy seconds a profiled frame over the wall seconds a frame of the
    run without the profiler: 0.4 s of 0.8 s is 50%, whatever the
    profiled window's own length."""
    import types

    reader = spec.reader("device_idle_share.serve")
    ctx = types.SimpleNamespace(
        trace=types.SimpleNamespace(busy_s=0.8, window_s=2.0),
        counters={"traced_frames": 2, "frames": 10}, spans={"stretch_s": 8.0})
    assert reader.read(ctx) == pytest.approx(50.0)
    ctx.counters["frames"] = 0
    assert reader.read(ctx) is None


def test_reference_frame_of_an_empty_grid_is_the_background():
    """A chunk of rays that meets no occupied cell composites nothing: the
    frame is the background, with no field call on zero rows."""
    import torch

    from nerfbench.reference.frame import render_frame
    from nerfbench.tests.tiny import VIEW, tiny_cell
    from nerfbench.traffic import views, weights

    cell = tiny_cell(VIEW[0])
    p = cell.workload["params"]
    w0 = weights.make(cell.config, 3, 1.0, "cpu", 5.0)
    res = p["grid"]["grid_resolution"]
    bins = torch.zeros((res, res, res), dtype=torch.bool)
    c2w, t = views.view_set(p["views"])[0]
    f = p["width"] * p["focal_scale"]
    K = torch.tensor([[f, 0.0, p["width"] / 2], [0.0, f, p["width"] / 2],
                      [0.0, 0.0, 1.0]])
    img = render_frame(w0, cell.config, bins, torch.as_tensor(c2w), K, t,
                       p["width"], p["max_samples"],
                       torch.tensor([0.0, 1.0, 0.0]), ray_chunk=100)
    assert img.shape == (p["width"], p["width"], 3)
    assert (img[..., 1] == 255).all() and (img[..., [0, 2]] == 0).all()
