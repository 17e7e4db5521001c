"""Driver `viewer`: the web viewer's frames through
`ViewerServer.render_frame`, in process, one client in a closed loop (the
page waits for each frame before it asks for the next).

Set-up makes the field's weights from the seed (the encoder tables at a
scale that moves a frame) and a carved occupancy grid, hands both to the
program's ViewerServer, and renders `warmup_frames` frames. The window
renders frames of the traffic's view set, in the seed's order, until
--seconds have passed; `frame_ms` is the window's wall time over its
frames and `frame_ms_p90` the 90th percentile of the frames' latencies.
A frame with a value that is not finite counts as failed.

A traced run times an unprofiled stretch of --seconds instead (passes a
frame, rows through the field), then profiles `trace_frames` frames with a
range round K5.

After the window the program's state is freed and `check_frames` frames
of the window, drawn from the seed, are rendered again by the reference.
"""

import collections
import gc
import sys
import time

import numpy as np
import torch

from nerfbench.core import card, checks, program
from nerfbench.core import trace as tracing
from nerfbench.counts import bytes as nbytes
from nerfbench.reference import frame as ref_frame
from nerfbench.traffic import carved_grid, views, weights


def _k5_count(args, kwargs, out):
    x, table, rows = args[0], args[1], args[2]
    return nbytes.encode_fwd(x.shape[0], rows.shape[0],
                             table.shape[1] // nbytes.CORNERS, table.shape[0],
                             table.element_size(), out.element_size())


def _intrinsics(p: dict) -> np.ndarray:
    f = p["width"] * p["focal_scale"]
    return np.array([[f, 0.0, p["width"] / 2.0], [0.0, f, p["width"] / 2.0],
                     [0.0, 0.0, 1.0]], np.float32)


def _setup(cell, seed: int, device: str):
    """(scene, weights, grid bins, ViewerServer) of the cell and seed."""
    from cednerf_torch.ops.occupancy import create_occ_grid
    from cednerf_torch.viewer.server import ViewerServer

    p = cell.workload["params"]
    dev = torch.device(device)
    scene, flags = program.scene_and_flags(cell.config)
    w0 = weights.make(cell.config, seed, p["table_bound"], dev,
                      p["density_bias"])
    bins = carved_grid.shell(p["grid"], scene.aabb, seed, dev)
    occ = create_occ_grid(scene.aabb, scene.grid_resolution, 1,
                          device=device)
    occ = occ._replace(occs=torch.where(bins, 0.5, 0.0).reshape(1, -1),
                       binaries=bins[None])
    server = ViewerServer(program.build_field(scene, flags, w0, device), occ,
                          scene,
                          K=_intrinsics(p), wh=(p["width"], p["width"]))
    return scene, w0, bins, server


def _frame(server, view, p):
    c2w, t = view
    t0 = time.perf_counter()
    img = server.render_frame(c2w, t, p["width"], p["max_samples"], False)
    return img, time.perf_counter() - t0


def _frames(server, vset, order, p, seconds):
    """Frames until `seconds` have passed: (wall s, [(view, frame)],
    latencies, non-finite frames, passes a frame)."""
    t0 = time.perf_counter()
    shown, lat, passes = [], [], []
    bad = 0
    while True:
        i = next(order)
        img, dt = _frame(server, vset[i], p)
        shown.append((i, img))
        lat.append(dt)
        bad += not server.last_frame["finite"]
        passes.append(sum(sum(c) for c in server.last_frame[
            "passes_per_chunk"]))
        if time.perf_counter() - t0 >= seconds:
            return time.perf_counter() - t0, shown, lat, bad, passes


def _reference(cell, w0, bins, vset, shown, seed, precision="bf16"):
    """The reference's frames of `check_frames` distinct views of `shown`,
    drawn from the seed: ([program frame], [reference frame])."""
    p = cell.workload["params"]
    rng = np.random.default_rng(seed)
    first = {}
    for i, img in shown:
        first.setdefault(i, img)
    pick = rng.choice(sorted(first), min(p["check_frames"], len(first)),
                      replace=False)
    dev = bins.device
    K = torch.as_tensor(_intrinsics(p), device=dev)
    bkgd = torch.zeros(3, device=dev)
    refs = [ref_frame.render_frame(
        w0, cell.config, bins, torch.as_tensor(vset[i][0], device=dev), K,
        vset[i][1], p["width"], p["max_samples"], bkgd,
        precision=precision).cpu().numpy() for i in pick]
    return [first[i] for i in pick], refs


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda"):
    p = cell.workload["params"]
    _, w0, bins, server = _setup(cell, seed, device)
    vset = views.view_set(p["views"])
    for i in range(p["warmup_frames"]):
        _frame(server, vset[i % len(vset)], p)
    order = views.order(p["views"], seed)
    card.synchronize(device)
    setup_s = time.perf_counter() - t_start

    out = {"end_to_end": {}, "breakdown": None, "context": None}
    if not trace:
        wall, shown, lat, bad, passes = _frames(server, vset, order, p,
                                                seconds)
        out["end_to_end"] = {
            "frame_ms": wall * 1e3 / len(shown),
            "frame_ms_p90": float(np.percentile(lat, 90)) * 1e3,
            "setup_s": setup_s}
        extra = {}
    else:
        rows = collections.Counter()
        with program.count_rows(server.field, rows):
            wall, shown, lat, bad, passes = _frames(server, vset, order, p,
                                                    seconds)
        entries = {}
        from cednerf_torch.ops import encode_kernels as ek

        with tracing.entry_range(ek, "fused_encode_fwd", "k5", _k5_count,
                                 entries):
            prof = tracing.Profiled(lambda: [
                _frame(server, vset[next(order)], p)
                for _ in range(p["trace_frames"])])
        out["context"] = {
            "config": cell.config, "trace": prof, "entries": entries,
            "spans": {"stretch_s": wall},
            "counters": {"frames": len(shown), "rows": dict(rows),
                         "passes_per_frame": passes,
                         "traced_frames": p["trace_frames"]}}
        out["breakdown"] = {"device_ops": prof.device_ops,
                            "idle_gaps": prof.idle_gaps}
        extra = {"busy_s": prof.busy_s, "window_s": prof.window_s}
    out.update(attempted=len(shown), failed=bad,
               device=card.device(1, card.memory_peak(device), **extra))
    print(f"viewer: setup {setup_s:.3f} s, {len(shown)} frames, passes a "
          f"frame {min(passes)}-{max(passes)}", file=sys.stderr)

    del server
    gc.collect()
    card.empty_cache(device)
    got, want = _reference(cell, w0, bins, vset, shown, seed)
    numbers = checks.frame_numbers(got, want)
    out["checks"] = checks.with_limits(numbers, cell.workload["limits"])
    return out


def readings(cell, seed: int, device: str = "cuda") -> dict:
    """The comparison's numbers of one seed with a short stretch of
    `check_frames` frames, for the control test: "program", the program's
    frames against the reference's; "control", the reference on float8
    MLPs in the program's place against the same reference."""
    p = cell.workload["params"]
    _, w0, bins, server = _setup(cell, seed, device)
    vset = views.view_set(p["views"])
    order = views.order(p["views"], seed)
    shown = [(i, _frame(server, vset[i], p)[0])
             for i in [next(order) for _ in range(p["check_frames"])]]
    del server
    gc.collect()
    card.empty_cache(device)
    got, want = _reference(cell, w0, bins, vset, shown, seed)
    _, low = _reference(cell, w0, bins, vset, shown, seed, "fp8")
    return {"program": checks.frame_numbers(got, want),
            "control": checks.frame_numbers(low, want)}
