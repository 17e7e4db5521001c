"""Measurement helpers shared by chip_smoke.py, profile_serving.py and
profile_training.py: the card's name, CUDA-event timing, the viewer's
default orbit camera, an occupancy grid filled for a field, hash tables
drawn at a scale that the MLPs feel, the train step's flags (3D and 4D
encoder), a profiler table of device time by kernel and a call's device
time from it with the calls the profiler kept, the host syncs a call
makes, the kernel wrappers' launch counts, and two sample sets for the
encoder kernels (ray-major samples of one camera, and points on every
intra-brick cell and cell boundary of each level)."""

import math
import subprocess
import warnings

import numpy as np
import torch

from ..datasets.rays import pinhole_rays
from ..ops import (compact_kernels, encode_kernels, gather_kernels,
                   scatter_kernels)
from ..ops.encode_kernels import cell_geom
from ..ops.occupancy import create_occ_grid, update_occ_grid

# the published D-NeRF train flags -te -ta -f -ae -df -d (ModelFlags kwargs)
TRAIN_FLAGS = dict(use_time_embedding=True, use_time_attenuation=True,
                   use_feat_predict=True, acc_entropy_loss=True,
                   use_div_offsets=True, distortion_loss=True)
# the same with the 4D keyframe encoder (--grid_type hash4d; the field's
# time_keyframes default of 4)
HASH4D_FLAGS = dict(TRAIN_FLAGS, grid_type="hash4d")
_KERNEL_MODULES = (encode_kernels, compact_kernels, scatter_kernels,
                   gather_kernels)


def reset_kernel_counts():
    for mod in _KERNEL_MODULES:
        mod.reset_counts()


def kernel_counts():
    """({kernel: launches}, {kernel: plain-version calls on CUDA}) of every
    kernel wrapper of the port."""
    return ({k: v for m in _KERNEL_MODULES for k, v in m.launches.items()},
            {k: v for m in _KERNEL_MODULES
             for k, v in m.plain_cuda_calls.items()})


def card_name() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`,
    first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls, CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def orbit_c2w(radius=4.0, theta=0.0, phi=0.6) -> np.ndarray:
    """The viewer page's default orbit camera (OpenGL convention), [3, 4]."""
    pos = np.array([radius * math.cos(phi) * math.cos(theta),
                    radius * math.cos(phi) * math.sin(theta),
                    radius * math.sin(phi)])
    z = pos / np.linalg.norm(pos)
    x = np.cross([0.0, 0.0, 1.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z, pos], axis=1).astype(np.float32)


def fill_occupancy(field, cfg, seed: int, device):
    """One all-cells update_occ_grid of the field, a probe time drawn per
    chunk from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def density_fn(x):
        t = torch.rand((1, 1), device=device, generator=gen).expand(
            x.shape[0], 1)
        return field.query_density(x, t)["density"] * cfg.render_step_size

    occ = create_occ_grid(cfg.aabb, cfg.grid_resolution, cfg.grid_nlvl,
                          device=device)
    with torch.inference_mode():
        return update_occ_grid(occ, density_fn, generator=gen,
                               occ_thre=cfg.occ_thre,
                               ema_decay=cfg.occ_ema_decay, all_cells=True)


def _encoder_tables(field) -> dict:
    """{name: table} of the field's encoder (and its motion grid's)."""
    out = {f"hash_encoder.{k}": v
           for k, v in field.hash_encoder.tables().items()}
    if getattr(field, "hash4motion", False):
        out.update({f"motion_grid.{k}": v
                    for k, v in field.motion_grid.tables().items()})
    return out


def load_uniform_tables(fields, seed: int, bound: float):
    """Set the encoder tables (the motion grid's too) of every field in
    `fields` (same spec) to one draw of uniform(-bound, bound) from numpy's
    `seed`.

    The initial +-1e-4 tables leave the encoder's features at ~1e-4, too
    small to move a frame; a large enough bound makes a wrong encoder
    change the frame."""
    rng = np.random.default_rng(seed)
    draws = {name: rng.uniform(-bound, bound, tuple(t.shape)).astype(
        np.float32) for name, t in _encoder_tables(fields[0]).items()}
    with torch.no_grad():
        for f in fields:
            for name, t in _encoder_tables(f).items():
                t.copy_(torch.from_numpy(draws[name]))


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _device_rows(events):
    """The key_averages() rows of device work: CUDA kernels, copies and
    memsets with device time. Operator rows (aten::...) repeat their
    kernels' time and are left out, and so are annotations on the device
    timeline (named "Optimizer.step#Adam.step" and the like), which span
    kernels already counted."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and _dev_us(e) > 0 and "#" not in e.key]


def device_time_by_kernel(prof):
    """(rows, total ms) from a torch.profiler run: one row (name, calls,
    device ms) per CUDA kernel (and copy), largest first."""
    rows = sorted(((e.key, e.count, _dev_us(e) / 1e3)
                   for e in _device_rows(prof.key_averages())),
                  key=lambda r: -r[2])
    return rows, sum(r[2] for r in rows)


def calls_seen(window, warm) -> float:
    """How many calls of a function the profiler kept in a window: the
    device records (kernel, copy and memset calls) among the window's
    key_averages() rows over those of one call of it alone (the warm-up's
    rows). A window of reps calls that kept every record reads reps; one
    where the profiler dropped records reads less."""
    one = sum(e.count for e in _device_rows(warm))
    if one == 0:
        return 0.0
    return sum(e.count for e in _device_rows(window)) / one


# windows device_ms(need_all=True) profiles before it gives up on one that
# kept every call
_DEVICE_MS_TRIES = 3


def device_ms(fn, reps: int, need_all: bool = False):
    """(device ms per call, the rows of device_time_by_kernel, calls seen)
    of `reps` calls of fn under torch.profiler, after one warm-up call
    profiled alone: the sum of the kernels (and copies) the calls ran on
    the card, without the host time between them that CUDA events over
    back-to-back calls also count. `calls seen` is calls_seen of the window
    against the warm-up: below reps, the profiler dropped records and the
    time reads low. need_all: profile the warm-up and the window again, up
    to _DEVICE_MS_TRIES times in all, until the window keeps every call,
    and raise if none did (for a fn that launches the same kernels on every
    call)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(_DEVICE_MS_TRIES if need_all else 1):
        torch.cuda.synchronize()
        with profile(activities=acts) as warm:
            fn()
            torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = calls_seen(prof.key_averages(), warm.key_averages())
        if seen >= reps:
            break
    if need_all and seen < reps:
        raise RuntimeError(f"device_ms: the profiler kept {seen:.3f} of "
                           f"{reps} calls in each of {_DEVICE_MS_TRIES} "
                           "windows")
    rows, total = device_time_by_kernel(prof)
    return total / reps, rows, seen


def sync_calls(fn):
    """(fn's result, the messages of the synchronizing CUDA calls fn made),
    recorded under torch.cuda.set_sync_debug_mode("warn")."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, [str(w.message) for w in seen
                 if "synchroniz" in str(w.message)]


def ray_major_samples(n_rays: int, n_samples: int = 64, seed: int = 0,
                      width: int = 400):
    """Encoder inputs in the order a renderer makes them: `n_rays` rays of
    one width x width pinhole camera on the viewer's orbit (radius 2,
    centred on the unit cube [0, 1]^3, focal 1.1 * width), picked at random
    from the pixels whose ray crosses the cube and kept in pixel order;
    `n_samples` stratified samples per ray between its cube entry and exit.

    Returns (x [n_rays * n_samples, 3] f32, ray-major: ray r's samples are
    rows r * n_samples ..., in ascending t and clipped into the cube;
    t [n_rays, n_samples] f32; origins and unit directions [n_rays, 3])."""
    rng = np.random.default_rng(seed)
    K = np.array([[width * 1.1, 0, width / 2], [0, width * 1.1, width / 2],
                  [0, 0, 1]], np.float32)
    c2w = orbit_c2w(radius=2.0)
    c2w[:, 3] += 0.5
    pix = np.arange(width * width)
    o, d, _ = pinhole_rays((pix % width).astype(np.float32),
                           (pix // width).astype(np.float32), K,
                           np.broadcast_to(c2w, (pix.size, 3, 4)), True)
    with np.errstate(divide="ignore", invalid="ignore"):
        t0, t1 = (0.0 - o) / d, (1.0 - o) / d
    t_in = np.minimum(t0, t1).max(-1)
    t_out = np.maximum(t0, t1).min(-1)
    hit = np.flatnonzero(t_out > np.maximum(t_in, 0.0))
    pick = np.sort(rng.choice(hit, n_rays, replace=n_rays > hit.size))
    u = rng.uniform(size=(n_rays, n_samples))
    span = (t_out - t_in)[pick, None]
    t = (t_in[pick, None] + (np.arange(n_samples) + u) / n_samples * span
         ).astype(np.float32)
    x = o[pick, None] + t[..., None] * d[pick, None]
    x = np.clip(x, 0.0, 1.0).astype(np.float32).reshape(-1, 3)
    return x, t, o[pick], d[pick]


def cell_points(scales, nbs, seed: int = 0, bricks: int = 3,
                boundary: int = 64):
    """f32 points [M, 3] that visit the brick-cell addressing of every
    level: one random point inside each of the 27 intra cells of `bricks`
    random bricks per level, and `boundary` points on cell boundaries (pos =
    x * scale + 0.5 integral; every other one on a brick boundary, a
    multiple of 3), from just outside the grid to just past its far edge,
    each with its f32 neighbours on both sides."""
    rng = np.random.default_rng(seed)
    cells = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"),
                     -1).reshape(1, 27, 3)
    pts = []
    for s, nb in zip(scales, nbs):
        s32 = np.float32(s)
        c = 3 * rng.integers(0, nb, (bricks, 1, 3)) + cells
        frac = rng.uniform(0.05, 0.95, c.shape)
        pts.append(((c + frac - 0.5) / s32).reshape(-1, 3))
        k = rng.integers(-1, 3 * nb + 2, (boundary, 3))
        k[::2] = 3 * rng.integers(0, nb + 1, (len(k[::2]), 3))
        xb = ((k - np.float32(0.5)) / s32).astype(np.float32)
        pts += [xb, np.nextafter(xb, np.float32(2)),
                np.nextafter(xb, np.float32(-2))]
    return np.concatenate(pts).astype(np.float32)
