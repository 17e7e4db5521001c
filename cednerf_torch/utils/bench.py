"""Measurement helpers shared by chip_smoke.py and profile_serving.py: the
card's name, CUDA-event timing, the viewer's default orbit camera, an
occupancy grid filled for a field, and hash tables drawn at a scale that
the MLPs feel."""

import math
import subprocess

import numpy as np
import torch

from ..ops.occupancy import create_occ_grid, update_occ_grid


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


def load_uniform_tables(fields, seed: int, bound: float):
    """Set the hash tables of every field in `fields` (same spec) to one
    draw of uniform(-bound, bound) from numpy's `seed`.

    The initial +-1e-4 tables leave the encoder's features at ~1e-4, too
    small to move a frame; a large enough bound makes a wrong encoder
    change the frame."""
    rng = np.random.default_rng(seed)
    draws = {name: rng.uniform(-bound, bound, tuple(t.shape)).astype(
        np.float32) for name, t in fields[0].hash_encoder.tables().items()}
    with torch.no_grad():
        for f in fields:
            for name, t in f.hash_encoder.tables().items():
                t.copy_(torch.from_numpy(draws[name]))
